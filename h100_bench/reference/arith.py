"""Frozen arithmetic of the yardstick: conv FLOPs per image, the input
stage's roofline bound, and the H100's published peaks.

The FLOP count is ``modelcompression_tpu_torch/compress/flops.py``'s
``conv_flops_by_layer`` (2 x MACs of every conv, same spatial walk),
restated on the reference cfg reader so that later changes to the program
cannot move the numerator of an ``mfu``. The input-stage bound counts
bytes once over the HBM bandwidth and operations over the bf16 tensor
rate, whichever is larger.
"""

from __future__ import annotations

from typing import Dict, List

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def conv_flops_by_layer(layers: List[dict]) -> Dict[int, int]:
    """Per-conv 2 x MACs for one image (the layers' walked shapes)."""
    out = {}
    for i, l in enumerate(layers):
        if l["type"] == "conv":
            out[i] = (2 * l["out_h"] * l["out_w"] * l["size"] * l["size"]
                      * l["in_c"] * l["filters"])
    return out


def conv_flops(layers: List[dict]) -> int:
    return sum(conv_flops_by_layer(layers).values())


def input_stage_bound_s(batch: int, net_h: int, net_w: int,
                        filters: int, in_bytes: int = 2,
                        out_bytes: int = 2) -> float:
    """Least time of the fused conv1 (3x3, stride 1, pad 1, 3 channels in)
    + bias + leaky + 2x2 max pool over one batch: the bf16 canvas read
    once, the weights and bias read once, the pooled map written once;
    the conv's 2 x MACs at the bf16 peak."""
    n_bytes = (batch * net_h * net_w * 3 * in_bytes
               + filters * 27 * in_bytes + filters * 4
               + batch * (net_h // 2) * (net_w // 2) * filters * out_bytes)
    n_ops = 2 * batch * net_h * net_w * 27 * filters
    return max(n_bytes / PEAK_HBM_BYTES_PER_S, n_ops / PEAK_BF16_FLOPS)
