"""Inputs made from ``--seed``: weights, frames and batch draws.

Both sides get these and nothing else: the program is handed the raw
weights and the frames, the reference reads the same ones.

Weights are drawn on the card by one ``torch.Generator`` in a few large
calls: He-normal conv weights (one draw for all convs), BN gamma and beta
each uniform in [0.5, 1.5) (one draw), head-conv biases ~ N(0, 0.5). The
BN running statistics are then set to those of a calibration batch (the
first frames of the pool, letterboxed), so every folded layer keeps its
outputs in range at any depth, as a trained network's statistics do.

The positive beta keeps most pre-activations on the near-linear side of
leaky and mish. With beta centred on 0 a random network of YOLOv4's depth
is chaotic: rounding its conv operands to bf16 alone moves the head
outputs by 60-80% of their spread, so no comparison could tell bf16 from
a lower precision; centred on 1 that is 4-6%, as for a trained network.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from h100_bench.reference import detect, model

CALIBRATION_FRAMES = 8
CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")


def cfg_path(config: dict) -> str:
    """The Darknet cfg a configuration file names (``configs/``)."""
    return os.path.join(CONFIGS, config["cfg"])


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def frame_pool(n: int, h: int, w: int, seed: int, device) -> np.ndarray:
    """``n`` distinct (h, w, 3) uint8 frames: smooth random scenes (a
    coarse random field upsampled) with pixel noise, so that they encode
    like camera frames. Returns host memory."""
    g = generator(seed + 1, device)
    coarse = torch.rand((n, 3, max(1, h // 32), max(1, w // 32)),
                        generator=g, device=device) * 255.0
    x = F.interpolate(coarse, size=(h, w), mode="bilinear",
                      align_corners=False)
    x = x + torch.randn(x.shape, generator=g, device=device) * 12.0
    x = x.clamp(0, 255).round().to(torch.uint8).permute(0, 2, 3, 1)
    return x.contiguous().cpu().numpy()


def raw_params(net: Dict[str, str], layers: List[dict], seed: int,
               device, frames: np.ndarray
               ) -> Dict[str, Dict[str, torch.Tensor]]:
    """The raw weights (OIHW conv weights, BN gamma / beta / mean / var
    or a bias) under ``conv{i}``, fp32 on ``device``."""
    g = generator(seed, device)
    convs = [(i, l) for i, l in enumerate(layers) if l["type"] == "conv"]
    sizes = [l["filters"] * l["in_c"] * l["size"] ** 2 for _, l in convs]
    flat = torch.randn(sum(sizes), generator=g, device=device)
    n_bn = sum(l["filters"] for _, l in convs if l["bn"])
    n_bias = sum(l["filters"] for _, l in convs if not l["bn"])
    bn = torch.rand((2, n_bn), generator=g, device=device)
    bias = torch.randn(n_bias, generator=g, device=device) * 0.5
    params: Dict[str, Dict[str, torch.Tensor]] = {}
    off = bn_off = bias_off = 0
    for (i, l), n in zip(convs, sizes):
        fan_in = l["in_c"] * l["size"] ** 2
        w = flat[off:off + n].view(l["filters"], l["in_c"], l["size"],
                                   l["size"]) * math.sqrt(2.0 / fan_in)
        off += n
        f = l["filters"]
        if l["bn"]:
            params[f"conv{i}"] = {
                "w": w, "gamma": bn[0, bn_off:bn_off + f] + 0.5,
                "beta": bn[1, bn_off:bn_off + f] + 0.5,
                "mean": torch.zeros(f, device=device),
                "var": torch.ones(f, device=device)}
            bn_off += f
        else:
            params[f"conv{i}"] = {"w": w,
                                  "bias": bias[bias_off:bias_off + f]}
            bias_off += f
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    model.strict_fp32()
    x = detect.letterbox(torch.as_tensor(frames[:CALIBRATION_FRAMES],
                                         device=device),
                         int(net["height"]), int(net["width"]))
    model.calibrate_bn(params, layers, x)
    # the program runs under PyTorch's own defaults
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = flags
    return params


def batch_draws(seed: int, pool: int, batch: int):
    """An endless stream of frame-index draws, ``batch`` distinct frames
    of the pool each, from ``seed``."""
    rng = np.random.default_rng(seed)
    while True:
        yield rng.choice(pool, size=batch, replace=False)
