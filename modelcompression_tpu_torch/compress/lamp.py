"""LAMP, Layer-Adaptive Magnitude-based Pruning (Lee et al., ICLR 2021),
port of ``modelcompression_tpu/compress/lamp.py``.

Each weight is ranked by its magnitude relative to the surviving mass of
its own layer,

    score(u) = w_u^2 / sum_{v in layer(u), |w_v| >= |w_u|} w_v^2

(the denominator includes u itself, so each layer's largest weight scores
exactly 1.0), and one global rank cut over the scores yields layer-adaptive
sparsities.

* The scores need each layer's weights in ascending order: a stable
  ``torch.sort`` of w² (the kernel flattened in the JAX package's HWIO
  order, ``ops/topk_mask.hwio_flat``), a flipped float32 cumsum for the
  suffix sums, and a scatter back. These are library calls, as the JAX
  package's XLA argsort is.
* The global cut zeroes the ``int(sparsity * n_total)`` smallest scores,
  ties lowest index first: the top-k kernels' rule at one segment. It runs
  through ``ops/cuda_topk.prune_flat`` on the scores (S = 2 with the
  padding segment): the radix-select, tie-count and apply kernels on
  CUDA, their plain versions on the CPU. ``lamp_cut_plain`` is the
  stable-argsort rank that defines it.
* The layers are concatenated in ``sorted`` key order, as in the JAX
  package: lexicographic, so ``conv10`` comes before ``conv2``, and ties
  across layers follow that order.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from modelcompression_tpu_torch.models.cfg import NetworkSpec
from modelcompression_tpu_torch.models.darknet import Params
from modelcompression_tpu_torch.ops.cuda_topk import (
    CHUNK, _seg_ids_for, _unflatten, prune_flat,
)
from modelcompression_tpu_torch.ops.topk_mask import (
    _prunable_keys, hwio_flat, oihw_from_flat,
)


def lamp_scores_flat(w: torch.Tensor) -> torch.Tensor:
    """LAMP scores of one OIHW kernel, flat in HWIO order: w² over the
    inclusive suffix sum of w² in ascending order (ties: the later index
    counts in the earlier one's denominator), float32 in (0, 1]."""
    flat = hwio_flat(w.detach()).float().square()
    srt, order = torch.sort(flat, stable=True)
    suffix = torch.flip(torch.cumsum(torch.flip(srt, (0,)), 0), (0,))
    score_sorted = srt / torch.clamp_min(suffix, 1e-30)
    return torch.zeros_like(flat).scatter_(0, order, score_sorted)


def _keys(spec: NetworkSpec, skip: Sequence[int]) -> List[str]:
    return sorted(_prunable_keys(spec, skip))


def lamp_scores_device(params: Params, spec: NetworkSpec,
                       skip: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    """Per-weight LAMP scores of every prunable conv, OIHW, on the params'
    device."""
    with torch.no_grad():
        return {k: oihw_from_flat(lamp_scores_flat(params[k]["w"]),
                                  params[k]["w"].shape)
                for k in _keys(spec, skip)}


def lamp_cut_plain(scores: torch.Tensor, n_zero: int) -> torch.Tensor:
    """The global cut's definition: keep where the stable ascending
    argsort rank of ``scores`` is ``>= n_zero``."""
    order = torch.argsort(scores, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(order.numel(), device=scores.device)
    return ranks >= n_zero


def _scores_layout(params: Params, keys: List[str]):
    """The sorted-key concatenation of the layers' flat scores, padded to
    a multiple of ``CHUNK`` with zeros as ``cuda_topk`` lays weights out;
    returns ``(cat, sizes)``."""
    if not keys:
        raise ValueError("nothing to prune: every conv layer is skipped")
    flats = [lamp_scores_flat(params[k]["w"]) for k in keys]
    sizes = [int(f.numel()) for f in flats]
    total = sum(sizes)
    pad = -(-total // CHUNK) * CHUNK - total
    return torch.cat(flats + [flats[0].new_zeros(pad)]), sizes


def lamp_masks(params: Params, spec: NetworkSpec, sparsity: float,
               skip: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    """Bool OIHW keep-masks at a global ``sparsity`` with LAMP's
    layer-adaptive allocation: exactly ``int(sparsity * n_total)`` False
    entries across the prunable convs (a drop-in for
    ``magnitude_masks_global``)."""
    keys = _keys(spec, skip)
    with torch.no_grad():
        cat, sizes = _scores_layout(params, keys)
        total = sum(sizes)
        seg_ids = _seg_ids_for(sizes, cat.numel(), False, 1, cat.device)
        n_zero = torch.tensor([int(sparsity * total), 0],
                              dtype=torch.int64, device=cat.device)
        mask_flat = prune_flat(cat, seg_ids, n_zero, 2,
                               return_mask=True) != 0
    return _unflatten(params, keys, sizes, mask_flat)


def lamp_layer_sparsities(masks: Dict[str, torch.Tensor]
                          ) -> Dict[str, float]:
    """Achieved per-layer sparsity of a mask set (LAMP's allocation)."""
    return {k: float((~m).float().mean()) for k, m in masks.items()}
