"""Gradual magnitude pruning (GMP), port of
``modelcompression_tpu/compress/gmp.py``: sparsify during training (Zhu &
Gupta 2017, "To prune, or not to prune").

Sparsity ramps from ``initial`` to ``final`` along a cubic schedule, and
the keep-masks are recomputed from the live weight magnitudes every
``frequency`` steps, inside the train step (``train/train_step.py``):

* The recompute is ``ops/cuda_topk.prune_flat(..., return_mask=True)`` on
  the flat HWIO layout of ``cuda_topk._prune_layout`` (one segment per
  conv, or one for all with ``per_layer=False``, plus the padding
  segment, which prunes nothing): on CUDA the radix-select, tie-count and
  apply kernels, on the CPU their plain versions. Ties go lowest index
  first, as the JAX package's ``segmented_rank_mask`` breaks them.
* The schedule gate and the zero counts are host values: the port's step
  counter is a host int, so an off-schedule step launches nothing and no
  device value is read.
* Masked weights get exactly-zero gradients (the loss multiplies by the
  mask) and are re-zeroed after the optimizer update (their momentum
  would move them).

The zero count is ``floor(f32(s) * f32(n))``, in float32 as the JAX
package computes it on its device, where the post-hoc prune paths take
``int(sparsity * n)`` in Python floats: the two agree for dyadic
sparsities (0.5, 0.75, ...) and may differ by one weight per layer
otherwise.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Dict, List, Sequence

import numpy as np
import torch

from modelcompression_tpu_torch.models.cfg import NetworkSpec
from modelcompression_tpu_torch.models.darknet import Params
from modelcompression_tpu_torch.ops.cuda_topk import (
    _layout, _seg_ids_for, _unflatten, prune_flat,
)
from modelcompression_tpu_torch.ops.topk_mask import _prunable_keys


@dataclasses.dataclass(frozen=True)
class GMPSpec:
    """Schedule for gradual magnitude pruning inside the train step.

    Sparsity at step t (cubic ramp, Zhu & Gupta 2017 eq. 1):

        s(t) = final + (initial - final) * (1 - clip((t-begin)/(end-begin),
                                                     0, 1))**3

    Masks are recomputed at every step t with begin <= t <= end and
    (t - begin) % frequency == 0, and at t == end (so the run always
    finishes at ``final``). ``skip`` lists conv layer indices exempt from
    pruning.
    """

    final_sparsity: float
    initial_sparsity: float = 0.0
    begin: int = 0
    end: int = 1
    frequency: int = 100
    per_layer: bool = True
    skip: Sequence[int] = ()

    def __post_init__(self):
        if not 0.0 <= self.initial_sparsity < 1.0:
            raise ValueError(
                f"initial_sparsity must be in [0, 1), got "
                f"{self.initial_sparsity}")
        if not self.initial_sparsity <= self.final_sparsity < 1.0:
            raise ValueError(
                f"final_sparsity must be in [initial_sparsity, 1), got "
                f"{self.final_sparsity}")
        if self.end <= self.begin:
            raise ValueError(
                f"end ({self.end}) must be > begin ({self.begin})")
        if self.frequency < 1:
            raise ValueError(f"frequency must be >= 1, got {self.frequency}")


def _fma_f32(a: np.float32, b: np.float32, c: np.float32) -> np.float32:
    """a * b + c rounded once to float32 (to nearest, ties to even), as a
    fused multiply-add rounds it."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    near = np.float32(float(exact))
    cands = (np.nextafter(near, np.float32(-np.inf)), near,
             np.nextafter(near, np.float32(np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                     int(v.view(np.uint32)) & 1))


def gmp_sparsity(step: int, spec: GMPSpec) -> np.float32:
    """s(t) on the cubic ramp, the float32 that the JAX package's jitted
    ``gmp_sparsity`` gives: frac and u = 1 - frac in float32, the cube as
    (u * u) * u, ``initial - final`` a Python double rounded to float32,
    and the last multiply-add fused (one rounding), as XLA compiles it."""
    f32 = np.float32
    frac = np.clip((f32(step) - f32(spec.begin))
                   / f32(spec.end - spec.begin), f32(0.0), f32(1.0))
    u = f32(1.0) - frac
    return _fma_f32(f32(spec.initial_sparsity - spec.final_sparsity),
                    u * u * u, f32(spec.final_sparsity))


def gmp_zero_counts(sizes: Sequence[int], sparsity,
                    per_layer: bool = True) -> List[int]:
    """``floor(f32(s) * f32(n))`` for each segment's size n (every size
    with ``per_layer``, else their sum)."""
    s = np.float32(sparsity)
    counts = list(sizes) if per_layer else [sum(sizes)]
    return [int(np.floor(s * np.float32(n))) for n in counts]


def gmp_masks(params: Params, net: NetworkSpec, sparsity,
              per_layer: bool = True,
              skip: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    """Bool OIHW keep-masks at ``sparsity`` (float32 zero counts, see the
    module docstring) through ``prune_flat``: already-zero weights rank
    smallest, ties lowest HWIO index first."""
    keys = _prunable_keys(net, skip)
    with torch.no_grad():
        cat, sizes, _, padded = _layout(
            {k: {"w": params[k]["w"].detach()} for k in keys}, keys)
        n_real = len(keys) if per_layer else 1
        seg_ids = _seg_ids_for(sizes, padded, per_layer, n_real,
                               cat.device)
        n_zero = torch.tensor(
            gmp_zero_counts(sizes, sparsity, per_layer) + [0],
            dtype=torch.int64, device=cat.device)
        mask_flat = prune_flat(cat, seg_ids, n_zero, n_real + 1,
                               return_mask=True) != 0
    return _unflatten(params, keys, sizes, mask_flat)


def gmp_init_masks(params: Params, net: NetworkSpec,
                   spec: GMPSpec) -> Dict[str, torch.Tensor]:
    """All-keep bool masks for every GMP-managed conv, on the params'
    device: the train state's seed."""
    return {k: torch.ones(params[k]["w"].shape, dtype=torch.bool,
                          device=params[k]["w"].device)
            for k in _prunable_keys(net, spec.skip)}


def gmp_due(spec: GMPSpec, step: int) -> bool:
    """Whether the schedule recomputes the masks at ``step``."""
    step = int(step)
    return (spec.begin <= step <= spec.end
            and ((step - spec.begin) % spec.frequency == 0
                 or step == spec.end))


def gmp_mask_update(spec: GMPSpec, net: NetworkSpec, trainable: Params,
                    masks: Dict[str, torch.Tensor],
                    step: int, shards=None) -> Dict[str, torch.Tensor]:
    """One scheduled mask update: on a due step, the masks recomputed from
    the live weights and intersected with the old ones; else the old
    masks. Non-GMP masks in ``masks`` pass through.

    Tensor parallel, ``masks`` and ``trainable`` hold this rank's filter
    slices and ``shards()`` (called on a due step only) returns (the full
    weights, ``local(key, full mask)`` -> this rank's slice): the masks
    are recomputed on the full weights, as one device computes them, and
    each rank keeps its slice.

    The intersection makes the update monotone: a once-pruned weight
    never re-enters. The recompute sees the weights after the optimizer
    update and before the masks are applied again, where momentum has
    moved pruned weights off zero (their gradient is zero, their momentum
    buffer is not), and a surviving weight may reach exactly 0; either
    can put a pruned weight above a survivor's rank. So the intersection
    can leave more zeros than ``floor(s(t) * n)``: with momentum 0.9,
    about nine in a million on YOLOv2, as in the JAX package (whose docstring
    names only the exact-zero ties)."""
    keys = _prunable_keys(net, spec.skip)
    missing = [k for k in keys if k not in masks]
    if missing:
        raise ValueError(
            f"GMP needs masks for {missing} in the train state — create it "
            f"with weight_masks=gmp_init_masks(...)")
    out = dict(masks)
    if gmp_due(spec, step):
        local = None
        if shards is not None:
            trainable, local = shards()
        fresh = gmp_masks(trainable, net, gmp_sparsity(step, spec),
                          per_layer=spec.per_layer, skip=spec.skip)
        for k in keys:
            out[k] = (fresh[k] if local is None else local(k, fresh[k])) \
                & masks[k]
    return out
