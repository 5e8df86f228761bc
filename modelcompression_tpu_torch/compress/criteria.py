"""Pruning criteria (port of ``modelcompression_tpu/compress/
criteria.py``): per-layer and global magnitude masks, and L1 filter
ranking with ``criterion='l1'``, ``tied='protect'``.

Masks and keep-sets are rank-based: the floor(fraction*n) lowest entries
are pruned, ties broken by index (lowest pruned first), so results are
exact and deterministic. The magnitude masks here are the stable-argsort
definition of the rule, the reference that ``ops/cuda_topk.py`` is held
against. Kernels here are OIHW, so a filter is ``w[o]``; magnitude ranks
run over the JAX package's HWIO flat order (``ops/topk_mask.hwio_flat``),
which is what decides ties.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from modelcompression_tpu_torch.compress.graph import (
    csp_split_constraints, grouped_route_protected_convs,
    head_producer_convs, protected_conv_indices, tied_conv_groups,
)
from modelcompression_tpu_torch.models.cfg import ConvLayer, NetworkSpec
from modelcompression_tpu_torch.models.darknet import Params, conv_key
from modelcompression_tpu_torch.ops.topk_mask import (
    _prunable_keys, hwio_flat, oihw_from_flat,
)


def _rank_mask_flat(flat_abs: torch.Tensor, n_zero: int) -> torch.Tensor:
    """Bool keep-mask over a flat |w| vector: False for the ``n_zero``
    smallest entries, ties broken by index."""
    order = torch.argsort(flat_abs, stable=True)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(order.numel(), device=order.device)
    return ranks >= n_zero


def magnitude_mask_layer(w: torch.Tensor, sparsity: float) -> torch.Tensor:
    """Per-layer unstructured magnitude mask of an OIHW kernel: exactly
    floor(sparsity*n) False entries marking the smallest |w|."""
    n_zero = int(sparsity * w.numel())
    return oihw_from_flat(_rank_mask_flat(hwio_flat(w.abs()), n_zero),
                          w.shape)


def magnitude_masks_perlayer(params: Params, spec: NetworkSpec,
                             sparsity: float, skip: Sequence[int] = ()
                             ) -> Dict[str, torch.Tensor]:
    """Masks for every conv layer not in ``skip``."""
    return {k: magnitude_mask_layer(params[k]["w"], sparsity)
            for k in _prunable_keys(spec, skip)}


def magnitude_masks_global(params: Params, spec: NetworkSpec,
                           sparsity: float, skip: Sequence[int] = ()
                           ) -> Dict[str, torch.Tensor]:
    """One rank cut across the concatenation of all conv weights."""
    keys = _prunable_keys(spec, skip)
    flats = [hwio_flat(params[k]["w"].abs()) for k in keys]
    sizes = [f.numel() for f in flats]
    cat = torch.cat(flats)
    mask_flat = _rank_mask_flat(cat, int(sparsity * cat.numel()))
    return {k: oihw_from_flat(m, params[k]["w"].shape)
            for k, m in zip(keys, torch.split(mask_flat, sizes))}


def global_threshold(params: Params, spec: NetworkSpec, sparsity: float,
                     skip: Sequence[int] = ()) -> torch.Tensor:
    """The |w| value at the global sparsity cut (a 0-d tensor)."""
    cat = torch.cat([params[k]["w"].abs().reshape(-1)
                     for k in _prunable_keys(spec, skip)])
    k_idx = min(int(sparsity * cat.numel()), cat.numel() - 1)
    return torch.sort(cat).values[k_idx]


def mask_sparsity(masks: Dict[str, torch.Tensor]) -> float:
    """Achieved sparsity: the fraction of zeros across all masks."""
    total = sum(m.numel() for m in masks.values())
    zeros = sum(int((~m).sum()) for m in masks.values())
    return zeros / total


def apply_masks(params: Params, masks: Dict[str, torch.Tensor]) -> Params:
    """w <- w * mask for every masked layer; other entries untouched."""
    out = {}
    for k, p in params.items():
        out[k] = dict(p, w=p["w"] * masks[k].to(p["w"].dtype)) \
            if k in masks else p
    return out


def _check_criterion(criterion: str) -> None:
    if criterion != "l1":
        raise NotImplementedError(
            f"filter criterion {criterion!r} is not ported yet — only 'l1' "
            "(ROADMAP Queue 1 item 5: bn_gamma, fpgm)")


def l1_filter_scores(w_oihw: torch.Tensor) -> torch.Tensor:
    """Li et al. 2017 filter score: sum |W[j]| per output filter j, in
    fp32. Returns (O,)."""
    return w_oihw.float().abs().sum(dim=(1, 2, 3))


def l1_filter_scores_device(params: Params, spec: NetworkSpec,
                            skip: Sequence[int] = ()
                            ) -> Dict[int, np.ndarray]:
    """Filter scores of every prunable conv (head producers, shortcut-tied
    and grouped-route convs, and ``skip`` are protected), as numpy."""
    protected = set(skip) | protected_conv_indices(spec)
    return {i: l1_filter_scores(params[conv_key(i)]["w"]).cpu().numpy()
            for i in spec.conv_indices() if i not in protected}


def _keep_from_scores(scores: np.ndarray, fraction: float) -> np.ndarray:
    """Drop the floor(fraction*O) lowest-score filters; ties: lower index
    pruned first. Returns sorted kept indices."""
    n_drop = int(fraction * scores.shape[0])
    order = np.argsort(scores, kind="stable")  # ascending
    return np.sort(order[n_drop:]).astype(np.int32)


def keep_sets_from_scores(scores: Dict[int, np.ndarray],
                          fraction: float = None,
                          fractions: Dict[int, float] = None,
                          default: float = 0.0) -> Dict[int, np.ndarray]:
    """Rank-select keep-sets from a per-filter score map: uniform
    ``fraction``, or a per-layer ``fractions`` schedule with ``default``
    for unlisted layers."""
    if fractions is not None:
        unknown = set(fractions) - set(scores)
        if unknown:
            raise ValueError(
                f"fractions given for non-scored conv indices "
                f"{sorted(unknown)}")
        return {i: _keep_from_scores(np.asarray(s), fractions.get(i, default))
                for i, s in scores.items()}
    if fraction is None:
        raise ValueError("need fraction or fractions")
    return {i: _keep_from_scores(np.asarray(s), fraction)
            for i, s in scores.items()}


def l1_filter_keep_sets(params: Params, spec: NetworkSpec, fraction: float,
                        skip: Sequence[int] = (),
                        criterion: str = "l1") -> Dict[int, np.ndarray]:
    """Keep-sets for all prunable convs at one drop fraction."""
    _check_criterion(criterion)
    scores = l1_filter_scores_device(params, spec, skip=skip)
    return {i: _keep_from_scores(s, fraction) for i, s in scores.items()}


def l1_filter_keep_sets_scheduled(params: Params, spec: NetworkSpec,
                                  fractions: Dict[int, float],
                                  default: float = 0.0,
                                  skip: Sequence[int] = (),
                                  criterion: str = "l1"
                                  ) -> Dict[int, np.ndarray]:
    """Per-layer drop fractions (Li et al. 2017 §4): ``fractions`` maps a
    conv layer index to its drop fraction; unlisted prunable convs use
    ``default``. Balance-constrainable CSP grouped-route source convs take
    their fraction per split block (``csp_balanced_keep_from_scores``)."""
    _check_criterion(criterion)
    for i in fractions:
        # a bad index is a ValueError like every other malformed schedule
        # (a negative one would alias from the end)
        if not 0 <= i < len(spec.layers):
            raise ValueError(
                f"conv index {i} out of range [0, {len(spec.layers) - 1}]")
        if not isinstance(spec.layers[i], ConvLayer):
            raise ValueError(f"layer {i} is not a conv layer")
    scores = l1_filter_scores_device(params, spec, skip=skip)
    csp = csp_constrainable_indices(spec, skip)
    unknown = set(fractions) - set(scores) - set(csp)
    if unknown:
        raise ValueError(
            f"fractions given for non-prunable conv indices {sorted(unknown)}"
            " (head-producing, shortcut-tied, skipped and multi-provenance "
            "grouped-route convs are protected — compress/graph.py)")
    out = {i: _keep_from_scores(s, fractions.get(i, default))
           for i, s in scores.items()}
    out.update({i: csp_balanced_keep_from_scores(
                    _csp_scores(params, i), parts, fractions.get(i, default))
                for i, parts in csp.items()})
    return out


def csp_constrainable_indices(spec: NetworkSpec,
                              skip: Sequence[int] = ()) -> Dict[int, int]:
    """``{conv_idx: n_parts}`` for the CSP grouped-route source convs that
    can be split-balance-pruned under the default protections."""
    constraints = csp_split_constraints(spec)
    protected = (head_producer_convs(spec)
                 | grouped_route_protected_convs(spec) | set(skip))
    for g in tied_conv_groups(spec):
        protected |= g
    return {i: p for i, p in constraints.items() if i not in protected}


def csp_balanced_keep_from_scores(scores: np.ndarray, parts: int,
                                  fraction: float) -> np.ndarray:
    """Split-BALANCED keep-set: rank within each of ``parts`` contiguous
    blocks and drop ``fraction`` per block."""
    block = len(scores) // parts
    if block * parts != len(scores):
        raise ValueError(f"{len(scores)} filters not divisible by {parts} "
                         "split blocks")
    keeps = [_keep_from_scores(scores[p * block:(p + 1) * block], fraction)
             + p * block for p in range(parts)]
    return np.concatenate(keeps).astype(np.int32)


def csp_balanced_keep_sets(params: Params, spec: NetworkSpec,
                           fraction: float, skip: Sequence[int] = (),
                           criterion: str = "l1") -> Dict[int, np.ndarray]:
    """Split-balanced keep-sets of the CSP grouped-route source convs
    (empty for graphs without grouped routes, e.g. YOLOv2)."""
    _check_criterion(criterion)
    constraints = csp_constrainable_indices(spec, skip)
    return {i: csp_balanced_keep_from_scores(_csp_scores(params, i), parts,
                                             fraction)
            for i, parts in constraints.items()}


def _csp_scores(params: Params, i: int) -> np.ndarray:
    """L1 scores of a CSP source conv, float64 as the JAX package ranks
    them."""
    return l1_filter_scores(params[conv_key(i)]["w"]).cpu().numpy() \
        .astype(np.float64)
