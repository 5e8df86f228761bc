"""Pruning criteria (port of ``modelcompression_tpu/compress/
criteria.py``): per-layer and global magnitude masks, and structured filter
scores and keep-sets under the criteria ``l1`` (Li et al. 2017),
``bn_gamma`` (Liu et al. 2017 network slimming) and ``fpgm`` (He et al.
2019 geometric median), with split-balanced CSP keep-sets and shortcut-tied
group keep-sets.

Masks and keep-sets are rank-based: the floor(fraction*n) lowest entries
are pruned, ties broken by index (lowest pruned first), so results are
exact and deterministic. The magnitude masks here are the stable-argsort
definition of the rule, the reference that ``ops/cuda_topk.py`` is held
against. Kernels here are OIHW, so a filter is ``w[o]``; magnitude ranks
run over the JAX package's HWIO flat order (``ops/topk_mask.hwio_flat``),
which is what decides ties. Filter scores are computed on the params'
device and read back once per call.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from modelcompression_tpu_torch.compress.graph import (
    csp_split_constraints, grouped_route_protected_convs,
    grouped_route_source_convs, head_producer_convs, protected_conv_indices,
    tied_conv_groups,
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


FILTER_CRITERIA = ("l1", "bn_gamma", "fpgm")


def l1_filter_scores(w_oihw: torch.Tensor) -> torch.Tensor:
    """Li et al. 2017 filter score: sum |W[j]| per output filter j, in
    fp32. Returns (O,)."""
    return w_oihw.float().abs().sum(dim=(1, 2, 3))


def _to_host(scores: Dict[int, torch.Tensor]) -> Dict[int, np.ndarray]:
    """One copy to the host for a whole score map."""
    if not scores:
        return {}
    keys = list(scores)
    flat = torch.cat([scores[i].detach().reshape(-1) for i in keys]).cpu() \
        .numpy()
    sizes = np.cumsum([0] + [scores[i].numel() for i in keys])
    return {i: flat[sizes[n]:sizes[n + 1]] for n, i in enumerate(keys)}


def _scored_convs(spec: NetworkSpec, skip: Sequence[int]):
    protected = set(skip) | protected_conv_indices(spec)
    return [i for i in spec.conv_indices() if i not in protected]


def l1_filter_scores_device(params: Params, spec: NetworkSpec,
                            skip: Sequence[int] = ()
                            ) -> Dict[int, np.ndarray]:
    """Filter scores of every prunable conv (head producers, shortcut-tied
    and grouped-route convs, and ``skip`` are protected), as numpy."""
    return _to_host({i: l1_filter_scores(params[conv_key(i)]["w"])
                     for i in _scored_convs(spec, skip)})


def bn_gamma_scores_device(params: Params, spec: NetworkSpec,
                           skip: Sequence[int] = ()
                           ) -> Dict[int, np.ndarray]:
    """Network-slimming filter scores (Liu et al. 2017): |gamma| of each
    conv's BN scale, the importance ``TrainConfig.bn_l1`` trains toward
    zero. Convs without BN fall back to their L1 filter score divided by
    its largest value, so mixed cfgs still get a full keep-set map.
    Protection as ``l1_filter_scores_device``."""
    out = {}
    for i in _scored_convs(spec, skip):
        p = params[conv_key(i)]
        if spec.layers[i].batch_normalize:
            out[i] = p["gamma"].float().abs()
        else:
            l1 = l1_filter_scores(p["w"])
            out[i] = l1 / torch.clamp_min(l1.max(), 1e-12)
    return _to_host(out)


def fpgm_filter_scores(w_oihw: torch.Tensor) -> torch.Tensor:
    """FPGM filter score (He et al. 2019, 'Filter Pruning via Geometric
    Median'): score_j = sum_i ||F_j - F_i||_2, the summed Euclidean
    distance from filter j to every other filter of the layer. Filters
    with the smallest sum sit nearest the geometric median and are pruned
    first. Returns (O,) fp32.

    The distances come from one Gram product, ||a||^2 + ||b||^2 - 2ab,
    which cancels for near-identical filters (exactly what FPGM ranks): the
    product runs in fp32 with TF32 off for this call, whatever the process
    settings (the JAX package runs it at Precision.HIGHEST). A filter's
    distance to itself is set to 0: the Gram form leaves the square root of
    its rounding there, up to ~sqrt(D * 2^-23) * ||F_j||, which the JAX
    package keeps in its sums."""
    x = w_oihw.float().reshape(w_oihw.shape[0], -1)  # (O, D)
    sq = torch.sum(x * x, dim=1)
    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gram = torch.matmul(x, x.T)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    d2 = sq[:, None] + sq[None, :] - 2.0 * gram
    d2.fill_diagonal_(0.0)
    return torch.sum(torch.sqrt(torch.clamp_min(d2, 0.0)), dim=1)


def fpgm_scores_device(params: Params, spec: NetworkSpec,
                       skip: Sequence[int] = ()
                       ) -> Dict[int, np.ndarray]:
    """All prunable convs' FPGM distance-sum scores, read back once.
    Protection as ``l1_filter_scores_device``."""
    return _to_host({i: fpgm_filter_scores(params[conv_key(i)]["w"])
                     for i in _scored_convs(spec, skip)})


def filter_scores_device(params: Params, spec: NetworkSpec,
                         criterion: str = "l1",
                         skip: Sequence[int] = ()
                         ) -> Dict[int, np.ndarray]:
    """Structured filter scores under ``criterion``: ``l1``, ``bn_gamma``
    or ``fpgm``."""
    if criterion == "l1":
        return l1_filter_scores_device(params, spec, skip=skip)
    if criterion == "bn_gamma":
        return bn_gamma_scores_device(params, spec, skip=skip)
    if criterion == "fpgm":
        return fpgm_scores_device(params, spec, skip=skip)
    raise ValueError(
        f"unknown filter criterion {criterion!r} (one of {FILTER_CRITERIA})")


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


def l1_filter_keep(w_oihw: torch.Tensor, fraction: float) -> np.ndarray:
    """Keep-set of one conv: drop the floor(fraction*O) lowest-L1
    filters."""
    return _keep_from_scores(l1_filter_scores(w_oihw).cpu().numpy(),
                             fraction)


def l1_filter_keep_sets(params: Params, spec: NetworkSpec, fraction: float,
                        skip: Sequence[int] = (),
                        criterion: str = "l1") -> Dict[int, np.ndarray]:
    """Keep-sets for all prunable convs at one drop fraction, ranked by
    ``criterion`` (``l1`` | ``bn_gamma`` | ``fpgm``)."""
    scores = filter_scores_device(params, spec, criterion=criterion,
                                  skip=skip)
    return {i: _keep_from_scores(s, fraction) for i, s in scores.items()}


def _criterion_scores(params: Params, spec: NetworkSpec, idxs,
                      criterion: str) -> Dict[int, np.ndarray]:
    """Float64 per-filter scores for an explicit conv-index list (no
    protection filtering) under a data-free criterion: the scoring pass
    behind the tied-group and CSP keep-sets, read back once. ``bn_gamma``
    takes |gamma| where BN exists, else the L1 score over its largest."""
    if criterion not in FILTER_CRITERIA:
        raise ValueError(
            f"unknown filter criterion {criterion!r} "
            f"(one of {FILTER_CRITERIA})")
    score = fpgm_filter_scores if criterion == "fpgm" else l1_filter_scores
    out = {i: s.astype(np.float64) for i, s in _to_host(
        {i: score(params[conv_key(i)]["w"]) for i in idxs}).items()}
    if criterion == "bn_gamma":
        for i in out:
            if spec.layers[i].batch_normalize:
                out[i] = np.abs(params[conv_key(i)]["gamma"].detach().cpu()
                                .numpy().astype(np.float64))
            else:
                out[i] = out[i] / max(float(out[i].max()), 1e-12)
    return out


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
    for i in fractions:
        # a bad index is a ValueError like every other malformed schedule
        # (a negative one would alias from the end)
        if not 0 <= i < len(spec.layers):
            raise ValueError(
                f"conv index {i} out of range [0, {len(spec.layers) - 1}]")
        if not isinstance(spec.layers[i], ConvLayer):
            raise ValueError(f"layer {i} is not a conv layer")
    scores = filter_scores_device(params, spec, criterion=criterion,
                                  skip=skip)
    csp_scores = csp_balanced_scores_device(params, spec,
                                            criterion=criterion, skip=skip)
    unknown = set(fractions) - set(scores) - set(csp_scores)
    if unknown:
        raise ValueError(
            f"fractions given for non-prunable conv indices {sorted(unknown)}"
            " (head-producing, shortcut-tied, skipped and multi-provenance "
            "grouped-route convs are protected — compress/graph.py)")
    out = {i: _keep_from_scores(s, fractions.get(i, default))
           for i, s in scores.items()}
    out.update({i: csp_balanced_keep_from_scores(s, parts,
                                                 fractions.get(i, default))
                for i, (parts, s) in csp_scores.items()})
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


def csp_balanced_scores_device(params: Params, spec: NetworkSpec,
                               criterion: str = "l1",
                               skip: Sequence[int] = ()
                               ) -> Dict[int, tuple]:
    """``{conv_idx: (n_parts, (O,) float64 scores)}`` for the
    balance-constrainable CSP source convs: the FLOP-budget allocator's
    ``csp_scores`` input."""
    constraints = csp_constrainable_indices(spec, skip)
    scores = _criterion_scores(params, spec, sorted(constraints), criterion)
    return {i: (constraints[i], scores[i]) for i in constraints}


def csp_balanced_keep_from_scores(scores: np.ndarray, parts: int,
                                  fraction: float) -> np.ndarray:
    """Split-balanced keep-set: rank within each of ``parts`` contiguous
    blocks and drop ``fraction`` per block, so every block loses the same
    count and the repacked slice boundary stays between blocks."""
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
    return {i: csp_balanced_keep_from_scores(s, parts, fraction)
            for i, (parts, s) in csp_balanced_scores_device(
                params, spec, criterion=criterion, skip=skip).items()}


def tied_group_scores_device(params: Params, spec: NetworkSpec,
                             criterion: str = "l1",
                             skip: Sequence[int] = ()
                             ) -> Dict[tuple, np.ndarray]:
    """Group-summed per-filter scores of every fully unprotected
    shortcut-tied group: ``{tuple(sorted member conv idxs): (O,)
    float64}``. A channel is cheap to drop only if it is unimportant in
    every member feeding the [shortcut] adds. Groups holding a
    head-producing, grouped-route source or ``skip`` conv stay
    protected."""
    protected = (head_producer_convs(spec)
                 | grouped_route_source_convs(spec) | set(skip))
    groups = [sorted(g) for g in tied_conv_groups(spec)
              if not (g & protected)]
    sc = _criterion_scores(params, spec, [i for g in groups for i in g],
                           criterion)
    out: Dict[tuple, np.ndarray] = {}
    for g in groups:
        widths = {spec.layers[i].filters for i in g}
        if len(widths) != 1:
            raise ValueError(
                f"tied group {g} mixes filter counts {widths}: the cfg's "
                "channel validation should have rejected this network")
        out[tuple(g)] = np.sum([sc[i] for i in g], axis=0)
    return out


def tied_group_keep_sets(params: Params, spec: NetworkSpec,
                         fraction: float, skip: Sequence[int] = (),
                         criterion: str = "l1") -> Dict[int, np.ndarray]:
    """One shared keep-set per shortcut-tied group, ranked by the
    group-summed scores (Li et al. 2017 §4.2's aggressive option for
    residual graphs): the identity paths are pruned too, identically
    across each group, so every [shortcut] add stays channel-aligned
    (``compress/repack.py`` checks it)."""
    out: Dict[int, np.ndarray] = {}
    for g, group_score in tied_group_scores_device(
            params, spec, criterion=criterion, skip=skip).items():
        keep = _keep_from_scores(group_score, fraction)
        for i in g:
            out[i] = keep
    return out
