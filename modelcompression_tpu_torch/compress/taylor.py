"""Taylor-expansion filter criterion (Molchanov et al. 2017, "Pruning
Convolutional Neural Networks for Resource Efficient Inference"), port of
``modelcompression_tpu/compress/taylor.py``.

First-order estimate of the loss change from removing filter j:

    theta_j = | sum_{batch, spatial} a_j * dL/da_j |

with ``a_j`` filter j's post-activation output. The gradient is taken with
respect to all-ones per-filter gates threaded through the forward's
``channel_masks`` (post-activation multipliers): with g_j == 1 the chain
rule gives dL/dg_j = sum a_j * dL/da_j exactly, one ``torch.autograd.grad``
over (num_prunable_convs,) small vectors, no hooks. The forward runs with
batch statistics (``forward(..., train_stats=True)``) and the family's
detection loss. Score totals stay on the params' device across batches and
are read back once.

Scores are L2-normalized per layer (Molchanov §3.3); per-layer rank
selection is invariant to it, and it makes scores comparable across layers
for the FLOP-budget allocator. ``second_moment=True`` accumulates
(dL/dg_j)^2 per batch instead of |dL/dg_j| (Molchanov et al. 2019).
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch

from modelcompression_tpu_torch.compress.criteria import (
    _keep_from_scores, csp_constrainable_indices, keep_sets_from_scores,
)
from modelcompression_tpu_torch.compress.graph import (
    grouped_route_source_convs, head_producer_convs, protected_conv_indices,
    tied_conv_groups,
)
from modelcompression_tpu_torch.core.precision import BITMATCH, Precision
from modelcompression_tpu_torch.models.cfg import NetworkSpec
from modelcompression_tpu_torch.models.darknet import Params, forward


def taylor_gate_indices(spec: NetworkSpec,
                        skip: Sequence[int] = ()) -> Tuple[int, ...]:
    """Prunable conv indices for Taylor scoring: every conv except the
    structurally protected set (compress/graph.py) and ``skip``, the
    protection rule of the data-free criteria."""
    protected = set(skip) | protected_conv_indices(spec)
    return tuple(i for i in spec.conv_indices() if i not in protected)


def _score_step(params: Params, spec: NetworkSpec, precision: Precision,
                gate_idx: Sequence[int], images, targets, seen,
                second_moment: bool) -> Dict[int, torch.Tensor]:
    """One batch: forward with batch statistics and all-ones gates, the
    detection loss, its gradient with respect to the gates, then |g| (or
    g^2). The gates are fp32, or float64 at float64 compute. uint8 images
    are scaled by 1/255; float images are taken as already scaled, as the
    train step takes them."""
    from modelcompression_tpu_torch.train.yolo_loss import detection_loss
    dev = next(iter(next(iter(params.values())).values())).device
    images = torch.as_tensor(images).to(dev)
    x = images.float()
    if images.dtype == torch.uint8:
        x = x / 255.0
    targets = torch.as_tensor(targets).to(dev, torch.float32)
    gate_dtype = torch.promote_types(precision.compute_dtype, torch.float32)
    with torch.enable_grad():
        gates = {i: torch.ones(spec.layers[i].filters, dtype=gate_dtype,
                               device=dev, requires_grad=True)
                 for i in gate_idx}
        raw = forward(params, x, spec, precision=precision,
                      train_stats=True, channel_masks=gates)
        loss = detection_loss(raw, targets, spec, seen).loss
        grads = torch.autograd.grad(loss, [gates[i] for i in gate_idx])
    return {i: g * g if second_moment else g.abs()
            for i, g in zip(gate_idx, grads)}


def _raw_gate_scores(params: Params, spec: NetworkSpec,
                     gate_idx: Sequence[int],
                     batches: Iterable[Tuple[np.ndarray, np.ndarray]],
                     seen: int, precision: Precision,
                     second_moment: bool) -> Dict[int, np.ndarray]:
    """Batch-averaged, un-normalized gate scores for ``gate_idx``: totals
    on the params' device, one read back at the end."""
    params = {k: {n: v.detach() for n, v in p.items()}
              for k, p in params.items()}
    gate_idx = tuple(gate_idx)
    totals = None
    n = 0
    for images, targets in batches:
        acc = _score_step(params, spec, precision, gate_idx, images,
                          targets, seen, second_moment)
        totals = acc if totals is None else {
            i: totals[i] + acc[i] for i in gate_idx}
        n += 1
    if n == 0:
        raise ValueError("taylor scoring needs at least one batch")
    if not gate_idx:
        return {}
    flat = torch.cat([totals[i] for i in gate_idx]).cpu().numpy()
    sizes = np.cumsum([0] + [totals[i].numel() for i in gate_idx])
    if flat.dtype != np.float64:
        flat = flat.astype(np.float32)
    return {i: flat[sizes[k]:sizes[k + 1]] / n
            for k, i in enumerate(gate_idx)}


def _l2_normed(s: np.ndarray) -> np.ndarray:
    norm = float(np.sqrt(np.sum(s * s)))
    return s / norm if norm > 0 else s


def _tied_groups(spec: NetworkSpec, skip: Sequence[int]):
    """The shortcut-tied groups with no head-producing, grouped-route
    source or skipped member, as sorted tuples."""
    protected = (head_producer_convs(spec)
                 | grouped_route_source_convs(spec) | set(skip))
    return [tuple(sorted(g)) for g in tied_conv_groups(spec)
            if not (g & protected)]


def taylor_filter_scores_device(
        params: Params, spec: NetworkSpec,
        batches: Iterable[Tuple[np.ndarray, np.ndarray]],
        skip: Sequence[int] = (),
        seen: int = 0,
        precision: Precision = BITMATCH,
        second_moment: bool = False) -> Dict[int, np.ndarray]:
    """Taylor filter scores over ``batches`` of (uint8 NHWC images, or
    float ones already scaled to [0, 1], and (B, M, 5) padded targets),
    the BatchLoader batch shape: {conv layer idx: (filters,) scores},
    L2-normalized per layer. Raises if ``batches`` is empty: all-zero
    scores would prune by tie order."""
    raw = _raw_gate_scores(params, spec, taylor_gate_indices(spec, skip),
                           batches, seen, precision, second_moment)
    return {i: _l2_normed(s) for i, s in raw.items()}


def taylor_scores_with_groups(
        params: Params, spec: NetworkSpec,
        batches: Iterable[Tuple[np.ndarray, np.ndarray]],
        skip: Sequence[int] = (),
        seen: int = 0,
        precision: Precision = BITMATCH,
        second_moment: bool = False
        ) -> Tuple[Dict[int, np.ndarray], Dict[tuple, np.ndarray]]:
    """Scores of the untied prunable convs and of the shortcut-tied
    groups from one scoring pass: ``(untied_scores, group_scores)``. A
    gate on a tied conv is a measurement, not a prune, so it leaves every
    [shortcut] add intact. The group score is the filter-for-filter sum of
    its members' raw gate scores, L2-normalized as one unit."""
    groups = _tied_groups(spec, skip)
    untied_idx = taylor_gate_indices(spec, skip)
    members = tuple(i for g in groups for i in g)
    raw = _raw_gate_scores(params, spec, tuple(untied_idx) + members,
                           batches, seen, precision, second_moment)
    untied = {i: _l2_normed(raw[i]) for i in untied_idx}
    group_scores = {
        g: _l2_normed(np.sum([raw[i] for i in g], axis=0)) for g in groups}
    return untied, group_scores


def taylor_scores_all(
        params: Params, spec: NetworkSpec,
        batches: Iterable[Tuple[np.ndarray, np.ndarray]],
        skip: Sequence[int] = (),
        seen: int = 0,
        precision: Precision = BITMATCH,
        second_moment: bool = False
        ) -> Tuple[Dict[int, np.ndarray], Dict[tuple, np.ndarray],
                   Dict[int, tuple]]:
    """The FLOP-budget allocator's whole Taylor input from one scoring
    pass: ``(untied_scores, tied_group_scores, csp_scores)``, the last
    keyed ``{conv_idx: (n_parts, (O,) scores)}`` for the
    balance-constrainable CSP source convs."""
    groups = _tied_groups(spec, skip)
    constraints = csp_constrainable_indices(spec, skip)
    untied_idx = taylor_gate_indices(spec, skip)
    members = tuple(i for g in groups for i in g)
    raw = _raw_gate_scores(
        params, spec, tuple(untied_idx) + members + tuple(constraints),
        batches, seen, precision, second_moment)
    untied = {i: _l2_normed(raw[i]) for i in untied_idx}
    group_scores = {
        g: _l2_normed(np.sum([raw[i] for i in g], axis=0)) for g in groups}
    csp_scores = {i: (parts, _l2_normed(raw[i]))
                  for i, parts in constraints.items()}
    return untied, group_scores, csp_scores


def taylor_filter_keep_sets(
        params: Params, spec: NetworkSpec,
        batches: Iterable[Tuple[np.ndarray, np.ndarray]],
        fraction: float,
        skip: Sequence[int] = (),
        seen: int = 0,
        precision: Precision = BITMATCH,
        second_moment: bool = False,
        tied: str = "protect") -> Dict[int, np.ndarray]:
    """Keep-sets dropping the floor(fraction*O) lowest-Taylor-score filters
    per prunable conv, the rank and tie rule of compress/criteria.py.
    ``tied='group'`` also prunes each shortcut-tied group with one shared
    keep-set ranked by its group-summed scores, from the same pass."""
    if tied not in ("protect", "group"):
        raise ValueError(f"tied must be 'protect' or 'group', got {tied!r}")
    if tied == "group":
        untied, group_scores = taylor_scores_with_groups(
            params, spec, batches, skip=skip, seen=seen,
            precision=precision, second_moment=second_moment)
        keep = keep_sets_from_scores(untied, fraction)
        for g, s in group_scores.items():
            ks = _keep_from_scores(np.asarray(s), fraction)
            for i in g:
                keep[i] = ks
        return keep
    scores = taylor_filter_scores_device(params, spec, batches, skip=skip,
                                         seen=seen, precision=precision,
                                         second_moment=second_moment)
    return keep_sets_from_scores(scores, fraction)
