"""FLOP-targeted automatic per-layer filter allocation: the port's own
copy of ``modelcompression_tpu/compress/flops.py`` (numpy only, on the
host).

Rank every prunable filter globally by its layer-normalized importance
score and drop lowest-first until the network's conv FLOPs reach a target
budget; the per-layer fractions fall out of the global rank (Molchanov et
al. 2019 §3.3 use the same global-normalized-rank construction). A FLOP
budget in place of a filter fraction: a uniform fraction cuts FLOPs
quadratically in the middle of the network (in- and out-channels both
shrink) but only linearly at the ends, and the deployment question is how
fast the model must run.

The FLOP accounting replays the spec's channel and spatial propagation
with per-conv alive-filter overrides, which is what ``repack()`` +
``models.darknet.num_conv_flops`` give (``tests/test_torch_taylor_flops.py``
holds the equality).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from modelcompression_tpu_torch.models.cfg import (
    ConvLayer, MaxPoolLayer, NetworkSpec, RegionLayer, ReorgLayer,
    RouteLayer, ShortcutLayer, UpsampleLayer, YoloLayer,
)

SCORE_NORMS = ("l2", "mean", "none")


def conv_flops_by_layer(spec: NetworkSpec,
                        alive: Dict[int, int] = None) -> Dict[int, int]:
    """Per-conv MAC*2 FLOPs for one image, with optional per-conv alive
    filter-count overrides (``alive[conv_idx] -> surviving filters``).

    With ``alive=None`` this decomposes ``darknet.num_conv_flops`` exactly
    (same spatial walk, same pool/reorg/route rules). With overrides it
    predicts the repacked network's FLOPs: a conv's in-channel count is
    its producer's alive count propagated through route concats, reorg
    stride² expansion and shortcut adds — the same propagation
    ``compress.repack`` applies physically.
    """
    alive = alive or {}
    flops: Dict[int, int] = {}
    h, w = spec.net.height, spec.net.width
    c = spec.net.channels
    hist: List[Tuple[int, int, int]] = []  # (h, w, channels) per layer
    for i, l in enumerate(spec.layers):
        if isinstance(l, ConvLayer):
            out_c = alive.get(i, l.filters)
            h = (h + 2 * l.padding - l.size) // l.stride + 1
            w = (w + 2 * l.padding - l.size) // l.stride + 1
            flops[i] = 2 * h * w * l.size * l.size * c * out_c
            c = out_c
        elif isinstance(l, MaxPoolLayer):
            h = (h + l.pad_total - l.size) // l.stride + 1
            w = (w + l.pad_total - l.size) // l.stride + 1
        elif isinstance(l, ReorgLayer):
            h, w = h // l.stride, w // l.stride
            c = c * l.stride * l.stride
        elif isinstance(l, UpsampleLayer):
            h, w = h * l.stride, w * l.stride
        elif isinstance(l, RouteLayer):
            h, w = hist[l.layers[0]][:2]
            # grouped route: each source contributes C/groups channels.
            # The integer division stays exact because sources are either
            # fully protected or pruned split-BALANCED (same count kept
            # per block — criteria.csp_balanced_keep_sets), so the live
            # count remains a multiple of groups.
            c = sum(hist[a][2] // l.groups for a in l.layers)
        elif isinstance(l, ShortcutLayer):
            pass  # add: channels/dims unchanged (equality checked at parse)
        elif isinstance(l, (RegionLayer, YoloLayer)):
            pass
        else:  # pragma: no cover - new layer types must be classified here
            raise TypeError(f"unhandled layer type {type(l).__name__}")
        hist.append((h, w, c))
    return flops


def total_conv_flops(spec: NetworkSpec,
                     alive: Dict[int, int] = None) -> int:
    """Network conv FLOPs/img under alive-filter overrides."""
    return sum(conv_flops_by_layer(spec, alive).values())


def flop_targeted_keep_sets(spec: NetworkSpec,
                            scores: Dict[int, np.ndarray],
                            target: float,
                            min_filters: int = 1,
                            norm: str = "l2",
                            group_scores: Dict[tuple, np.ndarray] = None,
                            csp_scores: Dict[int, tuple] = None,
                            ) -> Tuple[Dict[int, np.ndarray],
                                       Dict[int, float]]:
    """Keep-sets hitting a conv-FLOP budget: drop globally-lowest
    normalized-score filters until ``total_conv_flops <= target * base``.

    ``scores`` is any per-filter score map over the PRUNABLE convs (from
    ``filter_scores_device`` or ``taylor_filter_scores_device`` — protected
    convs are already absent from those maps). ``target`` is the surviving
    conv-FLOP fraction in (0, 1). Every prunable conv keeps at least
    ``min_filters`` filters.

    ``group_scores`` (``criteria.tied_group_scores_device``) extends the
    allocation to shortcut-TIED groups: each group is one rank unit —
    ``{tuple(sorted member conv idxs): (O,) group-summed score}`` —
    whose filter drop removes the channel from EVERY member at once (the
    keep-sets stay group-aligned, repack's invariant), and whose FLOP
    delta spans all members. Group scores are normalized as one unit so
    they rank against single-conv filters on the same footing.

    ``csp_scores`` (``criteria.csp_balanced_scores_device``) extends it
    to CSP grouped-route source convs: ``{conv_idx: (n_parts, (O,)
    scores)}``. Each such conv is one rank unit whose k-th DROP STEP
    removes the k-th-lowest-scored remaining filter from EVERY split
    block at once (``n_parts`` filters per step) — the keep-set stays
    split-BALANCED, repack's slice invariant, the same move that made
    tied groups budget-composable. The step's rank score is the MEAN of
    the dropped filters' normalized scores — per-CHANNEL importance, so
    a step ranks on the same footing as a single-conv filter (a sum
    would be ~n_parts x larger and starve the csp convs of pruning;
    tied groups rank by one entry of their unit-normalized vector, the
    same per-channel footing). Steps apply in ascending order by
    construction (per-block sorted sequences give a non-decreasing step
    sequence). The conv keeps at least
    ``max(n_parts, ceil(min_filters / n_parts) * n_parts)`` filters
    (at least one per block AND the min_filters floor, balanced).

    Returns ``(keep_sets, fractions)`` where ``fractions`` is the
    discovered per-layer drop schedule (conv idx -> dropped fraction) —
    directly reusable as a ``--fractions`` argument for the UNTIED
    layers, and the evidence of the non-uniform allocation.

    Raises ValueError if the budget is unreachable at ``min_filters``
    (the message states the reachable floor so the caller can re-run).
    """
    if not 0.0 < target < 1.0:
        raise ValueError(f"--target-flops must be in (0, 1), got {target}")
    if min_filters < 1:
        raise ValueError(f"min_filters must be >= 1, got {min_filters}")
    for i in scores:
        if not (0 <= i < len(spec.layers)
                and isinstance(spec.layers[i], ConvLayer)):
            raise ValueError(f"score for non-conv layer index {i}")
        if len(scores[i]) != spec.layers[i].filters:
            raise ValueError(
                f"conv[{i}] has {spec.layers[i].filters} filters but "
                f"{len(scores[i])} scores")
    group_scores = group_scores or {}
    for g, s in group_scores.items():
        for i in g:
            if not (0 <= i < len(spec.layers)
                    and isinstance(spec.layers[i], ConvLayer)):
                raise ValueError(f"group {g}: non-conv layer index {i}")
            if i in scores:
                raise ValueError(
                    f"conv[{i}] appears both untied (scores) and in tied "
                    f"group {g}")
            if len(s) != spec.layers[i].filters:
                raise ValueError(
                    f"group {g}: conv[{i}] has {spec.layers[i].filters} "
                    f"filters but {len(s)} group scores")
    csp_scores = csp_scores or {}
    for i, (parts, s) in csp_scores.items():
        if not (0 <= i < len(spec.layers)
                and isinstance(spec.layers[i], ConvLayer)):
            raise ValueError(f"csp_scores: non-conv layer index {i}")
        if i in scores or any(i in g for g in group_scores):
            raise ValueError(
                f"conv[{i}] appears both in csp_scores and in "
                "scores/group_scores")
        o = spec.layers[i].filters
        if len(s) != o:
            raise ValueError(
                f"csp conv[{i}] has {o} filters but {len(s)} scores")
        if parts < 2 or o % parts:
            raise ValueError(
                f"csp conv[{i}]: {o} filters not divisible by "
                f"parts={parts}")

    # rank UNITS: ungrouped convs singly, each tied group as one whole
    # (key = the member tuple; dropping its filter j shrinks every member)
    units: Dict[tuple, np.ndarray] = {(i,): np.asarray(s)
                                      for i, s in scores.items()}
    units.update({tuple(g): np.asarray(s)
                  for g, s in group_scores.items()})

    base = total_conv_flops(spec)
    budget = target * base
    alive = {i: spec.layers[i].filters for u in units for i in u}
    alive.update({i: spec.layers[i].filters for i in csp_scores})
    # per-conv floors: min_filters for plain units; at least one filter
    # per split block (balanced) for csp units
    floors = {i: min_filters for u in units for i in u}
    floors.update({
        i: max(parts, -(-min_filters // parts) * parts)
        for i, (parts, _) in csp_scores.items()})
    floor = total_conv_flops(spec, floors)
    if budget < floor:
        raise ValueError(
            f"target {target:.4f} of conv FLOPs is below the reachable "
            f"floor {floor / base:.4f} (all prunable convs at "
            f"min_filters={min_filters}; protected convs cannot shrink)"
            + ("" if group_scores else " — raise --target-flops or add "
               "the tied groups with --tied group"))

    if norm not in SCORE_NORMS:
        raise ValueError(f"unknown score norm {norm!r} (one of {SCORE_NORMS})")

    def _norm_one(s):
        # make scores comparable ACROSS rank units: raw L1/Taylor
        # magnitudes scale with fan-in and activation statistics, so a
        # global rank over raw values just prunes whole low-scale
        # layers. 'l2' = Molchanov et al. 2019 eq. 8; 'none' is exposed
        # so the failure mode is demonstrable.
        s = np.asarray(s, np.float64)
        if norm == "l2":
            return s / max(float(np.linalg.norm(s)), 1e-12)
        if norm == "mean":
            return s / max(float(np.mean(s)), 1e-12)
        return s

    ns = {u: _norm_one(s) for u, s in units.items()}
    # csp units: precompute the balanced DROP STEPS from the normalized
    # (O,) vector — step k = {each block's k-th lowest remaining filter},
    # step score = sum of those normalized scores (docstring)
    csp_steps: Dict[tuple, List[List[int]]] = {}
    csp_step_scores: Dict[tuple, List[float]] = {}
    for i, (parts, s) in csp_scores.items():
        nsv = _norm_one(s)
        block = len(nsv) // parts
        order = [np.argsort(nsv[b * block:(b + 1) * block],
                            kind="stable") + b * block
                 for b in range(parts)]
        steps = [[int(order[b][k]) for b in range(parts)]
                 for k in range(block)]
        csp_steps[(i,)] = steps
        csp_step_scores[(i,)] = [float(np.mean([nsv[j] for j in st]))
                                 for st in steps]

    # global ascending rank; ties broken (unit, index) so the allocation
    # is deterministic like every criterion in criteria.py. csp steps
    # join the same rank with their per-step score mass; their ascending
    # per-unit order is preserved by the sort (non-decreasing scores,
    # index tiebreak).
    cand = sorted(
        [(float(ns[u][j]), u, j) for u in ns for j in range(len(ns[u]))]
        + [(sc, u, k) for u, scs in csp_step_scores.items()
           for k, sc in enumerate(scs)])
    dropped: Dict[tuple, List[int]] = {u: [] for u in units}
    dropped.update({u: [] for u in csp_steps})
    next_step = {u: 0 for u in csp_steps}
    cur = total_conv_flops(spec, alive)
    for _, u, j in cand:
        if cur <= budget:
            break
        if u in csp_steps:
            (i,) = u
            parts = csp_scores[i][0]
            if alive[i] - parts < floors[i]:
                continue
            assert j == next_step[u], "csp steps must apply in order"
            next_step[u] += 1
            alive[i] -= parts
            dropped[u].extend(csp_steps[u][j])
        else:
            if alive[u[0]] - 1 < min_filters:
                continue
            for i in u:
                alive[i] -= 1
            dropped[u].append(j)
        cur = total_conv_flops(spec, alive)

    keep = {}
    fractions = {}
    for u, s in units.items():
        gone = set(dropped[u])
        ks = np.asarray(
            [j for j in range(len(s)) if j not in gone], np.int32)
        for i in u:
            keep[i] = ks
            fractions[i] = len(gone) / len(s)
    for u in csp_steps:
        (i,) = u
        o = spec.layers[i].filters
        gone = set(dropped[u])
        keep[i] = np.asarray([j for j in range(o) if j not in gone],
                             np.int32)
        fractions[i] = len(gone) / o
    return keep, fractions
