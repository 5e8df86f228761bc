"""Structured channel repack (port of ``modelcompression_tpu/compress/
repack.py``).

Given per-conv keep-sets, emit a smaller dense network: a rewritten
NetworkSpec with reduced filter counts and params with sliced tensors
(OIHW: ``w[out_keep][:, in_keep]``). Keep-sets propagate through the graph:

* conv:     kept filters become the next layer's kept inputs
* maxpool / upsample / heads: pass through unchanged
* route:    concatenate source keep-sets at the sources' original offsets
* reorg /s: input keep K over C channels -> {s2*C + c : s2 < s*s, c in K}
* shortcut: both inputs must carry the SAME keep-set (validated)

Invariant (tested): slimmed forward == masked forward, where masked mode
multiplies each pruned conv's post-activation output by its 0/1 mask.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Tuple

import numpy as np
import torch

from modelcompression_tpu_torch.models.cfg import (
    ConvLayer, MaxPoolLayer, NetworkSpec, RegionLayer, ReorgLayer, RouteLayer,
    ShortcutLayer, UpsampleLayer, YoloLayer, _resolve_channels, out_channels,
)
from modelcompression_tpu_torch.models.darknet import Params, conv_key


def propagate_keep_sets(spec: NetworkSpec,
                        keep_sets: Dict[int, np.ndarray]
                        ) -> Tuple[Dict[int, np.ndarray],
                                   Dict[int, np.ndarray]]:
    """For every conv i: in_keep[i] (kept input channels) and out_keep[i]
    (kept filters), both in original coordinates. Convs absent from
    ``keep_sets`` keep all filters."""
    orig_out = out_channels(spec)
    in_keep: Dict[int, np.ndarray] = {}
    out_keep: Dict[int, np.ndarray] = {}
    cur = np.arange(spec.net.channels)
    layer_keep: List[np.ndarray] = []
    for i, l in enumerate(spec.layers):
        if isinstance(l, ConvLayer):
            in_keep[i] = cur
            cur = (np.asarray(keep_sets[i], np.int64) if i in keep_sets
                   else np.arange(l.filters))
            out_keep[i] = cur
        elif isinstance(l, MaxPoolLayer):
            pass
        elif isinstance(l, RouteLayer):
            parts = []
            off = 0
            for a in l.layers:
                if l.groups > 1:
                    # CSP split: the source keep-set must be split-balanced
                    # or the repacked slice selects other channels
                    g = orig_out[a] // l.groups
                    k = np.asarray(layer_keep[a], np.int64)
                    counts = [int(((k >= p * g) & (k < (p + 1) * g)).sum())
                              for p in range(l.groups)]
                    if len(set(counts)) != 1:
                        raise ValueError(
                            f"route at layer {i} has groups={l.groups} "
                            f"but its source layer {a}'s keep-set is "
                            f"not split-balanced (kept per block: "
                            f"{counts}) — the grouped slice would "
                            f"select different channels after repack "
                            f"(compress/graph.csp_split_constraints)")
                    lo = l.group_id * g
                    parts.append(k[(k >= lo) & (k < lo + g)] - lo + off)
                    off += g
                else:
                    parts.append(layer_keep[a] + off)
                    off += orig_out[a]
            cur = np.concatenate(parts)
        elif isinstance(l, ReorgLayer):
            src_c = orig_out[i - 1]
            cur = np.concatenate([k * src_c + np.sort(cur)
                                  for k in range(l.stride * l.stride)])
        elif isinstance(l, ShortcutLayer):
            other = layer_keep[l.from_layer]
            if not np.array_equal(cur, other):
                raise ValueError(
                    f"shortcut at layer {i}: keep-set mismatch between its "
                    f"two inputs (prev keeps {len(cur)} channels, layer "
                    f"{l.from_layer} keeps {len(other)}"
                    + ("" if len(cur) != len(other) else
                       " — same count but different channels")
                    + "); shortcut-tied convs must share one keep-set "
                    "(compress/graph.py tied_conv_groups)")
        elif isinstance(l, (RegionLayer, UpsampleLayer, YoloLayer)):
            pass
        layer_keep.append(cur)
    return in_keep, out_keep


def repack(spec: NetworkSpec, params: Params,
           keep_sets: Dict[int, np.ndarray]
           ) -> Tuple[NetworkSpec, Params]:
    """Produce the slimmed (spec, params) pair; params stay on their
    device."""
    keep_sets = {i: np.sort(np.asarray(k, np.int64))
                 for i, k in keep_sets.items()}
    in_keep, out_keep = propagate_keep_sets(spec, keep_sets)

    new_spec = copy.deepcopy(spec)
    for i, l in enumerate(new_spec.layers):
        if isinstance(l, ConvLayer):
            l.filters = int(len(out_keep[i]))
    _resolve_channels(new_spec)

    new_params: Params = {}
    for i, l in enumerate(spec.layers):
        if not isinstance(l, ConvLayer):
            continue
        p = params[conv_key(i)]
        dev = p["w"].device
        ik = torch.as_tensor(in_keep[i], device=dev)
        ok = torch.as_tensor(out_keep[i], device=dev)
        q = {"w": p["w"].index_select(0, ok).index_select(1, ik)
             .contiguous()}
        for name in ("bias", "gamma", "beta", "mean", "var"):
            if name in p:
                q[name] = p[name].index_select(0, ok)
        new_params[conv_key(i)] = q
    return new_spec, new_params


def channel_masks_from_keep(spec: NetworkSpec,
                            keep_sets: Dict[int, np.ndarray],
                            device="cpu") -> Dict[int, torch.Tensor]:
    """0/1 post-activation channel masks equivalent to the repack."""
    masks = {}
    for i, keep in keep_sets.items():
        l = spec.layers[i]
        if not isinstance(l, ConvLayer):
            raise ValueError(f"layer {i} is not a conv layer")
        m = torch.zeros(l.filters, dtype=torch.float32)
        m[torch.as_tensor(np.asarray(keep, np.int64))] = 1.0
        masks[i] = m.to(device)
    return masks


def uniform_filter_fraction_keep_sets(spec: NetworkSpec, params: Params,
                                      fraction: float, skip=(),
                                      criterion: str = "l1",
                                      tied: str = "protect"
                                      ) -> Dict[int, np.ndarray]:
    """Filter keep-sets at one drop fraction for all prunable convs
    (head-producing convs always protected — compress/graph.py), ranked by
    ``criterion``: ``l1``, ``bn_gamma`` or ``fpgm``. CSP grouped-route
    source convs prune split-balanced.

    ``tied`` is the residual-graph policy (Li et al. 2017 §4.2):
    ``protect`` leaves shortcut-tied convs unpruned; ``group`` prunes each
    tied group with one shared keep-set ranked by group-summed scores
    (``criteria.tied_group_keep_sets``)."""
    from modelcompression_tpu_torch.compress.criteria import (
        csp_balanced_keep_sets, l1_filter_keep_sets, tied_group_keep_sets,
    )
    if tied not in ("protect", "group"):
        raise ValueError(f"tied must be 'protect' or 'group', got {tied!r}")
    sets = dict(l1_filter_keep_sets(params, spec, fraction, skip=skip,
                                    criterion=criterion))
    sets.update(csp_balanced_keep_sets(params, spec, fraction, skip=skip,
                                       criterion=criterion))
    if tied == "group":
        sets.update(tied_group_keep_sets(params, spec, fraction, skip=skip,
                                         criterion=criterion))
    return {i: np.asarray(k) for i, k in sets.items()}
