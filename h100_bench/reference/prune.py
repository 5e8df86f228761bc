"""L1 filter pruning and repack, worked out again on the reference side.

Li et al. 2017: a filter's score is the sum of its absolute weights; each
prunable conv drops the ``floor(fraction * filters)`` lowest-scoring
filters, ties dropping the lower index first. The conv that feeds a
detection head keeps every filter (its channels are the head's
encoding). The repack slices each conv's kept filters and the kept input
channels its producers leave, through max pools, routes (concatenation
offsets) and reorg (the space-to-depth order the program's model uses:
output channel ``(s * dy + dx) * C + c``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from h100_bench.reference.cfg import head_indices, with_filters


def keep_sets(params: Dict[str, Dict[str, torch.Tensor]],
              layers: List[dict], fraction: float) -> Dict[int, np.ndarray]:
    if any(l["type"] == "shortcut" or
           (l["type"] == "route" and l["groups"] > 1) for l in layers):
        raise NotImplementedError(
            "reference keep-sets cover chains without residual or grouped "
            "routes (YOLOv2); tied groups are not worked out here")
    protected = {h - 1 for h in head_indices(layers)}
    out = {}
    for i, l in enumerate(layers):
        if l["type"] != "conv" or i in protected:
            continue
        score = params[f"conv{i}"]["w"].float().abs().sum(dim=(1, 2, 3))
        score = score.cpu().numpy()
        n_drop = int(fraction * score.shape[0])
        order = np.argsort(score, kind="stable")
        out[i] = np.sort(order[n_drop:])
    return out


def _in_keep(layers: List[dict], keep: Dict[int, np.ndarray]
             ) -> Dict[int, np.ndarray]:
    """Kept input channels of every conv, in original coordinates."""
    cur = np.arange(layers[0]["in_c"])
    per_layer: List[np.ndarray] = []
    ins = {}
    for i, l in enumerate(layers):
        t = l["type"]
        if t == "conv":
            ins[i] = cur
            cur = keep.get(i, np.arange(l["filters"]))
        elif t == "route":
            parts, off = [], 0
            for a in l["layers"]:
                parts.append(per_layer[a] + off)
                off += layers[a]["out_c"]
            cur = np.concatenate(parts)
        elif t == "reorg":
            c = layers[i - 1]["out_c"]
            cur = np.concatenate([k * c + cur
                                  for k in range(l["stride"] ** 2)])
        per_layer.append(cur)
    return ins


def repack(params: Dict[str, Dict[str, torch.Tensor]], net: Dict[str, str],
           layers: List[dict], keep: Dict[int, np.ndarray]
           ) -> Tuple[List[dict], Dict[str, Dict[str, torch.Tensor]]]:
    ins = _in_keep(layers, keep)
    out = {}
    for i, l in enumerate(layers):
        if l["type"] != "conv":
            continue
        p = params[f"conv{i}"]
        dev = p["w"].device
        ok = torch.as_tensor(keep.get(i, np.arange(l["filters"])),
                             device=dev, dtype=torch.long)
        ik = torch.as_tensor(ins[i], device=dev, dtype=torch.long)
        q = {"w": p["w"][ok][:, ik].contiguous()}
        for name in ("bias", "gamma", "beta", "mean", "var"):
            if name in p:
                q[name] = p[name][ok]
        out[f"conv{i}"] = q
    slim = with_filters(net, layers, {i: len(k) for i, k in keep.items()})
    return slim, out


def apply_recipe(raw, net: Dict[str, str], layers: List[dict], recipe):
    """(layers, params) of the cell's model: the raw ones, or the L1
    keep-sets' repack at ``recipe["fraction"]``."""
    if not recipe:
        return layers, raw
    return repack(raw, net, layers, keep_sets(raw, layers,
                                              recipe["fraction"]))
