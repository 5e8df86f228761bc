"""Low-rank factorization, port of ``modelcompression_tpu/compress/lowrank.py``
(numpy, on the host): replace a k×k conv with a k×k→r linear conv and a
1×1 r→co conv by an output-channel SVD (Denton et al. 2014 / Jaderberg et
al. 2014).

Flatten the HWIO weight W (kh, kw, ci, co) to M (kh·kw·ci, co), truncate
its SVD at rank r and split M_r = (U_r√S)(√S V_rᵀ). The first factor is
the k×k conv's weight (r filters, linear, no BN, zero bias, the original
stride and pad); the second is a 1×1 conv with the original BN or bias
and activation. At full rank the pair reproduces the layer to float
roundoff; below it the truncation is optimal in Frobenius norm
(Eckart–Young). The port holds kernels OIHW, so the SVD takes the HWIO
view (``models/convert.params_to_jax``): the input's order decides the
factors, and this one makes them equal to the JAX package's bit for bit.

The rank is the smallest r whose singular values carry ``energy`` of ΣS²,
or an explicit ``ranks`` entry; a layer is factored only where r over the
break-even rank (kh·kw·ci·co / (kh·kw·ci + co)) is at most ``max_cost``.
The result is a plain rewritten cfg and params: both convs are standard
layers, so every path (forward, train, eval, masks, int8) runs it.
Factoring inserts layers, so every route reference is remapped (a
reference to a factored conv points at its second conv) and the params
keys are rebuilt on the new numbering.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from modelcompression_tpu_torch.models.cfg import (
    ConvLayer, NetworkSpec, RouteLayer, _resolve_channels,
)
from modelcompression_tpu_torch.models.convert import (
    params_from_jax, params_to_jax,
)
from modelcompression_tpu_torch.models.darknet import Params, conv_key

__all__ = [
    "factor_conv_weight", "rank_for_energy", "breakeven_rank",
    "factor_network", "FactorEntry",
]


def _split_from_svd(u: np.ndarray, s: np.ndarray, vt: np.ndarray,
                    rank: int, shape: Tuple[int, int, int, int]
                    ) -> Tuple[np.ndarray, np.ndarray]:
    kh, kw, ci, co = shape
    if not 1 <= rank <= s.size:
        raise ValueError(f"rank {rank} out of [1, {s.size}]")
    sq = np.sqrt(s[:rank])
    w1 = (u[:, :rank] * sq).reshape(kh, kw, ci, rank).astype(np.float32)
    w2 = (sq[:, None] * vt[:rank]).reshape(1, 1, rank, co).astype(
        np.float32)
    return w1, w2


def factor_conv_weight(w: np.ndarray, rank: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """SVD-split one HWIO weight (kh,kw,ci,co) into (kh,kw,ci,r) and
    (1,1,r,co), HWIO numpy float32."""
    kh, kw, ci, co = w.shape
    m = np.asarray(w, np.float64).reshape(kh * kw * ci, co)
    u, s, vt = np.linalg.svd(m, full_matrices=False)
    return _split_from_svd(u, s, vt, rank, (kh, kw, ci, co))


def rank_for_energy(singular_values: np.ndarray, energy: float) -> int:
    """Smallest r whose top-r singular values carry >= energy of ΣS²."""
    if not 0.0 < energy <= 1.0:
        raise ValueError(f"energy must be in (0, 1], got {energy}")
    e = np.cumsum(np.asarray(singular_values, np.float64) ** 2)
    total = e[-1]
    if total == 0.0:
        return 1
    return int(np.searchsorted(e, energy * total - 1e-12) + 1)


def breakeven_rank(layer: ConvLayer) -> float:
    """The rank at which the factored pair costs what the conv does, in
    FLOPs and in params (both linear in r with the same coefficients)."""
    kkci = layer.size * layer.size * layer.in_channels
    return kkci * layer.filters / (kkci + layer.filters)


@dataclasses.dataclass
class FactorEntry:
    layer_idx: int          # index in the ORIGINAL spec
    rank: int
    full_rank: int
    energy_kept: float      # fraction of ΣS² retained
    cost_ratio: float       # factored/original FLOPs (= params ratio)


def factor_network(params: Params, spec: NetworkSpec,
                   energy: float = 0.9,
                   ranks: Optional[Dict[int, int]] = None,
                   max_cost: float = 1.0,
                   ) -> Tuple[NetworkSpec, Params, List[FactorEntry]]:
    """Factor every conv whose energy-selected rank passes the cost guard;
    returns ``(new_spec, new_params, report)``, the params OIHW on the
    input params' device.

    A non-empty ``ranks`` factors only the listed layers, at the given
    ranks (clamped to the spectrum, still under the cost guard: pass a
    large ``max_cost`` to force). Layers that fail the guard pass through
    unchanged. Nothing of the returned spec or params is shared with the
    inputs."""
    if ranks is None:
        ranks = {}
    for idx, r in ranks.items():
        if not (0 <= idx < len(spec.layers)
                and isinstance(spec.layers[idx], ConvLayer)):
            raise ValueError(f"--rank index {idx} is not a conv layer")
        if r < 1:
            raise ValueError(
                f"--rank {idx}:{r} — explicit rank must be >= 1 "
                f"(a clamped rank would silently destroy the layer)")
    device = next(iter(next(iter(params.values())).values())).device
    np_params = params_to_jax(params)

    new_layers: List = []
    new_params: Dict[str, Dict[str, np.ndarray]] = {}
    report: List[FactorEntry] = []
    new_of: Dict[int, int] = {}  # old idx -> new idx of its OUTPUT layer
    for idx, layer in enumerate(spec.layers):
        if isinstance(layer, RouteLayer):
            new_layers.append(RouteLayer(
                layers=tuple(new_of[a] for a in layer.layers),
                groups=layer.groups, group_id=layer.group_id))
            new_of[idx] = len(new_layers) - 1
            continue
        split = None  # (rank, energy_kept, w1, w2)
        if isinstance(layer, ConvLayer) and (not ranks or idx in ranks):
            w = np.asarray(np_params[conv_key(idx)]["w"], np.float32)
            # one SVD per conv: the rank selection and the split share it
            u, s, vt = np.linalg.svd(
                w.astype(np.float64).reshape(-1, w.shape[-1]),
                full_matrices=False)
            r = max(1, min(ranks.get(idx, rank_for_energy(s, energy)),
                           s.size))
            if r / breakeven_rank(layer) <= max_cost:
                e2 = float(np.sum(s[:r] ** 2)
                           / max(np.sum(s ** 2), 1e-30))
                split = (r, e2) + _split_from_svd(u, s, vt, r, w.shape)
        if split is not None:
            r, e2, w1, w2 = split
            p = np_params[conv_key(idx)]
            first = ConvLayer(
                filters=r, size=layer.size, stride=layer.stride,
                pad=layer.pad, batch_normalize=False, activation="linear")
            second = ConvLayer(
                filters=layer.filters, size=1, stride=1, pad=0,
                batch_normalize=layer.batch_normalize,
                activation=layer.activation)
            new_params[conv_key(len(new_layers))] = {
                "w": w1, "bias": np.zeros((r,), np.float32)}
            new_layers.append(first)
            tail = {f: np.array(v, np.float32)
                    for f, v in p.items() if f != "w"}
            new_params[conv_key(len(new_layers))] = {"w": w2, **tail}
            new_layers.append(second)
            report.append(FactorEntry(
                layer_idx=idx, rank=r, full_rank=min(
                    layer.size * layer.size * layer.in_channels,
                    layer.filters),
                energy_kept=e2,
                cost_ratio=r / breakeven_rank(layer)))
        else:
            if isinstance(layer, ConvLayer):
                new_params[conv_key(len(new_layers))] = {
                    f: np.array(v) for f, v in
                    np_params[conv_key(idx)].items()}
            new_layers.append(dataclasses.replace(layer))
        new_of[idx] = len(new_layers) - 1

    new_spec = NetworkSpec(net=dataclasses.replace(spec.net),
                           layers=new_layers)
    _resolve_channels(new_spec)
    return new_spec, params_from_jax(new_params, device=device), report
