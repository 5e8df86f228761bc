"""Weight sharing by per-layer k-means codebooks (Deep Compression's second
stage, Han et al. 2016), port of ``modelcompression_tpu/compress/codebook.py``
(numpy, on the host).

Each conv weight tensor becomes a codebook of 2^bits shared float32
values and one small integer code per weight. Pruned zeros stay exact:
when a layer holds zeros, code 0 is pinned to 0.0 and only the nonzero
weights are clustered into the other 2^bits - 1 slots. BN and bias
vectors stay float32.

The codec is a storage format: ``load_cmodel`` reconstructs plain float32
params, so serving runs the unchanged forward (and its input-stage
kernel). k-means is 1-D, sorted-midpoint assignment with Deep
Compression's linear init, deterministic.

Order matters: ``np.bincount(weights=)`` sums in element order, so the
centroids depend on the order the weights are flattened in. Each kernel is
clustered in the JAX package's HWIO order (``models/convert.params_to_jax``),
and its codes are stored HWIO, so an artifact written by either package
loads in the other, and the codes and codebooks are the JAX package's bit
for bit.

Workflow::

    cmodel = cluster_network(params, spec, bits=6)
    params2 = reconstruct(cmodel)          # <= 2^6 distinct values a layer
    save_cmodel(path, cmodel, spec)        # one .npz
    params2, spec = load_cmodel(path)      # serving
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from modelcompression_tpu_torch.models.cfg import (
    NetworkSpec, dump_cfg, parse_cfg,
)
from modelcompression_tpu_torch.models.convert import (
    params_from_jax, params_to_jax,
)
from modelcompression_tpu_torch.models.darknet import Params

# one clustered entry: {"codes": uintN (HWIO w.shape), "codebook": (K,)
# f32, <other param fields verbatim f32>}, all numpy
CModel = Dict[str, Dict[str, np.ndarray]]

PACK_FIELDS = ("payload", "huff_lengths", "fixed_bits", "pack_shape")


def _kmeans_1d(x: np.ndarray, k: int, iters: int = 25) -> np.ndarray:
    """Deterministic 1-D k-means: linear init over [min, max],
    sorted-midpoint assignment. Returns the sorted (k,) centroids (an
    empty cluster keeps its place)."""
    lo, hi = float(x.min()), float(x.max())
    if lo == hi:
        return np.full(k, lo, np.float32)
    c = np.linspace(lo, hi, k).astype(np.float32)
    for _ in range(iters):
        mids = (c[1:] + c[:-1]) / 2
        idx = np.searchsorted(mids, x)
        sums = np.bincount(idx, weights=x, minlength=k)
        cnts = np.bincount(idx, minlength=k)
        nz = cnts > 0
        new = c.copy()
        new[nz] = (sums[nz] / cnts[nz]).astype(np.float32)
        if np.array_equal(new, c):
            break
        c = np.sort(new)
    return c


def cluster_layer(w: np.ndarray, bits: int, iters: int = 25
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Cluster one weight array (numpy, flattened in its own order) into
    2^bits shared values; returns ``(codes, codebook)`` with
    ``codebook[codes]`` the reconstruction. Exact zeros map to an exact
    0.0 slot; an array with at most 2^bits distinct values round-trips
    exactly."""
    if not 2 <= bits <= 16:
        raise ValueError(f"bits must be in [2, 16], got {bits}")
    k = 1 << bits
    flat = np.asarray(w, np.float32).ravel()
    zeros = flat == 0.0
    has_zero = bool(zeros.any())
    vals = flat[~zeros] if has_zero else flat

    uniq = np.unique(vals)
    n_slots = k - 1 if has_zero else k
    if uniq.size <= n_slots:
        cb_nz = uniq.astype(np.float32)
    else:
        cb_nz = _kmeans_1d(vals, n_slots, iters=iters)
    codebook = (np.concatenate([[np.float32(0.0)], cb_nz])
                if has_zero else cb_nz)

    # nearest-centroid codes in one pass: zeros pin to slot 0, nonzeros
    # assign within the nonzero sub-book
    mids = (cb_nz[1:] + cb_nz[:-1]) / 2
    nz_codes = np.searchsorted(mids, flat).astype(np.int64)
    codes = nz_codes + (1 if has_zero else 0)
    if has_zero:
        codes[zeros] = 0
    dtype = np.uint8 if codebook.size <= 256 else np.uint16
    return codes.astype(dtype).reshape(np.shape(w)), codebook


def cluster_network(params: Params, spec: NetworkSpec, bits: int = 6,
                    iters: int = 25) -> CModel:
    """Cluster every conv's ``w`` in HWIO order (codes stored HWIO); the
    other fields pass through as float32 numpy."""
    out: CModel = {}
    for key, entry in params_to_jax(params).items():
        e: Dict[str, np.ndarray] = {}
        for field, v in entry.items():
            if field == "w":
                e["codes"], e["codebook"] = cluster_layer(v, bits,
                                                          iters=iters)
            else:
                e[field] = np.asarray(v, np.float32)
        out[key] = e
    return out


def reconstruct(cmodel: CModel, device="cpu") -> Params:
    """Expand the codebooks back to float32 params (OIHW tensors on
    ``device``), the form every forward consumes."""
    np_params = {}
    for key, e in cmodel.items():
        entry = {f: v for f, v in e.items()
                 if f not in ("codes", "codebook")}
        if "codes" in e:
            entry["w"] = np.asarray(e["codebook"])[
                np.asarray(e["codes"]).astype(np.int64)]
        np_params[key] = entry
    return params_from_jax(np_params, device=device)


def save_cmodel(path: str, cmodel: CModel, spec: NetworkSpec,
                pack: Optional[str] = None) -> None:
    """One ``.npz`` artifact, the JAX package's format key for key
    (``__cfg__``, ``conv<i>/codes`` HWIO, ``conv<i>/codebook``, the
    float32 vectors). ``pack='huffman'`` or ``'fixed'`` entropy-codes each
    code tensor (``compress/packing.py``) into an uncompressed npz, so the
    size on disk is the code's own; unpacked by ``load_cmodel``."""
    from modelcompression_tpu_torch.compress.packing import pack_codes
    flat = {"__cfg__": np.array(dump_cfg(spec))}
    for key, e in cmodel.items():
        for field, v in e.items():
            if pack is not None and field == "codes":
                k = int(np.asarray(e["codebook"]).size)
                for pf, pv in pack_codes(np.asarray(v), k, pack).items():
                    flat[f"{key}/{pf}"] = pv
            else:
                flat[f"{key}/{field}"] = np.asarray(v)
    with open(path, "wb") as f:  # exact path (np would append .npz)
        (np.savez if pack is not None else np.savez_compressed)(f, **flat)


def load_cmodel(path: str, spec: Optional[NetworkSpec] = None
                ) -> Tuple[Params, NetworkSpec]:
    """Load a ``save_cmodel`` artifact (of either package, packed or not)
    and reconstruct its float32 params on the CPU; returns ``(params,
    spec)``. With ``spec`` the embedded architecture must match it
    (``ValueError`` otherwise). The reconstruction is exact: codebook
    gathers round-trip bit for bit through npz, and the entropy codec is
    lossless."""
    from modelcompression_tpu_torch.compress.packing import unpack_codes
    from modelcompression_tpu_torch.compress.quantize import _arch_mismatch
    with np.load(path, allow_pickle=False) as z:
        loaded_spec = parse_cfg(str(z["__cfg__"][()]))
        if spec is not None:
            diff = _arch_mismatch(spec, loaded_spec)
            if diff is not None:
                raise ValueError(
                    f"cmodel {path} was saved for a different "
                    f"architecture: {diff}")
        cmodel: CModel = {}
        for k in z.files:
            if k == "__cfg__":
                continue
            key, field = k.rsplit("/", 1)
            cmodel.setdefault(key, {})[field] = z[k]
    for e in cmodel.values():
        if "payload" in e:
            e["codes"] = unpack_codes(e)
            for pf in PACK_FIELDS:
                e.pop(pf, None)
    return reconstruct(cmodel), (spec if spec is not None else loaded_spec)
