"""Fused magnitude top-k/mask: the port of
``modelcompression_tpu/ops/pallas_topk.py``.

The name drops "pallas" because Pallas is the TPU's kernel language and
nothing of it is left here: the three kernels are hand-written CUDA C++
for Hopper, built by ``ops/_build.py``. The threshold is found by the
segmented bisection over |w| bit patterns of ``ops/topk_mask.py``; ties
at it are pruned lowest index first. Each kernel has three functions:

* ``count_le_plain`` / ``count_le_cuda`` / ``count_le``
  (``csrc/topk_count_le.cu``): per segment, the count of ``bits <=
  mid[s]``. 31 bisection rounds and one ``n_below`` count per prune.
* ``tie_counts_plain`` / ``tie_counts_cuda`` / ``tie_counts``
  (``csrc/topk_tie_counts.cu``): the (chunks, S) count of ``bits ==
  tau[s]``.
* ``apply_threshold_plain`` / ``apply_threshold_cuda`` /
  ``apply_threshold`` (``csrc/topk_apply.cu``): the fused mask + apply.

The ``*_plain`` version is plain PyTorch; ``*_cuda`` launches the kernel
or raises, and counts its launches in ``LAUNCHES`` (and by segment
count S in ``LAUNCHES_AT``); the undecorated name
sends CPU tensors to the plain version and CUDA tensors to the kernel,
never one in place of the other. ``prune_flat`` drives the three (the
port of ``pallas_prune_flat``); ``magnitude_prune`` and
``magnitude_masks*`` run it on a network's conv kernels.

The flat layout is the JAX package's: kernels flattened in HWIO order
(``topk_mask.hwio_flat``, so ties break as in the JAX package) and
concatenated, then zero padding to a multiple of ``CHUNK`` as a segment
of its own with nothing to prune. ``CHUNK`` is the port's tile, one CUDA
block each; the plain versions take the chunk as a parameter, so the
tests can hold them against the TPU kernels' 128K chunk.
"""

from __future__ import annotations

import collections
import ctypes
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from modelcompression_tpu_torch.models.cfg import NetworkSpec
from modelcompression_tpu_torch.models.darknet import Params
from modelcompression_tpu_torch.ops.topk_mask import (
    _prunable_keys, abs_bits, count_le_rule, hwio_flat, oihw_from_flat,
    segmented_kth_bits,
)

CHUNK = 16 * 1024  # elements per CUDA block: 16 rounds of 1024
MAX_SEGMENTS = 2048  # csrc/topk_tile.cuh: per-segment arrays in shared memory


# ---- plain versions -------------------------------------------------------

def count_le_plain(bits: torch.Tensor, seg_ids: torch.Tensor,
                   mid: torch.Tensor, n_segments: int) -> torch.Tensor:
    """Per segment s, #{i : seg_ids[i] == s, bits[i] <= mid[s]}, int64
    (S,)."""
    return count_le_rule(bits, seg_ids, mid, n_segments)


def tie_counts_plain(bits: torch.Tensor, seg_ids: torch.Tensor,
                     tau: torch.Tensor, n_segments: int,
                     chunk: int = CHUNK) -> torch.Tensor:
    """``out[c, s]`` = #{i in chunk c : seg_ids[i] == s, bits[i] ==
    tau[s]}, int32 (ceil(N / chunk), S); the last chunk may be ragged."""
    n = bits.numel()
    n_chunks = -(-n // chunk)
    seg = seg_ids.long()
    at = bits.long() == tau.long()[seg]
    cell = torch.arange(n, device=bits.device) // chunk * n_segments + seg
    out = torch.zeros(n_chunks * n_segments, dtype=torch.int64,
                      device=bits.device).index_add_(0, cell, at.long())
    return out.view(n_chunks, n_segments).to(torch.int32)


def apply_threshold_plain(w: torch.Tensor, bits: torch.Tensor,
                          seg_ids: torch.Tensor, tau: torch.Tensor,
                          tie_budget: torch.Tensor,
                          seg_tie_start: torch.Tensor,
                          chunk_tie_off: torch.Tensor,
                          chunk: int = CHUNK) -> torch.Tensor:
    """``w`` with 0 where ``bits < tau[s]``, or where ``bits == tau[s]``
    and the tie rank is ``<= tie_budget[s]``. The tie rank is the
    inclusive count of ties in the element's chunk up to it, plus
    ``chunk_tie_off[chunk]`` (ties before the chunk, all segments), minus
    ``seg_tie_start[s]`` (ties before the segment)."""
    n = w.numel()
    n_chunks = -(-n // chunk)
    seg = seg_ids.long()
    b = bits.long()
    tau_e = tau.long()[seg]
    at = b == tau_e
    in_chunk = F.pad(at.long(), (0, n_chunks * chunk - n)) \
        .view(n_chunks, chunk).cumsum(1).view(-1)[:n]
    chunk_of = torch.arange(n, device=w.device) // chunk
    rank = in_chunk + chunk_tie_off.long()[chunk_of] \
        - seg_tie_start.long()[seg]
    zero = (b < tau_e) | (at & (rank <= tie_budget.long()[seg]))
    return w.masked_fill(zero, 0)


# ---- CUDA kernels -----------------------------------------------------------

def _check_flat(bits: torch.Tensor, seg_ids: torch.Tensor,
                n_segments: int) -> None:
    if bits.device.type != "cuda":
        raise ValueError(f"top-k kernels need CUDA tensors, got "
                         f"{bits.device}")
    for name, t in (("bits", bits), ("seg_ids", seg_ids)):
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous (N,) int32 "
                             f"tensor, got {t.dtype} {tuple(t.shape)}")
        if t.device != bits.device:
            raise ValueError(f"{name} is on {t.device}, bits on "
                             f"{bits.device}")
    if seg_ids.numel() != bits.numel() or bits.numel() == 0:
        raise ValueError(f"bits ({bits.numel()}) and seg_ids "
                         f"({seg_ids.numel()}) must have one nonzero length")
    if not 1 <= n_segments <= MAX_SEGMENTS:
        raise ValueError(f"n_segments must be in [1, {MAX_SEGMENTS}], got "
                         f"{n_segments}")


def _per_segment(v: torch.Tensor, n: int, dtype, device,
                 name: str) -> torch.Tensor:
    if v.numel() != n:
        raise ValueError(f"{name} must have {n} entries, got "
                         f"{tuple(v.shape)}")
    return v.reshape(n).to(device=device, dtype=dtype).contiguous()


def _launch(source: str, tensors, n: int, n_segments: int) -> None:
    """Call ``mc_<source>`` of ``csrc/<source>.cu`` on PyTorch's current
    stream: the tensors' pointers, then n, S and the chunk."""
    from modelcompression_tpu_torch.ops import _build
    fn = getattr(_build.load(source), f"mc_{source}")
    # pointers and the stream as c_void_p: ctypes would pass a bare Python
    # int as a 32-bit int and cut the pointer
    fn.argtypes = [ctypes.c_void_p] * len(tensors) + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(tensors[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), n, n_segments, CHUNK,
                 stream)
    if err != 0:
        raise RuntimeError(f"{source} kernel launch failed: CUDA error {err}")


def count_le_cuda(bits: torch.Tensor, seg_ids: torch.Tensor,
                  mid: torch.Tensor, n_segments: int) -> torch.Tensor:
    """Launch ``csrc/topk_count_le.cu``. bits, seg_ids: contiguous (N,)
    int32 on a CUDA device; mid (S,) with values in [0, 0x7FFFFFFF].
    Returns int64 (S,)."""
    _check_flat(bits, seg_ids, n_segments)
    mid = _per_segment(mid, n_segments, torch.int32, bits.device, "mid")
    out = torch.zeros(n_segments, dtype=torch.int64, device=bits.device)
    _launch("topk_count_le", (bits, seg_ids, mid, out), bits.numel(),
            n_segments)
    count_le_cuda.LAUNCHES += 1
    count_le_cuda.LAUNCHES_AT[n_segments] += 1
    return out


count_le_cuda.LAUNCHES = 0
count_le_cuda.LAUNCHES_AT = collections.Counter()  # by S


def tie_counts_cuda(bits: torch.Tensor, seg_ids: torch.Tensor,
                    tau: torch.Tensor, n_segments: int) -> torch.Tensor:
    """Launch ``csrc/topk_tie_counts.cu``. Returns int32
    (ceil(N / CHUNK), S)."""
    _check_flat(bits, seg_ids, n_segments)
    tau = _per_segment(tau, n_segments, torch.int32, bits.device, "tau")
    n_chunks = -(-bits.numel() // CHUNK)
    out = torch.empty((n_chunks, n_segments), dtype=torch.int32,
                      device=bits.device)
    _launch("topk_tie_counts", (bits, seg_ids, tau, out), bits.numel(),
            n_segments)
    tie_counts_cuda.LAUNCHES += 1
    tie_counts_cuda.LAUNCHES_AT[n_segments] += 1
    return out


tie_counts_cuda.LAUNCHES = 0
tie_counts_cuda.LAUNCHES_AT = collections.Counter()  # by S


def apply_threshold_cuda(w: torch.Tensor, bits: torch.Tensor,
                         seg_ids: torch.Tensor, tau: torch.Tensor,
                         tie_budget: torch.Tensor,
                         seg_tie_start: torch.Tensor,
                         chunk_tie_off: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/topk_apply.cu``. w: contiguous (N,) float32 on the
    bits' device; segments contiguous ascending blocks; ``chunk_tie_off``
    per ``CHUNK``. Returns float32 (N,)."""
    n_segments = tau.numel()
    _check_flat(bits, seg_ids, n_segments)
    if (w.dtype != torch.float32 or w.shape != bits.shape
            or w.device != bits.device or not w.is_contiguous()):
        raise ValueError(f"w must be a contiguous float32 tensor shaped as "
                         f"bits {tuple(bits.shape)}, got {w.dtype} "
                         f"{tuple(w.shape)} on {w.device}")
    dev = bits.device
    tau = _per_segment(tau, n_segments, torch.int32, dev, "tau")
    lim = (_per_segment(seg_tie_start, n_segments, torch.int64, dev,
                        "seg_tie_start")
           + _per_segment(tie_budget, n_segments, torch.int64, dev,
                          "tie_budget"))
    chunk_off = _per_segment(chunk_tie_off, -(-bits.numel() // CHUNK),
                             torch.int64, dev, "chunk_tie_off")
    out = torch.empty_like(w)
    _launch("topk_apply", (w, bits, seg_ids, tau, lim, chunk_off, out),
            bits.numel(), n_segments)
    apply_threshold_cuda.LAUNCHES += 1
    apply_threshold_cuda.LAUNCHES_AT[n_segments] += 1
    return out


apply_threshold_cuda.LAUNCHES = 0
apply_threshold_cuda.LAUNCHES_AT = collections.Counter()  # by S


# ---- dispatchers --------------------------------------------------------------

def _route(t: torch.Tensor, cuda_fn, plain_fn):
    if t.device.type == "cuda":
        return cuda_fn
    if t.device.type == "cpu":
        return plain_fn
    raise ValueError(f"unsupported device {t.device}")


def count_le(bits, seg_ids, mid, n_segments):
    return _route(bits, count_le_cuda, count_le_plain)(
        bits, seg_ids, mid, n_segments)


def tie_counts(bits, seg_ids, tau, n_segments):
    return _route(bits, tie_counts_cuda, tie_counts_plain)(
        bits, seg_ids, tau, n_segments)


def apply_threshold(w, bits, seg_ids, tau, tie_budget, seg_tie_start,
                    chunk_tie_off):
    return _route(bits, apply_threshold_cuda, apply_threshold_plain)(
        w, bits, seg_ids, tau, tie_budget, seg_tie_start, chunk_tie_off)


# ---- the prune ------------------------------------------------------------------

def prune_flat(w_cat: torch.Tensor, seg_ids: torch.Tensor,
               n_zero: torch.Tensor, n_segments: int,
               return_mask: bool = False) -> torch.Tensor:
    """``w_cat`` (N,) with the ``n_zero[s]`` smallest |w| of each segment
    zeroed, ties lowest index first; with ``return_mask`` the same
    decision applied to ones (the keep mask, already-zero weights ranked
    smallest). Segments are contiguous ascending blocks. Launches the
    count kernel 32 times, the tie-count and apply kernels once each, and
    reads nothing back to the host."""
    bits = abs_bits(w_cat)
    nz = n_zero.long().clamp_min(0)
    kth = segmented_kth_bits(bits, seg_ids, (nz - 1).clamp_min(0),
                             n_segments, count_le=count_le)
    # a segment with nothing to prune gets the impossible threshold 0 and
    # no budget
    tau = torch.where(nz > 0, kth, 0)
    # n_below must be count(bits < tau); the kernel counts <=, so count
    # <= tau - 1, except for tau == 0 (the k-th smallest |w| is 0.0, as
    # when re-pruning pruned weights): nothing is below 0, and counting
    # <= 0 would spend the whole tie budget on the zeros and prune nothing
    n_below = count_le(bits, seg_ids, torch.where(tau > 0, tau - 1, 0),
                       n_segments)
    n_below = torch.where((nz > 0) & (tau > 0), n_below, 0)
    budget = torch.where(nz > 0, nz - n_below, 0)
    per_chunk = tie_counts(bits, seg_ids, tau, n_segments).long()
    # ties before each chunk (all segments) and before each segment
    chunk_tot = per_chunk.sum(1)
    chunk_tie_off = torch.cumsum(chunk_tot, 0) - chunk_tot
    seg_tot = per_chunk.sum(0)
    seg_tie_start = torch.cumsum(seg_tot, 0) - seg_tot
    src = torch.ones_like(w_cat) if return_mask else w_cat
    return apply_threshold(src, bits, seg_ids, tau, budget, seg_tie_start,
                           chunk_tie_off)


def _layout(params: Params, keys):
    if not keys:
        raise ValueError("nothing to prune: every conv layer is skipped")
    flats = [hwio_flat(params[k]["w"]).float() for k in keys]
    sizes = [int(f.numel()) for f in flats]
    total = sum(sizes)
    padded = -(-total // CHUNK) * CHUNK
    cat = torch.cat(flats + [flats[0].new_zeros(padded - total)])
    return cat, sizes, total, padded


def _seg_ids_for(sizes, padded: int, per_layer: bool, n_pad_segment: int,
                 device) -> torch.Tensor:
    # one fill per segment: torch.repeat_interleave spends 4.7 ms (24
    # segments) to 7.5 ms (2) on the card on this, one thread a segment
    total = sum(sizes)
    counts = (list(sizes) if per_layer else [total]) + [padded - total]
    ids = torch.empty(padded, dtype=torch.int32, device=device)
    off = 0
    for i, c in enumerate(counts):
        ids[off:off + c] = n_pad_segment if i == len(counts) - 1 else i
        off += c
    return ids


def _prune_layout(params: Params, spec: NetworkSpec, sparsity: float,
                  per_layer: bool, skip: Sequence[int]):
    keys = _prunable_keys(spec, skip)
    cat, sizes, total, padded = _layout(params, keys)
    n_real_segments = len(keys) if per_layer else 1
    n_segments = n_real_segments + 1  # + the padding segment
    seg_ids = _seg_ids_for(sizes, padded, per_layer, n_real_segments,
                           cat.device)
    counts = sizes if per_layer else [total]
    n_zero = torch.tensor([int(sparsity * s) for s in counts] + [0],
                          dtype=torch.int64, device=cat.device)
    return keys, cat, sizes, seg_ids, n_zero, n_segments


def _unflatten(params: Params, keys, sizes, flat: torch.Tensor):
    return {k: oihw_from_flat(part, params[k]["w"].shape)
            for k, part in zip(keys, torch.split(flat[:sum(sizes)], sizes))}


def magnitude_prune(params: Params, spec: NetworkSpec, sparsity: float,
                    per_layer: bool = True,
                    skip: Sequence[int] = ()) -> Params:
    """New params with the pruned weights (per-layer or global magnitude
    at ``sparsity``) on the params' device; other entries are shared."""
    keys, cat, sizes, seg_ids, n_zero, n_segments = _prune_layout(
        params, spec, sparsity, per_layer, skip)
    pruned = _unflatten(params, keys, sizes,
                        prune_flat(cat, seg_ids, n_zero, n_segments))
    out = dict(params)
    for k, w in pruned.items():
        out[k] = dict(params[k], w=w)
    return out


def magnitude_masks(params: Params, spec: NetworkSpec, sparsity: float,
                    per_layer: bool = True,
                    skip: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    """Bool OIHW keep-masks from the rank rule, equal to
    ``compress.criteria.magnitude_masks_*``: already-zero weights rank
    smallest and are pruned first, so re-pruning at a higher sparsity
    reports the true achieved sparsity."""
    keys, cat, sizes, seg_ids, n_zero, n_segments = _prune_layout(
        params, spec, sparsity, per_layer, skip)
    mask_flat = prune_flat(cat, seg_ids, n_zero, n_segments,
                           return_mask=True) != 0
    return _unflatten(params, keys, sizes, mask_flat)


def magnitude_masks_perlayer(params: Params, spec: NetworkSpec,
                             sparsity: float, skip: Sequence[int] = ()):
    return magnitude_masks(params, spec, sparsity, per_layer=True, skip=skip)


def magnitude_masks_global(params: Params, spec: NetworkSpec,
                           sparsity: float, skip: Sequence[int] = ()):
    return magnitude_masks(params, spec, sparsity, per_layer=False,
                           skip=skip)
