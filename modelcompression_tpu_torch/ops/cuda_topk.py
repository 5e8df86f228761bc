"""Fused magnitude top-k/mask: the port of
``modelcompression_tpu/ops/pallas_topk.py``.

The name drops "pallas" because Pallas is the TPU's kernel language and
nothing of it is left here: the kernels are hand-written CUDA C++ for
Hopper, built by ``ops/_build.py``. Each segment's threshold is the k-th
smallest |w| bit pattern (the rule of ``ops/topk_mask.py``); ties at it
are pruned lowest index first. Each kernel has three functions:

* ``radix_select_plain`` / ``radix_select_cuda`` / ``radix_select``
  (``csrc/topk_radix_select.cu``): per segment, the k-th smallest bit
  pattern and the count strictly below it, by a radix select over four
  8-bit digits: four histogram passes and one select launch, with the
  digits chosen on the device. The threshold is bit-equal to the 31-round
  bisection's.
* ``tie_counts_plain`` / ``tie_counts_cuda`` / ``tie_counts``
  (``csrc/topk_tie_counts.cu``): the (chunks, S) count of ``bits ==
  tau[s]``.
* ``apply_threshold_plain`` / ``apply_threshold_cuda`` /
  ``apply_threshold`` (``csrc/topk_apply.cu``): the fused mask + apply.

The ``*_plain`` version is plain PyTorch; ``*_cuda`` launches the kernel
through its ``ops/_build.Kernel`` (``RADIX_SELECT``, ``TIE_COUNTS``,
``APPLY``; launches counted by segment count S) or raises; the undecorated
name sends CPU tensors to the plain version and CUDA tensors to the
kernel, never one in place of the other. ``count_le_plain`` is the
31-round bisection's count (``topk_mask.segmented_kth_bits``), the rule the
radix select's threshold equals. ``prune_flat`` drives the select, the
tie count and the apply (the port of ``pallas_prune_flat``);
``magnitude_prune`` and ``magnitude_masks*`` run it on a network's conv
kernels.

The flat layout is the JAX package's: kernels flattened in HWIO order
(``topk_mask.hwio_flat``, so ties break as in the JAX package) and
concatenated, then zero padding to a multiple of ``CHUNK`` as a segment
of its own with nothing to prune. The tie-count and apply kernels take
one CUDA block per chunk; ``prune_flat`` sizes the chunk to the input
(``grid_chunk``), ``CHUNK`` at most. The plain versions take the chunk
as a parameter, so the tests can hold them against the TPU kernels' 128K
chunk.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from modelcompression_tpu_torch.models.cfg import NetworkSpec
from modelcompression_tpu_torch.models.darknet import Params
from modelcompression_tpu_torch.ops._build import Kernel
from modelcompression_tpu_torch.ops.topk_mask import (
    _prunable_keys, abs_bits, count_le_rule, hwio_flat, oihw_from_flat,
)

TILE = 1024  # csrc/topk_tile.cuh: elements a block takes per round
CHUNK = 16 * TILE  # the largest chunk of elements per CUDA block
MAX_SEGMENTS = 2048  # csrc/topk_tile.cuh: per-segment arrays in shared memory
BLOCKS_PER_SM = 4  # what grid_chunk aims for, as the radix select's grid
# the radix select's digits, high to low: bits 24-30, 16-23, 8-15, 0-7
RADIX_SHIFTS = (24, 16, 8, 0)
RADIX_BINS = 256
# each entry's pointers, then n, S and one int (the chunk; the radix
# select's pass)
_SIZES = (ctypes.c_longlong, ctypes.c_int, ctypes.c_int)
RADIX_SELECT = Kernel("topk_radix_select", (ctypes.c_void_p,) * 6 + _SIZES)
TIE_COUNTS = Kernel("topk_tie_counts", (ctypes.c_void_p,) * 4 + _SIZES)
APPLY = Kernel("topk_apply", (ctypes.c_void_p,) * 7 + _SIZES)


# ---- plain versions -------------------------------------------------------

def radix_select_plain(bits: torch.Tensor, seg_ids: torch.Tensor,
                       k: torch.Tensor, n_segments: int):
    """Per segment s, ``(kth[s], n_below[s])``: the k[s]-th smallest bit
    pattern (0-indexed) and the count of ``bits < kth[s]``, both int64
    (S,). Four digit passes: each counts, per segment and digit, the
    elements whose higher digits equal the segment's prefix so far, and
    takes the first digit whose running count passes the rank still to
    find. Where k[s] is past the segment no digit does, and each pass
    takes the top one: kth[s] is then 0x7FFFFFFF, as the bisection's."""
    seg = seg_ids.long()
    b = bits.long()
    dev = bits.device
    rank = k.long().reshape(n_segments).clone()
    prefix = torch.zeros(n_segments, dtype=torch.int64, device=dev)
    n_below = torch.zeros_like(prefix)
    for p, shift in enumerate(RADIX_SHIFTS):
        live = ((b ^ prefix[seg]) >> (shift + 8)) == 0
        digit = (b >> shift) & (RADIX_BINS - 1)
        hist = torch.zeros(n_segments * RADIX_BINS, dtype=torch.int64,
                           device=dev).index_add_(
            0, seg * RADIX_BINS + digit, live.long())
        cum = hist.view(n_segments, RADIX_BINS).cumsum(1)
        top = 127 if p == 0 else RADIX_BINS - 1  # bit 31 is clear
        d = (cum <= rank[:, None]).sum(1).clamp_max(top)
        below = torch.where(
            d > 0, cum.gather(1, (d - 1).clamp_min(0)[:, None])[:, 0], 0)
        prefix |= d << shift
        rank -= below
        n_below += below
    return prefix, n_below


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


def _check_chunk(chunk: int) -> None:
    if not TILE <= chunk <= CHUNK or chunk % TILE:
        raise ValueError(f"chunk must be a multiple of {TILE} in "
                         f"[{TILE}, {CHUNK}], got {chunk}")


def _launch(kernel: Kernel, tensors, n: int, n_segments: int,
            arg: int) -> None:
    """``kernel`` on the tensors' pointers, then n, S and ``arg``, counted
    at S."""
    kernel.launch(n_segments, tensors[0].get_device(),
                  *(t.data_ptr() for t in tensors), n, n_segments, arg)


def radix_select_cuda(bits: torch.Tensor, seg_ids: torch.Tensor,
                      k: torch.Tensor, n_segments: int):
    """Launch ``csrc/topk_radix_select.cu`` 5 times: the four histogram
    passes, then the select. bits, seg_ids: contiguous (N,) int32 on a
    CUDA device, N < 2^31, values in [0, 0x7FFFFFFF], segments contiguous
    ascending blocks; k (S,). Returns ``(kth, n_below)``, int64 (S,)."""
    _check_flat(bits, seg_ids, n_segments)
    n = bits.numel()
    if n > 0x7FFFFFFF:
        raise ValueError(f"radix select takes N < 2^31, got {n}")
    dev = bits.device
    k = _per_segment(k, n_segments, torch.int64, dev, "k")
    hist = torch.zeros((len(RADIX_SHIFTS), n_segments, RADIX_BINS),
                       dtype=torch.int32, device=dev)
    kth = torch.empty(n_segments, dtype=torch.int64, device=dev)
    n_below = torch.empty_like(kth)
    for p in range(len(RADIX_SHIFTS) + 1):
        _launch(RADIX_SELECT, (bits, seg_ids, k, hist, kth, n_below), n,
                n_segments, p)
    return kth, n_below


def tie_counts_cuda(bits: torch.Tensor, seg_ids: torch.Tensor,
                    tau: torch.Tensor, n_segments: int,
                    chunk: int = CHUNK) -> torch.Tensor:
    """Launch ``csrc/topk_tie_counts.cu``, one block per ``chunk``
    elements. Returns int32 (ceil(N / chunk), S)."""
    _check_flat(bits, seg_ids, n_segments)
    _check_chunk(chunk)
    tau = _per_segment(tau, n_segments, torch.int32, bits.device, "tau")
    n_chunks = -(-bits.numel() // chunk)
    out = torch.empty((n_chunks, n_segments), dtype=torch.int32,
                      device=bits.device)
    _launch(TIE_COUNTS, (bits, seg_ids, tau, out), bits.numel(),
            n_segments, chunk)
    return out


def apply_threshold_cuda(w: torch.Tensor, bits: torch.Tensor,
                         seg_ids: torch.Tensor, tau: torch.Tensor,
                         tie_budget: torch.Tensor,
                         seg_tie_start: torch.Tensor,
                         chunk_tie_off: torch.Tensor,
                         chunk: int = CHUNK) -> torch.Tensor:
    """Launch ``csrc/topk_apply.cu``, one block per ``chunk`` elements.
    w: contiguous (N,) float32 on the bits' device; segments contiguous
    ascending blocks; ``chunk_tie_off`` per chunk. Returns float32 (N,)."""
    n_segments = tau.numel()
    _check_flat(bits, seg_ids, n_segments)
    _check_chunk(chunk)
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
    chunk_off = _per_segment(chunk_tie_off, -(-bits.numel() // chunk),
                             torch.int64, dev, "chunk_tie_off")
    out = torch.empty_like(w)
    _launch(APPLY, (w, bits, seg_ids, tau, lim, chunk_off, out),
            bits.numel(), n_segments, chunk)
    return out


# ---- dispatchers --------------------------------------------------------------

def _route(t: torch.Tensor, cuda_fn, plain_fn):
    if t.device.type == "cuda":
        return cuda_fn
    if t.device.type == "cpu":
        return plain_fn
    raise ValueError(f"unsupported device {t.device}")


def radix_select(bits, seg_ids, k, n_segments):
    return _route(bits, radix_select_cuda, radix_select_plain)(
        bits, seg_ids, k, n_segments)


def tie_counts(bits, seg_ids, tau, n_segments, chunk=CHUNK):
    return _route(bits, tie_counts_cuda, tie_counts_plain)(
        bits, seg_ids, tau, n_segments, chunk)


def apply_threshold(w, bits, seg_ids, tau, tie_budget, seg_tie_start,
                    chunk_tie_off, chunk=CHUNK):
    return _route(bits, apply_threshold_cuda, apply_threshold_plain)(
        w, bits, seg_ids, tau, tie_budget, seg_tie_start, chunk_tie_off,
        chunk)


def grid_chunk(n: int, device: torch.device) -> int:
    """The tie-count and apply kernels' chunk for ``n`` elements: the
    largest multiple of ``TILE``, ``CHUNK`` at most, that still gives
    ``BLOCKS_PER_SM`` blocks on every SM of a CUDA device (at 681,408
    elements and 132 SMs, 1024 in place of 16K: 666 blocks, not 42).
    ``CHUNK`` on the CPU, where the chunk only shapes the tie table."""
    if device.type != "cuda":
        return CHUNK
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(TILE, min(CHUNK, n // (sms * BLOCKS_PER_SM) // TILE * TILE))


# ---- the prune ------------------------------------------------------------------

def prune_flat(w_cat: torch.Tensor, seg_ids: torch.Tensor,
               n_zero: torch.Tensor, n_segments: int,
               return_mask: bool = False) -> torch.Tensor:
    """``w_cat`` (N,) with the ``n_zero[s]`` smallest |w| of each segment
    zeroed, ties lowest index first; with ``return_mask`` the same
    decision applied to ones (the keep mask, already-zero weights ranked
    smallest). Segments are contiguous ascending blocks. Launches the
    radix-select kernel 5 times, the tie-count and apply kernels once
    each, and reads nothing back to the host."""
    bits = abs_bits(w_cat)
    nz = n_zero.long().clamp_min(0)
    kth, n_below = radix_select(bits, seg_ids, (nz - 1).clamp_min(0),
                                n_segments)
    # a segment with nothing to prune gets the impossible threshold 0 and
    # no budget
    tau = torch.where(nz > 0, kth, 0)
    # n_below counts bits < kth: 0 where the k-th smallest |w| is 0.0 (as
    # when re-pruning pruned weights), so the whole budget goes to the
    # zeros, lowest index first
    budget = torch.where(nz > 0, nz - n_below, 0)
    chunk = grid_chunk(bits.numel(), bits.device)
    per_chunk = tie_counts(bits, seg_ids, tau, n_segments, chunk).long()
    # ties before each chunk (all segments) and before each segment
    chunk_tot = per_chunk.sum(1)
    chunk_tie_off = torch.cumsum(chunk_tot, 0) - chunk_tot
    seg_tot = per_chunk.sum(0)
    seg_tie_start = torch.cumsum(seg_tot, 0) - seg_tot
    src = torch.ones_like(w_cat) if return_mask else w_cat
    return apply_threshold(src, bits, seg_ids, tau, budget, seg_tie_start,
                           chunk_tie_off, chunk)


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
