"""Entropy-coded artifact packing (Deep Compression's third stage, Han et
al. 2016 §5: prune, share, Huffman), port of
``modelcompression_tpu/compress/packing.py`` (numpy and ctypes, on the
host).

A clustered model's per-layer code tensors are highly skewed (a pruned
layer is mostly the exact-zero slot 0), so canonical Huffman takes them to
within a fraction of a bit of their empirical entropy. The packed format
is byte for byte the JAX package's: the same lengths, codes and payload
for the same symbols, so an artifact packed by either package unpacks in
the other.

Packing is a host codec: the device always consumes the reconstructed
float32 params. Encoding is vectorized numpy (one scatter pass per bit
position) or the native encoder; decoding is serial per bit, so its hot
path is the native C++ codec (``native/huffcodec.cpp``, built by g++ at
first use, loaded with ctypes), and ``_decode_py`` is the pure-Python
reference with the same semantics: the fallback and the tests'
cross-check.

Wire format per packed tensor (inside the ``save_cmodel`` npz, or the
``wq_*`` fields of ``save_qmodel``): ``payload`` (uint8 bitstream,
MSB-first), ``huff_lengths`` ((K,) uint8 canonical code lengths, the
whole code description) or ``fixed_bits`` (scalar, fixed-width packing),
and ``pack_shape``.
"""

from __future__ import annotations

import heapq
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = [
    "huffman_lengths", "canonical_codes", "huffman_encode",
    "huffman_decode", "pack_fixed", "unpack_fixed",
    "pack_codes", "unpack_codes", "packed_bits",
]

_MAXLEN = 64  # decoder hard cap; real lengths are ~<= 45 even adversarially


def huffman_lengths(freqs: np.ndarray) -> np.ndarray:
    """Huffman code lengths for a (K,) frequency vector (0 = unused
    symbol). Deterministic: heap ties break on node id, so identical
    freqs always yield identical lengths."""
    freqs = np.asarray(freqs, np.int64)
    k = freqs.size
    lengths = np.zeros(k, np.uint8)
    used = np.flatnonzero(freqs)
    if used.size == 0:
        return lengths
    if used.size == 1:
        lengths[used[0]] = 1  # degenerate tree still needs 1 bit/symbol
        return lengths
    heap = [(int(freqs[s]), int(s)) for s in used]
    heapq.heapify(heap)
    parent: Dict[int, int] = {}
    next_id = k
    while len(heap) > 1:
        f1, n1 = heapq.heappop(heap)
        f2, n2 = heapq.heappop(heap)
        parent[n1] = parent[n2] = next_id
        heapq.heappush(heap, (f1 + f2, next_id))
        next_id += 1
    for s in used:
        d, x = 0, int(s)
        while x in parent:
            x = parent[x]
            d += 1
        if d > _MAXLEN:
            raise ValueError(f"Huffman code length {d} exceeds {_MAXLEN}")
        lengths[s] = d
    return lengths


def canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Per-symbol canonical codes (RFC 1951 §3.2.2 convention: symbols
    sorted by (length, value) get consecutive codes). (K,) uint64."""
    lengths = np.asarray(lengths, np.uint8)
    k = lengths.size
    codes = np.zeros(k, np.uint64)
    order = [s for s in np.lexsort((np.arange(k), lengths))
             if lengths[s] > 0]
    code = 0
    prev: Optional[int] = None
    for s in order:
        l = int(lengths[s])
        code = 0 if prev is None else (code + 1) << (l - prev)
        codes[s] = code
        prev = l
    return codes


def _ctypes_ptr(a: np.ndarray, ctype):
    import ctypes
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def huffman_encode(symbols: np.ndarray, k: int,
                   lengths: Optional[np.ndarray] = None,
                   force_numpy: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Encode a symbol array (values < k) → (payload uint8, lengths
    uint8). Prefers the native codec (a serial bit-writer); the numpy
    path — one scatter pass per bit position of the longest code — is
    the vectorized reference implementation and fallback."""
    flat = np.ascontiguousarray(symbols, np.uint16).ravel()
    if lengths is None:
        lengths = huffman_lengths(np.bincount(flat, minlength=k))
    if not force_numpy:
        native = huffman_encode_native(symbols, k, lengths)
        if native is not None:
            return native, lengths
    codes = canonical_codes(lengths)
    if flat.size == 0:
        return np.zeros(0, np.uint8), lengths
    l = lengths[flat].astype(np.int64)
    if (l == 0).any():
        raise ValueError("symbol with zero code length in stream")
    c = codes[flat]
    total = int(l.sum())
    off = np.zeros(flat.size, np.int64)
    np.cumsum(l[:-1], out=off[1:])
    bits = np.zeros(total, np.uint8)
    for j in range(int(l.max())):
        m = l > j
        shift = (l[m] - 1 - j).astype(np.uint64)
        bits[off[m] + j] = (np.right_shift(c[m], shift)
                            & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits), lengths


def _decode_py(payload: np.ndarray, lengths: np.ndarray,
               n: int) -> np.ndarray:
    """Pure-Python canonical decoder — the native codec's reference
    semantics (slow; fallback + cross-check only)."""
    lengths = np.asarray(lengths, np.uint8)
    max_len = int(lengths.max(initial=0))
    out = np.empty(n, np.uint16)
    if n == 0:
        return out
    if max_len == 0:
        raise ValueError("empty code, nonempty stream")
    count = np.bincount(lengths, minlength=max_len + 1).astype(np.int64)
    count[0] = 0
    first_code = np.zeros(max_len + 1, np.int64)
    first_idx = np.zeros(max_len + 1, np.int64)
    code = idx = 0
    for l in range(1, max_len + 1):
        code <<= 1
        first_code[l] = code
        first_idx[l] = idx
        code += int(count[l])
        idx += int(count[l])
    order = np.lexsort((np.arange(lengths.size), lengths))
    sym_sorted = np.asarray(
        [s for s in order if lengths[s] > 0], np.uint16)
    bits = np.unpackbits(np.ascontiguousarray(payload, np.uint8))
    pos = 0
    for i in range(n):
        acc = 0
        l = 0
        while True:
            # l == max_len with no match: no longer code exists (also
            # keeps count[l] indexing in bounds below)
            if pos >= bits.size or l >= max_len:
                raise ValueError("malformed Huffman stream")
            acc = (acc << 1) | int(bits[pos])
            pos += 1
            l += 1
            rel = acc - int(first_code[l])
            if count[l] > 0 and 0 <= rel < int(count[l]):
                out[i] = sym_sorted[int(first_idx[l]) + rel]
                break
    return out


def huffman_decode(payload: np.ndarray, lengths: np.ndarray, n: int,
                   force_python: bool = False) -> np.ndarray:
    """Decode n symbols; native C++ when available, else pure Python."""
    import ctypes

    from modelcompression_tpu_torch.native import load_huffcodec
    payload = np.ascontiguousarray(payload, np.uint8)
    lengths = np.ascontiguousarray(lengths, np.uint8)
    lib = None if force_python else load_huffcodec()
    if lib is None:
        return _decode_py(payload, lengths, n)
    out = np.empty(n, np.uint16)
    rc = lib.huff_decode(
        _ctypes_ptr(payload, ctypes.c_uint8), payload.size,
        _ctypes_ptr(lengths, ctypes.c_uint8), lengths.size,
        _ctypes_ptr(out, ctypes.c_uint16), n)
    if rc != 0:
        raise ValueError(f"native huff_decode failed (rc={rc})")
    return out


def huffman_encode_native(symbols: np.ndarray, k: int,
                          lengths: np.ndarray) -> Optional[np.ndarray]:
    """Native encoder (tests cross-check it against the numpy encoder);
    None when the library is unavailable."""
    import ctypes

    from modelcompression_tpu_torch.native import load_huffcodec
    lib = load_huffcodec()
    if lib is None:
        return None
    flat = np.ascontiguousarray(symbols, np.uint16).ravel()
    lengths = np.ascontiguousarray(lengths, np.uint8)
    codes = np.ascontiguousarray(canonical_codes(lengths), np.uint64)
    nbytes = (int(lengths[flat].astype(np.int64).sum()) + 7) // 8
    payload = np.zeros(nbytes, np.uint8)
    nbits = lib.huff_encode(
        _ctypes_ptr(flat, ctypes.c_uint16), flat.size,
        _ctypes_ptr(codes, ctypes.c_uint64),
        _ctypes_ptr(lengths, ctypes.c_uint8), lengths.size,
        _ctypes_ptr(payload, ctypes.c_uint8), nbytes)
    if nbits < 0:
        raise ValueError(f"native huff_encode failed (rc={nbits})")
    return payload


def pack_fixed(codes: np.ndarray, k: int) -> Tuple[np.ndarray, int]:
    """Fixed-width packing to ceil(log2 k) bits/symbol (the no-entropy
    baseline; also the format when Huffman cannot win, e.g. uniform
    codes)."""
    bits = max(1, int(np.ceil(np.log2(max(k, 2)))))
    flat = codes.ravel().astype(">u2")
    b = np.unpackbits(flat.view(np.uint8).reshape(-1, 2),
                      axis=1)[:, 16 - bits:]
    return np.packbits(b.ravel()), bits


def unpack_fixed(payload: np.ndarray, bits: int, n: int) -> np.ndarray:
    b = np.unpackbits(np.ascontiguousarray(payload, np.uint8),
                      count=n * bits).reshape(n, bits)
    w = (1 << np.arange(bits - 1, -1, -1, dtype=np.uint32))
    return (b.astype(np.uint32) * w).sum(axis=1).astype(np.uint16)


def pack_codes(codes: np.ndarray, k: int,
               method: str = "huffman") -> Dict[str, np.ndarray]:
    """Pack one code tensor → wire-format fields (see module doc).
    ``method='huffman'`` falls back to fixed-width for the rare layer
    where the entropy code is larger (near-uniform symbols)."""
    fields: Dict[str, np.ndarray] = {
        "pack_shape": np.asarray(codes.shape, np.int64)}
    if method not in ("huffman", "fixed"):
        raise ValueError(f"unknown pack method {method!r}")
    if method == "huffman":
        payload, lengths = huffman_encode(codes, k)
        fpayload, fbits = pack_fixed(codes, k)
        # compare TOTAL stored size: huffman carries a (K,) length table,
        # fixed an 8-byte scalar — for tiny tensors with big codebooks
        # the table can outweigh the payload saving
        if payload.size + lengths.size <= fpayload.size + 8:
            fields["payload"] = payload
            fields["huff_lengths"] = lengths
            return fields
        payload, bits = fpayload, fbits
    else:
        payload, bits = pack_fixed(codes, k)
    fields["payload"] = payload
    fields["fixed_bits"] = np.asarray(bits, np.int64)
    return fields


def unpack_codes(fields: Dict[str, np.ndarray]) -> np.ndarray:
    """Inverse of pack_codes: wire fields → code tensor (uint16)."""
    shape = tuple(int(d) for d in np.asarray(fields["pack_shape"]))
    n = int(np.prod(shape)) if shape else 1
    if "huff_lengths" in fields:
        flat = huffman_decode(fields["payload"], fields["huff_lengths"], n)
    else:
        flat = unpack_fixed(fields["payload"],
                            int(fields["fixed_bits"]), n)
    return flat.reshape(shape)


def packed_bits(fields: Dict[str, np.ndarray]) -> int:
    """Payload size in bits (for bits/weight reporting)."""
    return int(np.asarray(fields["payload"]).size) * 8
