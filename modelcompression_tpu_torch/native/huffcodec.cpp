// Canonical-Huffman bitstream codec: the serial hot path of the packed
// weight-sharing and int8 artifacts (Deep Compression's third stage, Han
// et al. 2016 §5); the PyTorch port's copy of the JAX package's
// native/huffcodec.cpp.
//
// Packing and unpacking run on the host when an artifact is saved or
// loaded; the device always sees reconstructed float32 params. Encoding
// vectorizes in numpy, but canonical Huffman decode is serial per bit
// (each symbol's boundary depends on the one before), so a YOLOv2-size
// artifact (~50M codes) needs native code: this translation unit, built
// with g++ -O3 and loaded through ctypes
// (modelcompression_tpu_torch/native/__init__.py). A pure-Python decoder
// with the same semantics is the reference and the fallback
// (compress/packing.py).
//
// Symbols are codebook indices (< 2^16). Codes are MSB-first within the
// payload byte stream. The canonical code is fully determined by the
// per-symbol length table: symbols sorted by (length, symbol value)
// receive consecutive codes, starting at 0 for the shortest length and
// shifting left at each length increase (RFC 1951 §3.2.2 convention).

#include <cstdint>

extern "C" {

// Decode `n` symbols from `payload` given per-symbol code `lengths`
// (k entries, 0 = symbol unused). Returns 0 on success, -1 on a
// malformed stream (code exceeds every length's range or payload
// exhausted), -2 on bad arguments.
int huff_decode(const uint8_t* payload, int64_t payload_bytes,
                const uint8_t* lengths, int32_t k,
                uint16_t* out, int64_t n) {
    if (k <= 0 || k > 65536 || n < 0) return -2;
    // Build canonical tables: count[len], first_code[len], first_idx[len]
    // and the (length, symbol)-sorted symbol list.
    const int MAXLEN = 64;
    int64_t count[MAXLEN + 1] = {0};
    int max_len = 0;
    for (int32_t s = 0; s < k; ++s) {
        int l = lengths[s];
        if (l > MAXLEN) return -2;
        if (l > 0) {
            ++count[l];
            if (l > max_len) max_len = l;
        }
    }
    if (max_len == 0) return n == 0 ? 0 : -1;

    uint64_t first_code[MAXLEN + 1];
    int64_t first_idx[MAXLEN + 1];
    uint64_t code = 0;
    int64_t idx = 0;
    for (int l = 1; l <= max_len; ++l) {
        code <<= 1;
        first_code[l] = code;
        first_idx[l] = idx;
        code += count[l];
        idx += count[l];
    }
    // symbol list sorted by (length, symbol): stable fill in symbol order
    uint16_t* sym_sorted = new uint16_t[idx];
    int64_t fill[MAXLEN + 1];
    for (int l = 1; l <= max_len; ++l) fill[l] = first_idx[l];
    for (int32_t s = 0; s < k; ++s) {
        int l = lengths[s];
        if (l > 0) sym_sorted[fill[l]++] = (uint16_t)s;
    }

    const int64_t total_bits = payload_bytes * 8;
    int64_t bitpos = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t acc = 0;
        int l = 0;
        for (;;) {
            // l == max_len with no match yet means no longer code can
            // exist — erroring HERE also keeps count[l+1] in bounds
            if (bitpos >= total_bits || l >= max_len) {
                delete[] sym_sorted;
                return -1;
            }
            acc = (acc << 1) |
                  ((payload[bitpos >> 3] >> (7 - (bitpos & 7))) & 1u);
            ++bitpos;
            ++l;
            if (count[l] > 0 && acc - first_code[l] < (uint64_t)count[l]) {
                out[i] = sym_sorted[first_idx[l] + (acc - first_code[l])];
                break;
            }
        }
    }
    delete[] sym_sorted;
    return 0;
}

// Encode `n` symbols into `payload` (caller-sized to at least
// ceil(sum(lengths[sym[i]])/8) bytes, zero-initialised). `sym_code` and
// `sym_len` are the per-symbol canonical tables. Returns the number of
// bits written, or -1 if a symbol has length 0 (unused symbol appears
// in the stream), or -2 on bad arguments.
int64_t huff_encode(const uint16_t* symbols, int64_t n,
                    const uint64_t* sym_code, const uint8_t* sym_len,
                    int32_t k, uint8_t* payload, int64_t payload_bytes) {
    if (k <= 0 || k > 65536 || n < 0) return -2;
    const int64_t total_bits = payload_bytes * 8;
    int64_t bitpos = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint16_t s = symbols[i];
        if (s >= k) return -2;
        int l = sym_len[s];
        if (l == 0) return -1;
        if (bitpos + l > total_bits) return -2;
        uint64_t c = sym_code[s];
        for (int j = l - 1; j >= 0; --j) {
            if ((c >> j) & 1u)
                payload[bitpos >> 3] |= (uint8_t)(1u << (7 - (bitpos & 7)));
            ++bitpos;
        }
    }
    return bitpos;
}

}  // extern "C"
