// Per-segment k-th smallest |w| bit pattern by radix select, for Hopper
// (sm_90a). For each segment s and its k[s] (0-indexed):
//
//   kth[s]     = the k[s]-th smallest bit pattern of segment s
//   n_below[s] = #{i in s : bits[i] < kth[s]}
//
// Where k[s] >= the segment's size (an empty padding segment), no digit
// holds the k-th element and every pass takes the top digit, so kth[s] is
// 0x7FFFFFFF, as the 31-round bisection gives there.
//
// Replaces the TPU kernel modelcompression_tpu/ops/pallas_topk.py::
// _count_le_kernel (launched by pallas_count_le) on the prune's path: the
// TPU finds the threshold in 31 bisection rounds of that count and one
// more count for n_below. Here the 31 bits of a pattern are 4 digits (bits
// 24-30, 16-23, 8-15, 0-7) and the threshold takes 4 histogram passes and
// one select launch: pass p counts, per segment and digit p, the elements
// whose higher digits equal the segment's prefix so far. The digit that
// holds the k-th element and the count below it are chosen on the device,
// so nothing reads back to the host and no eager op runs between passes.
// n_below is the sum of the counts below the chosen digits.
//
// What bounds it on an H100 SXM: each pass reads bits and seg once, 8
// bytes an element (YOLOv2-VOC: 50.6M elements, ~405 MB, ~0.121 ms at 3.35
// TB/s), and does a few integer operations an element. It is bound by
// bytes: 4 passes in place of the bisection's 32.
//
// Design:
// * The grid is a few blocks per SM over all SMs; each block takes one
//   contiguous range of whole 1024-element tiles (topk_tile.cuh's loads),
//   so its segments are one contiguous id range (segments are contiguous
//   ascending blocks; elements of a segment outside the block's first and
//   last id are not counted).
// * Each block's prologue derives, for every segment of its range, the
//   prefix chosen by the earlier passes: one warp per segment scans the
//   256 bins of each earlier pass's histogram row (8 bins a lane and a
//   warp scan) and picks the first bin whose running count exceeds the
//   remaining k.
// * Counts go to a shared histogram per local segment (SLOTS of them); a
//   range with more segments sends the rest straight to global atomics.
//   Most |w| share a few exponents, so pass 0 puts nearly every element
//   into ~6 bins, and re-pruning puts every zero into bin 0 in every
//   pass: each warp first groups its lanes by (segment, digit) with
//   __match_any_sync, and one lane adds the group's size. At the end a
//   block adds its nonzero bins to the (4, S, 256) histogram with one
//   global atomic each. Integer atomics are exact in any order.

#include <algorithm>

#include "on_device.cuh"
#include "topk_tile.cuh"

namespace {

using namespace topk;

constexpr int BINS = 256;
constexpr int PASSES = 4;
constexpr int SLOTS = 32;  // shared histograms per block: 32 KB
constexpr int WARPS = THREADS / 32;
constexpr int BLOCKS_PER_SM = 4;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int pass_shift(int p) { return 24 - 8 * p; }

struct Selected {
  unsigned prefix;   // the digits chosen so far, in place
  long long k;       // the rank still to find among the prefix's elements
  long long below;   // elements below the prefix
};

// The digits of segment s chosen by passes 0..passes-1, from their
// histograms. Called by a whole warp; every lane gets the result.
__device__ Selected select_digits(const int* __restrict__ hist, long long k,
                                  int S, int s, int passes, int lane) {
  Selected r{0u, k, 0};
  for (int q = 0; q < passes; ++q) {
    const int* row = hist + ((size_t)q * S + s) * BINS + lane * 8;
    const int4 a = __ldg(reinterpret_cast<const int4*>(row));
    const int4 b = __ldg(reinterpret_cast<const int4*>(row + 4));
    const int c[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    int local = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) local += c[j];
    int incl = local;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += t;
    }
    const unsigned hit = __ballot_sync(FULL, incl > r.k);
    int digit;
    long long below;
    if (hit) {  // the first lane whose bins pass k holds the digit
      const int owner = __ffs(hit) - 1;
      int d = 0;
      long long run = incl - local;
      if (lane == owner) {
        int j = 0;
        for (; j < 7 && run + c[j] <= r.k; ++j) run += c[j];
        d = owner * 8 + j;
      }
      digit = __shfl_sync(FULL, d, owner);
      below = __shfl_sync(FULL, run, owner);
    } else {  // k is past the segment: the top digit, as the bisection
      digit = q == 0 ? 127 : 255;  // bit 31 is clear: pass 0 has 128 bins
      const int owner = digit >> 3;
      below = __shfl_sync(FULL, (long long)(incl - c[7]), owner);
    }
    r.prefix |= (unsigned)digit << pass_shift(q);
    r.k -= below;
    r.below += below;
  }
  return r;
}

__global__ void __launch_bounds__(THREADS)
radix_pass_kernel(const int* __restrict__ bits, const int* __restrict__ seg,
                  const long long* __restrict__ k, int* hist, long long n,
                  int S, int pass, int tiles_per_block, bool vec) {
  __shared__ unsigned s_hist[SLOTS * BINS];
  __shared__ unsigned s_prefix[MAX_SEGMENTS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long start = (long long)blockIdx.x * tiles_per_block * TILE;
  const long long end = min(start + (long long)tiles_per_block * TILE, n);
  if (start >= end) return;
  const int s_lo = max(__ldg(seg + start), 0);
  const int R = max(min(__ldg(seg + end - 1), S - 1) - s_lo + 1, 0);
  const int slots = min(R, SLOTS);
  for (int i = tid; i < slots * BINS; i += THREADS) s_hist[i] = 0;
  if (pass > 0)
    for (int r = warp; r < R; r += WARPS) {
      const Selected x = select_digits(hist, k[s_lo + r], S, s_lo + r, pass,
                                       lane);
      if (lane == 0) s_prefix[r] = x.prefix;
    }
  __syncthreads();

  const int shift = pass_shift(pass);
  // the higher digits, fixed by the earlier passes
  const unsigned hi_mask = pass == 0 ? 0u : FULL << (shift + 8);
  int* out = hist + (size_t)pass * S * BINS;
  for (long long base = start; base < end; base += TILE) {
    const long long i0 = base + ITEMS * tid;
    int b[ITEMS], g[ITEMS];
    load_items(bits, i0, end, vec, b);
    load_items(seg, i0, end, vec, g);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int r = g[j] - s_lo;
      bool ok = i0 + j < end && (unsigned)r < (unsigned)R;
      if (ok && pass > 0)
        ok = (((unsigned)b[j] ^ s_prefix[r]) & hi_mask) == 0;
      if (!__ballot_sync(FULL, ok)) continue;
      const int digit = (b[j] >> shift) & (BINS - 1);
      const int key = ok ? r * BINS + digit : -1;
      const unsigned peers = __match_any_sync(FULL, key);
      if (ok && lane == __ffs(peers) - 1) {
        const int cnt = __popc(peers);
        if (r < SLOTS)
          atomicAdd(&s_hist[key], (unsigned)cnt);
        else
          atomicAdd(&out[(size_t)(s_lo + r) * BINS + digit], cnt);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < slots * BINS; i += THREADS) {
    const unsigned v = s_hist[i];
    if (v) atomicAdd(&out[(size_t)s_lo * BINS + i], (int)v);
  }
}

__global__ void __launch_bounds__(THREADS)
radix_final_kernel(const int* __restrict__ hist,
                   const long long* __restrict__ k, long long* kth,
                   long long* n_below, int S) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (s >= S) return;  // whole warps
  const Selected x = select_digits(hist, k[s], S, s, PASSES, lane);
  if (lane == 0) {
    kth[s] = x.prefix;
    n_below[s] = x.below;
  }
}

}  // namespace

// Plain C entry for ctypes: one launch of the select, `pass` 0..3 a
// histogram pass, 4 the launch that writes kth and n_below. bits, seg:
// int32 (n,), n < 2^31, segments contiguous ascending blocks; k: int64
// (S,); hist: int32 (4, S, 256), zeroed by the caller before pass 0 (the
// passes add to it); kth, n_below: int64 (S,), written by pass 4; device:
// the CUDA device that holds the tensors (on_device.cuh). Launches on
// `stream` and returns cudaGetLastError() after the launch (0 =
// cudaSuccess).
extern "C" int mc_topk_radix_select(const void* bits, const void* seg,
                                    const void* k, void* hist, void* kth,
                                    void* n_below, long long n, int S,
                                    int pass, int device, void* stream) {
  if (n < 1 || n > 0x7FFFFFFFLL || S < 1 || S > MAX_SEGMENTS || pass < 0 ||
      pass > PASSES)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    if (pass == PASSES) {
      radix_final_kernel<<<(S + WARPS - 1) / WARPS, THREADS, 0, st>>>(
          static_cast<const int*>(hist), static_cast<const long long*>(k),
          static_cast<long long*>(kth), static_cast<long long*>(n_below), S);
      return (int)cudaGetLastError();
    }
    int sms = 0;
    const cudaError_t err = cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const long long tiles = (n + TILE - 1) / TILE;
    const long long want = std::max(1LL, (long long)sms * BLOCKS_PER_SM);
    const long long per_block = (tiles + std::min(tiles, want) - 1) /
                                std::min(tiles, want);
    const unsigned grid = (unsigned)((tiles + per_block - 1) / per_block);
    const bool vec = aligned16(bits) && aligned16(seg);
    radix_pass_kernel<<<grid, THREADS, 0, st>>>(
        static_cast<const int*>(bits), static_cast<const int*>(seg),
        static_cast<const long long*>(k), static_cast<int*>(hist), n, S,
        pass, (int)per_block, vec);
    return (int)cudaGetLastError();
  });
}
