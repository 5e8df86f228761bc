// Fused magnitude mask + apply for Hopper (sm_90a). For every element i of
// segment s = seg[i]:
//
//   out[i] = 0     if bits[i] < tau[s], or bits[i] == tau[s] and its tie
//                  rank is <= budget[s]
//   out[i] = w[i]  otherwise
//
// where the tie rank is the 1-based position of i among the ties (elements
// with bits == tau of their own segment) in flat order, counted within its
// segment. With w all ones the output is the keep mask.
//
// Replaces the TPU kernel modelcompression_tpu/ops/pallas_topk.py::
// _apply_kernel (launched by pallas_apply_threshold). The magnitude prune
// runs it once.
//
// What bounds it on an H100 SXM: it reads w, bits and seg and writes out,
// 16 bytes an element (YOLOv2-VOC: ~810 MB, ~0.242 ms at 3.35 TB/s). It is
// bound by bytes.
//
// Design: segments are contiguous blocks in flat order, so a tie's rank in
// its segment is (ties before its chunk, all segments) + (ties before it in
// the chunk, inclusive) - (ties before its segment). The first and last
// terms come from the tie-count kernel's table, summed outside (chunk_off,
// and lim = ties before the segment + budget). The TPU kernel built the
// in-chunk term from log-step lane rolls over a (rows, 128) block; here a
// block walks its chunk in rounds of 1024 elements, each thread holding 4
// consecutive ones, and a CUB block scan of the per-thread tie counts gives
// each thread its offset in the round; a running total carries the offset
// from round to round. The comparison is rank <= lim in int64. Segment ids
// outside [0, S) leave w unchanged.

#include <cub/block/block_scan.cuh>

#include "on_device.cuh"
#include "topk_tile.cuh"

namespace {

using namespace topk;

__global__ void __launch_bounds__(THREADS)
apply_kernel(const float* __restrict__ w, const int* __restrict__ bits,
             const int* __restrict__ seg, const int* __restrict__ tau,
             const long long* __restrict__ lim,
             const long long* __restrict__ chunk_off, float* __restrict__ out,
             long long n, int S, int chunk, bool vec) {
  using BlockScan = cub::BlockScan<int, THREADS>;
  __shared__ typename BlockScan::TempStorage scan;
  extern __shared__ long long smem[];
  long long* s_lim = smem;
  int* s_tau = reinterpret_cast<int*>(smem + S);
  const int tid = threadIdx.x;
  for (int s = tid; s < S; s += THREADS) {
    s_lim[s] = lim[s];
    s_tau[s] = tau[s];
  }
  __syncthreads();

  const long long start = (long long)blockIdx.x * chunk;
  const long long end = min(start + chunk, n);
  long long carry = chunk_off[blockIdx.x];  // ties before this round
  for (long long base = start; base < end; base += TILE) {
    const long long i0 = base + ITEMS * tid;
    float x[ITEMS];
    int b[ITEMS], g[ITEMS];
    load_items(w, i0, end, vec, x);
    load_items(bits, i0, end, vec, b);
    load_items(seg, i0, end, vec, g);
    bool ok[ITEMS], at[ITEMS];
    int ties = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      ok[j] = i0 + j < end && (unsigned)g[j] < (unsigned)S;
      at[j] = ok[j] && b[j] == s_tau[g[j]];
      ties += at[j];
    }
    int before, round_total;
    BlockScan(scan).ExclusiveSum(ties, before, round_total);
    __syncthreads();  // the scan's storage is reused next round
    long long rank = carry + before;
    float o[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      rank += at[j];  // inclusive rank of element j among all ties
      const bool zero = ok[j] && (b[j] < s_tau[g[j]] ||
                                  (at[j] && rank <= s_lim[g[j]]));
      o[j] = zero ? 0.f : x[j];
    }
    store_items(out, i0, end, vec, o);
    carry += round_total;
  }
}

}  // namespace

// Plain C entry for ctypes. w, out: float32 (n,); bits, seg: int32 (n,);
// tau: int32 (S,); lim: int64 (S,), the ties before each segment plus its
// budget; chunk_off: int64 (ceil(n / chunk),), the ties before each chunk.
// Segments must be contiguous ascending blocks. One block per `chunk`
// elements (a multiple of 1024); device: the CUDA device that holds the
// tensors (on_device.cuh). Launches on `stream` and returns
// cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int mc_topk_apply(const void* w, const void* bits, const void* seg,
                             const void* tau, const void* lim,
                             const void* chunk_off, void* out, long long n,
                             int S, int chunk, int device, void* stream) {
  const int bad = check_shape(n, S, chunk);
  if (bad) return bad;
  const bool vec = aligned16(w) && aligned16(bits) && aligned16(seg) &&
                   aligned16(out);
  const unsigned grid = (unsigned)((n + chunk - 1) / chunk);
  const size_t shmem = (size_t)S * (sizeof(long long) + sizeof(int));
  return on_device(device, [&] {
    apply_kernel<<<grid, THREADS, shmem,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(w), static_cast<const int*>(bits),
        static_cast<const int*>(seg), static_cast<const int*>(tau),
        static_cast<const long long*>(lim),
        static_cast<const long long*>(chunk_off), static_cast<float*>(out),
        n, S, chunk, vec);
    return (int)cudaGetLastError();
  });
}
