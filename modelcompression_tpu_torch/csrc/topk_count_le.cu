// Per-segment count of |w| bit patterns at or below a pivot, for Hopper
// (sm_90a): out[s] += #{i : seg[i] == s and bits[i] <= mid[s]}.
//
// Replaces the TPU kernel modelcompression_tpu/ops/pallas_topk.py::
// _count_le_kernel (launched by pallas_count_le). The magnitude prune runs
// it 32 times: 31 bisection rounds for each segment's k-th smallest |w|,
// then once for the count strictly below the threshold.
//
// What bounds it on an H100 SXM: it reads bits and seg once, 8 bytes an
// element (YOLOv2-VOC: 50.6M elements, ~405 MB, ~0.121 ms at 3.35 TB/s),
// and does two integer operations an element. It is bound by bytes.
//
// Design (simple first): one block per chunk walks it in 16-byte loads
// (topk_tile.cuh). The TPU kernel carried its counts in SMEM across a
// sequential grid and unrolled a loop over all S segments for every
// element; here each element reads its own pivot mid[seg] from shared
// memory, counts run in a register per thread while the segment stays the
// same, then go to one shared counter per segment, and each block adds its
// nonzero counters to global memory with one atomic each. Integer atomics
// are exact in any order. Segment ids outside [0, S) are not counted.

#include "topk_tile.cuh"

namespace {

using namespace topk;

__global__ void __launch_bounds__(THREADS)
count_le_kernel(const int* __restrict__ bits, const int* __restrict__ seg,
                const int* __restrict__ mid, unsigned long long* out,
                long long n, int S, int chunk, bool vec) {
  extern __shared__ unsigned int smem[];
  unsigned int* s_cnt = smem;
  int* s_mid = reinterpret_cast<int*>(smem + S);
  const int tid = threadIdx.x;
  for (int s = tid; s < S; s += THREADS) {
    s_cnt[s] = 0;
    s_mid[s] = mid[s];
  }
  __syncthreads();

  const long long start = (long long)blockIdx.x * chunk;
  const long long end = min(start + chunk, n);
  RunCounter counter;
  for (long long base = start; base < end; base += TILE) {
    const long long i0 = base + ITEMS * tid;
    int b[ITEMS], g[ITEMS];
    load_items(bits, i0, end, vec, b);
    load_items(seg, i0, end, vec, g);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int s = g[j];
      if (i0 + j < end && (unsigned)s < (unsigned)S)
        counter.add(s, b[j] <= s_mid[s], s_cnt);
    }
  }
  counter.flush(s_cnt);
  __syncthreads();
  for (int s = tid; s < S; s += THREADS)
    if (s_cnt[s]) atomicAdd(&out[s], (unsigned long long)s_cnt[s]);
}

}  // namespace

// Plain C entry for ctypes. bits, seg: int32 (n,); mid: int32 (S,); out:
// int64 (S,), zeroed by the caller (the kernel adds to it). One block per
// `chunk` elements (a multiple of 1024). Launches on `stream` and returns
// cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int mc_topk_count_le(const void* bits, const void* seg,
                                const void* mid, void* out, long long n,
                                int S, int chunk, void* stream) {
  const int bad = check_shape(n, S, chunk);
  if (bad) return bad;
  const bool vec = aligned16(bits) && aligned16(seg);
  const unsigned grid = (unsigned)((n + chunk - 1) / chunk);
  const size_t shmem = (size_t)S * 2 * sizeof(int);
  count_le_kernel<<<grid, THREADS, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bits), static_cast<const int*>(seg),
      static_cast<const int*>(mid), static_cast<unsigned long long*>(out), n,
      S, chunk, vec);
  return (int)cudaGetLastError();
}
