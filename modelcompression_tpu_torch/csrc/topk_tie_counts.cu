// Per-chunk, per-segment count of |w| bit patterns equal to the threshold,
// for Hopper (sm_90a): out[c, s] = #{i in chunk c : seg[i] == s and
// bits[i] == tau[s]}.
//
// Replaces the TPU kernel modelcompression_tpu/ops/pallas_topk.py::
// _tie_count_kernel (launched by pallas_tie_counts). The magnitude prune
// runs it once; the prefix sums of its rows and columns, taken outside
// the kernel over the small (chunks, S) table, give the apply kernel the
// ties before each chunk and before each segment.
//
// What bounds it on an H100 SXM: it reads bits and seg once, 8 bytes an
// element (YOLOv2-VOC: ~405 MB, ~0.121 ms at 3.35 TB/s); the table it
// writes is chunks * S * 4 bytes (under 0.3 MB). It is bound by bytes.
//
// Design: as topk_count_le.cu, with equality in place of <= and no global
// atomics: a block owns its chunk's row of the table and writes it whole.
// The chunk is the port's (ops/cuda_topk.CHUNK), not the TPU's. Segment
// ids outside [0, S) are not counted.

#include "on_device.cuh"
#include "topk_tile.cuh"

namespace {

using namespace topk;

__global__ void __launch_bounds__(THREADS)
tie_counts_kernel(const int* __restrict__ bits, const int* __restrict__ seg,
                  const int* __restrict__ tau, int* __restrict__ out,
                  long long n, int S, int chunk, bool vec) {
  extern __shared__ unsigned int smem[];
  unsigned int* s_cnt = smem;
  int* s_tau = reinterpret_cast<int*>(smem + S);
  const int tid = threadIdx.x;
  for (int s = tid; s < S; s += THREADS) {
    s_cnt[s] = 0;
    s_tau[s] = tau[s];
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
        counter.add(s, b[j] == s_tau[s], s_cnt);
    }
  }
  counter.flush(s_cnt);
  __syncthreads();
  int* row = out + (long long)blockIdx.x * S;
  for (int s = tid; s < S; s += THREADS) row[s] = (int)s_cnt[s];
}

}  // namespace

// Plain C entry for ctypes. bits, seg: int32 (n,); tau: int32 (S,); out:
// int32 (ceil(n / chunk), S), every entry written by the kernel. One block
// per `chunk` elements (a multiple of 1024); device: the CUDA device that
// holds the tensors (on_device.cuh). Launches on `stream` and returns
// cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int mc_topk_tie_counts(const void* bits, const void* seg,
                                  const void* tau, void* out, long long n,
                                  int S, int chunk, int device,
                                  void* stream) {
  const int bad = check_shape(n, S, chunk);
  if (bad) return bad;
  const bool vec = aligned16(bits) && aligned16(seg);
  const unsigned grid = (unsigned)((n + chunk - 1) / chunk);
  const size_t shmem = (size_t)S * 2 * sizeof(int);
  return on_device(device, [&] {
    tie_counts_kernel<<<grid, THREADS, shmem,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(bits), static_cast<const int*>(seg),
        static_cast<const int*>(tau), static_cast<int*>(out), n, S, chunk,
        vec);
    return (int)cudaGetLastError();
  });
}
