// Shared tiling of the magnitude top-k/mask kernels (topk_count_le.cu,
// topk_tie_counts.cu, topk_apply.cu).
//
// The flat arrays (|w| bit patterns, segment ids, weights) are cut into
// chunks of `chunk` elements, one block per chunk; the last chunk may be
// ragged. A block walks its chunk in rounds of TILE elements: thread t
// takes the ITEMS consecutive elements at round_start + ITEMS * t, with one
// 16-byte load per array when every pointer is 16-byte aligned and the
// round is whole, and guarded scalar loads otherwise. So a warp reads 512
// contiguous bytes of each array per round, and the elements a thread
// holds are in flat order, which the apply kernel's tie scan needs.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace topk {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;
constexpr int TILE = THREADS * ITEMS;
// per-segment arrays live in shared memory: S * 12 bytes at most
constexpr int MAX_SEGMENTS = 2048;

template <typename T> struct Vec4;
template <> struct Vec4<int> { using type = int4; };
template <> struct Vec4<float> { using type = float4; };

template <typename T>
__device__ __forceinline__ void load_items(const T* __restrict__ p,
                                           long long i0, long long end,
                                           bool vec, T (&v)[ITEMS]) {
  if (vec && i0 + ITEMS <= end) {
    using V = typename Vec4<T>::type;
    const V q = __ldg(reinterpret_cast<const V*>(p + i0));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      v[j] = i0 + j < end ? __ldg(p + i0 + j) : T(0);
  }
}

__device__ __forceinline__ void store_items(float* __restrict__ p,
                                            long long i0, long long end,
                                            bool vec, const float (&v)[ITEMS]) {
  if (vec && i0 + ITEMS <= end) {
    *reinterpret_cast<float4*>(p + i0) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      if (i0 + j < end) p[i0 + j] = v[j];
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Arguments every entry point checks the same way; returns 0 or
// cudaErrorInvalidValue.
inline int check_shape(long long n, int S, int chunk) {
  if (n < 1 || S < 1 || S > MAX_SEGMENTS || chunk < TILE || chunk % TILE)
    return (int)cudaErrorInvalidValue;
  if ((n + chunk - 1) / chunk > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  return 0;
}

// Per-thread run-length counter: consecutive elements of one segment are
// summed in a register and added to the block's shared counter when the
// segment changes, so contiguous segments cost one shared atomic per
// thread and segment, not one per element.
struct RunCounter {
  int seg = -1;
  unsigned int run = 0;
  __device__ __forceinline__ void add(int s, unsigned int v,
                                      unsigned int* counts) {
    if (s != seg) {
      if (run) atomicAdd(&counts[seg], run);
      seg = s;
      run = 0;
    }
    run += v;
  }
  __device__ __forceinline__ void flush(unsigned int* counts) {
    if (run) atomicAdd(&counts[seg], run);
  }
};

}  // namespace topk
