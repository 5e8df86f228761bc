// Conv epilogue for Hopper (sm_90a): the bias add and the activation that
// follow each convolution of the bf16 forward, in one pass and in place:
//
//   y[m, c] = bf16(act(float(y[m, c]) + bias[c]))
//
// over the conv's bf16 output in channels-last storage, a contiguous
// (M = B*H*W, C) array, with the conv's fp32 (BN-folded) bias (C,). act is linear, leaky (slope 0.1) or mish, a template parameter.
// Each element is widened to fp32 once, the bias is added and the
// activation computed in fp32, and the result is rounded to bf16 once.
//
// Replaces no Pallas kernel: the JAX package leaves this epilogue to XLA,
// which fuses it for the TPU. In eager PyTorch the same chain is a bias
// cast, a bias add and, for mish, softplus, tanh and a multiply, each a
// pass that reads and writes the whole conv output.
//
// What bounds it on an H100 SXM: one read and one write of the conv output,
// 4 bytes an element, against ~15 fp32 instructions an element (mish):
// far below the ridge, so it is bound by bytes. YOLOv4-VOC 416 at batch
// 64: 110 convs, 3.39e9 elements, 13.55 GB a forward, 4.04 ms at
// 3.35 TB/s.
//
// Design:
// * Vector path (C % 8 == 0, y and bias 16-byte aligned): a thread moves 8
//   bf16 of one row segment with one 16-byte load and one 16-byte store,
//   and reads the 8 matching biases as two 16-byte loads (the bias is tiny
//   and stays in L1/L2). Each thread has two vectors in flight before it
//   computes. A grid-stride loop walks the M*C/8 vectors; a thread keeps
//   its vectors' channel group incrementally (the stride modulo C/8, added
//   and wrapped once a step) instead of a 64-bit division a vector.
// * Scalar path otherwise (YOLOv4's three 75-channel heads): the same
//   loop over single elements, neighbouring threads on neighbouring
//   addresses, the channel kept incrementally.
// * The grid is the card's resident blocks (SMs x blocks an SM at this
//   kernel's registers) or fewer for small outputs, so one wave covers the
//   work at every YOLOv4 shape down to 13x13x1024 at batch 64.
// * Mish without its three transcendental passes: with e = exp(v),
//   tanh(log1p(e)) = ((1+e)^2 - 1) / ((1+e)^2 + 1) = n / (n + 2) with
//   n = e (e + 2), so mish(v) = v n / (n + 2). Above v = 20 it returns v
//   (tanh(softplus(v)) is 1 in fp32 there), so e * e cannot overflow; for
//   large negative v, n -> 0 and mish -> 0. exp is exp2f, which keeps
//   subnormal results (the build does not flush to zero). The division is
//   __fdividef (2 ulp; n + 2 lies in [2, 2.4e17], inside its range): IEEE
//   division takes a slow path on subnormal operands, which far-negative
//   inputs reach, and even without them held the mish convs of YOLOv4 at
//   66% of the bound against 77%.
// * In place: the conv output is a fresh tensor nothing else holds, so the
//   kernel allocates nothing and moves no more bytes than the pass needs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "on_device.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 2;  // vectors (or elements) a thread has in flight
constexpr int LINEAR = 0, LEAKY = 1, MISH = 2;
constexpr float LEAKY_SLOPE = 0.1f;
constexpr float MISH_CUTOFF = 20.f;
constexpr float LOG2E = 1.4426950408889634f;

template <int ACT>
__device__ __forceinline__ float act(float v) {
  if (ACT == LEAKY) return v > 0.f ? v : LEAKY_SLOPE * v;
  if (ACT == MISH) {
    if (v > MISH_CUTOFF) return v;
    const float e = exp2f(v * LOG2E);
    const float n = e * (e + 2.f);
    return __fdividef(v * n, n + 2.f);
  }
  return v;
}

template <int ACT>
__device__ __forceinline__ uint32_t pair(uint32_t bits, float b0, float b1) {
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&bits);
  const float2 f = __bfloat1622float2(h);
  h = __floats2bfloat162_rn(act<ACT>(f.x + b0), act<ACT>(f.y + b1));
  return *reinterpret_cast<uint32_t*>(&h);
}

// y: (nvec,) vectors of 8 bf16; bias: (2 * groups,) float4; groups = C / 8.
template <int ACT>
__global__ void __launch_bounds__(THREADS)
conv_epilogue_vec_kernel(uint4* __restrict__ y,
                         const float4* __restrict__ bias, long long nvec,
                         int groups) {
  const long long stride = (long long)gridDim.x * THREADS;
  long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  int g = (int)(i % groups);
  const int step = (int)(stride % groups);
  for (; i < nvec; i += UNROLL * stride) {
    uint4 v[UNROLL];
    int gu[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      gu[u] = g;
      if (i + u * stride < nvec) v[u] = y[i + u * stride];
      g += step;
      if (g >= groups) g -= groups;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (i + u * stride >= nvec) break;
      const float4 lo = __ldg(bias + 2 * gu[u]);
      const float4 hi = __ldg(bias + 2 * gu[u] + 1);
      uint4 o;
      o.x = pair<ACT>(v[u].x, lo.x, lo.y);
      o.y = pair<ACT>(v[u].y, lo.z, lo.w);
      o.z = pair<ACT>(v[u].z, hi.x, hi.y);
      o.w = pair<ACT>(v[u].w, hi.z, hi.w);
      y[i + u * stride] = o;
    }
  }
}

// y: (n / c, c) bf16, element i of channel i % c; bias: (c,) fp32.
template <int ACT>
__global__ void __launch_bounds__(THREADS)
conv_epilogue_scalar_kernel(__nv_bfloat16* __restrict__ y,
                            const float* __restrict__ bias, long long n,
                            int c) {
  const long long stride = (long long)gridDim.x * THREADS;
  long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  int ch = (int)(i % c);
  const int step = (int)(stride % c);
  for (; i < n; i += UNROLL * stride) {
    float v[UNROLL];
    int cu[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      cu[u] = ch;
      if (i + u * stride < n) v[u] = __bfloat162float(y[i + u * stride]);
      ch += step;
      if (ch >= c) ch -= c;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (i + u * stride >= n) break;
      y[i + u * stride] =
          __float2bfloat16_rn(act<ACT>(v[u] + __ldg(bias + cu[u])));
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Blocks for `work` items at UNROLL a thread, at most the card's resident
// blocks of `kernel` (its occupancy, looked up once a kernel).
template <typename Kernel>
unsigned grid_for(Kernel kernel, int& per_sm, long long work, int sms) {
  if (per_sm == 0) {
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS,
                                                      0) != cudaSuccess ||
        n < 1)
      n = 1;
    per_sm = n;
  }
  const long long want = (work + (long long)THREADS * UNROLL - 1) /
                         ((long long)THREADS * UNROLL);
  const long long most = (long long)per_sm * sms;
  return (unsigned)(want < most ? want : most);
}

template <int ACT>
void launch(void* y, const void* bias, long long n, int c, int sms,
            cudaStream_t s) {
  static int vec_per_sm = 0, scalar_per_sm = 0;
  if (c % 8 == 0 && aligned16(y) && aligned16(bias)) {
    const long long nvec = n / 8;
    const unsigned grid =
        grid_for(conv_epilogue_vec_kernel<ACT>, vec_per_sm, nvec, sms);
    conv_epilogue_vec_kernel<ACT><<<grid, THREADS, 0, s>>>(
        static_cast<uint4*>(y), static_cast<const float4*>(bias), nvec,
        c / 8);
  } else {
    const unsigned grid =
        grid_for(conv_epilogue_scalar_kernel<ACT>, scalar_per_sm, n, sms);
    conv_epilogue_scalar_kernel<ACT><<<grid, THREADS, 0, s>>>(
        static_cast<__nv_bfloat16*>(y), static_cast<const float*>(bias), n,
        c);
  }
}

// The device's SM count, looked up once a device.
constexpr int MAX_DEVICES = 64;
cudaError_t sms_of(int device, int& sms) {
  static int known[MAX_DEVICES] = {0};
  if (device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (known[device] == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &known[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  sms = known[device];
  return cudaSuccess;
}

}  // namespace

// Plain C entry for ctypes. y: bf16, n elements in channels-last storage,
// an (n / c, c) array, rewritten in place; bias: fp32 (c,), contiguous;
// act_kind: 0 linear, 1 leaky (0.1), 2 mish; device: the CUDA device that
// holds y and bias (on_device.cuh). Launches on `stream` and returns
// cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int mc_conv_epilogue(void* y, const void* bias, long long n,
                                int c, int act_kind, int device,
                                void* stream) {
  if (n < 0 || c < 1 || n % c || act_kind < LINEAR || act_kind > MISH)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  return on_device(device, [&] {
    int sms = 0;
    cudaError_t err = sms_of(device, sms);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (act_kind) {
      case LINEAR: launch<LINEAR>(y, bias, n, c, sms, s); break;
      case LEAKY: launch<LEAKY>(y, bias, n, c, sms, s); break;
      default: launch<MISH>(y, bias, n, c, sms, s); break;
    }
    return (int)cudaGetLastError();
  });
}
