// Fused input stage on Hopper's tensor cores (sm_90a), the bf16 route:
// conv1 (3x3, stride 1, pad 1, C_in = 3) + bias + leaky 0.1 + 2x2/2
// maxpool in one pass, with the products on warp-level mma.sync
// (m16n8k16, bf16 in, fp32 accumulate).
//
// Replaces the TPU kernel modelcompression_tpu/ops/input_stage.py::_kernel
// (launched by fused_conv1_pool_pallas). For every pooled output
// (b, y, x, c) it computes
//
//   bf16(leaky(max over phases (py, px) of
//              sum_{ky,kx,ci} x[b, 2y+py+ky-1, 2x+px+kx-1, ci] * w[c,ci,ky,kx]
//              + bias[c]))
//
// with zero padding outside the image: bf16 operands, fp32 products and
// sums, bias and leaky in fp32, one rounding to bf16. The fp32 route stays
// on the CUDA-core kernel csrc/input_stage.cu.
//
// What bounds it on an H100 SXM (B=64, 416x416, C=32): 66.4 MB of bf16
// canvas in and 177.2 MB out, ~73 us at 3.35 TB/s (C=8: ~33 us). In this
// direct GEMM form the work is 11.08M rows (pooled pixel x phase) x K=32 x
// N=32, 22.7 GFLOP, ~23 us at the dense bf16 rate, so the kernel is bound
// by bytes, and most of the bytes are the output stores.
//
// Design:
// * GEMM view. Rows are (pooled pixel, phase); K is the tap
//   k = (ky*3 + kx)*3 + ci for k < 27, zero for k = 27..31 (two k16 steps);
//   N is C padded to a multiple of 8 (NT n-tiles of 8). wpack is (8*NT, 32)
//   bf16, K-contiguous per output channel, so each B fragment register is
//   one 4-byte load; a thread holds all of its B fragments in registers.
// * Row mapping. A warp's unit is 8 pooled pixels of one pooled row, as
//   two m16 tiles, one per py. In a tile, row g is pixel g at px = 0 and
//   row g+8 the same pixel at px = 1. Thread (g, t) = (lane>>2, lane&3)
//   then holds all four phases of pixel g for channels 8j+2t and 8j+2t+1
//   of n-tile j: the pool is three fmaxf in registers, then bias, leaky and
//   one bf16x2 pack.
// * A gather. A block owns TH x TW pooled pixels of one image and stages
//   their (2TH+2) x (2TW+2) x 3 bf16 input halo in shared memory, zero
//   outside the image. Row (ty, tx, py, px) and tap k read the halo at
//   ((2ty+py)*HALO_W + 2tx+px)*3 + (k/9)*HALO_W*3 + k%9; each thread
//   precomputes the 8 tap offsets of its A fragments once. Taps k >= 27 are
//   masked to zero (their weight is zero, but 0 * NaN would not be).
// * Stores. The block's (TH*TW, C) output tile is staged in shared memory
//   (row stride padded by 8 against bank conflicts) and written back with
//   16-byte stores by consecutive threads: one pooled row of a tile is
//   TW*C*2 contiguous bytes. Channel counts that are not a multiple of 8
//   take an element-wise copy-out.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

#include "on_device.cuh"

namespace {

constexpr int TH = 16;  // pooled rows per block
constexpr int TW = 16;  // pooled columns per block (208 = 13 x 16)
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int UNITS_PER_ROW = TW / 8;
constexpr int UNITS_PER_WARP = TH * UNITS_PER_ROW / WARPS;
constexpr int HALO_H = 2 * TH + 2;
constexpr int HALO_W = 2 * TW + 2;
constexpr int HALO_ROW = HALO_W * 3;  // bf16 elements in one halo row
constexpr int HALO = HALO_H * HALO_ROW;
constexpr int HALO_LOADS = (HALO + THREADS - 1) / THREADS;
constexpr int KP = 32;  // the 27 taps padded to two k16 steps

static_assert(TW % 8 == 0, "a unit is 8 pooled pixels of one row");
static_assert(TH * UNITS_PER_ROW % WARPS == 0, "units split evenly");

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// two bf16 bit patterns as one .b32 operand, the lower k in the low half
__device__ __forceinline__ uint32_t pack2(uint16_t lo, uint16_t hi) {
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

template <int NT>
__global__ void __launch_bounds__(THREADS)
conv1_pool_mma_kernel(const uint16_t* __restrict__ x,
                      const uint32_t* __restrict__ wpack,
                      const float* __restrict__ bias,
                      uint16_t* __restrict__ out, int H, int W, int C) {
  constexpr int NP = NT * 8;  // channels padded to whole n-tiles
  constexpr int SS = NP + 8;  // staging stride per pixel, in elements
  __shared__ __align__(16) uint16_t halo[HALO];
  __shared__ __align__(16) uint16_t stage[TH * TW * SS];

  const int H2 = H / 2, W2 = W / 2;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  // input halo: halo row r is image row 2*oy0 - 1 + r, halo column s is
  // image column 2*ox0 - 1 + s; all loads issued before any store
  const uint16_t* xb = x + (size_t)b * H * W * 3;
  const int iy0 = 2 * oy0 - 1, ix0 = 2 * ox0 - 1;
  uint16_t v[HALO_LOADS];
#pragma unroll
  for (int l = 0; l < HALO_LOADS; ++l) {
    const int i = tid + l * THREADS;
    const int r = i / HALO_ROW, e = i - r * HALO_ROW;
    const int iy = iy0 + r, ix = ix0 + e / 3;
    v[l] = 0;
    if (i < HALO && iy >= 0 && iy < H && ix >= 0 && ix < W)
      v[l] = xb[((ptrdiff_t)iy * W + ix0) * 3 + e];
  }
#pragma unroll
  for (int l = 0; l < HALO_LOADS; ++l) {
    const int i = tid + l * THREADS;
    if (i < HALO) halo[i] = v[l];
  }

  // B fragments of both k-steps and every n-tile: b0 = (k 16s+2t, +1;
  // n 8j+g), b1 = (k 16s+2t+8, +9; n 8j+g); wpack as 32-bit words
  uint32_t bfrag[2][NT][2];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint32_t* wr = wpack + (8 * j + g) * (KP / 2) + 8 * s + t;
      bfrag[s][j][0] = wr[0];
      bfrag[s][j][1] = wr[4];
    }
  float bias_lo[NT], bias_hi[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int c = 8 * j + 2 * t;
    bias_lo[j] = c < C ? bias[c] : 0.f;
    bias_hi[j] = c + 1 < C ? bias[c + 1] : 0.f;
  }

  // halo offsets of this thread's A taps: q = 0, 1 -> k = 16s+2t, +1;
  // q = 2, 3 -> k = 16s+2t+8, +9. Taps k >= 27 read offset 0 and are
  // masked to zero (only k-step 1's q = 2, 3 can reach them).
  int off[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = 16 * s + 2 * t + (q & 1) + 8 * (q >> 1);
      off[s][q] = k < 27 ? (k / 9) * HALO_ROW + k % 9 : 0;
    }
  const uint32_t kmask = (24 + 2 * t < 27 ? 0x0000FFFFu : 0u) |
                         (25 + 2 * t < 27 ? 0xFFFF0000u : 0u);
  __syncthreads();

#pragma unroll 1
  for (int uu = 0; uu < UNITS_PER_WARP; ++uu) {
    const int u = warp * UNITS_PER_WARP + uu;
    const int ty = u / UNITS_PER_ROW, tx0 = (u % UNITS_PER_ROW) * 8;
    float acc[2][NT][4];
#pragma unroll
    for (int py = 0; py < 2; ++py)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[py][j][i] = 0.f;

#pragma unroll
    for (int py = 0; py < 2; ++py) {
      // row g: pixel tx0+g at px = 0; row g+8: px = 1, three elements on
      const uint16_t* h0 = halo + (2 * ty + py) * HALO_ROW + 6 * (tx0 + g);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const uint32_t a0 = pack2(h0[off[s][0]], h0[off[s][1]]);
        const uint32_t a1 = pack2(h0[3 + off[s][0]], h0[3 + off[s][1]]);
        uint32_t a2 = pack2(h0[off[s][2]], h0[off[s][3]]);
        uint32_t a3 = pack2(h0[3 + off[s][2]], h0[3 + off[s][3]]);
        if (s == 1) {
          a2 &= kmask;
          a3 &= kmask;
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mma_bf16_16816(acc[py][j], a0, a1, a2, a3, bfrag[s][j][0],
                         bfrag[s][j][1]);
      }
    }

    // c0, c1: row g (px = 0), channels 8j+2t, +1; c2, c3: row g+8 (px = 1)
    uint16_t* st = stage + (ty * TW + tx0 + g) * SS + 2 * t;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float lo = fmaxf(fmaxf(acc[0][j][0], acc[0][j][2]),
                       fmaxf(acc[1][j][0], acc[1][j][2])) + bias_lo[j];
      float hi = fmaxf(fmaxf(acc[0][j][1], acc[0][j][3]),
                       fmaxf(acc[1][j][1], acc[1][j][3])) + bias_hi[j];
      lo = lo > 0.f ? lo : 0.1f * lo;
      hi = hi > 0.f ? hi : 0.1f * hi;
      *reinterpret_cast<__nv_bfloat162*>(st + 8 * j) =
          __floats2bfloat162_rn(lo, hi);
    }
  }
  __syncthreads();

  // write-back; the ragged last tile (H/2 or W/2 not a multiple of the
  // tile) is masked here
  const int nrows = min(TH, H2 - oy0), ncols = min(TW, W2 - ox0);
  if (C == NP) {
    // 16-byte chunks; row r of the tile is ncols*C contiguous outputs
    constexpr int CHUNKS_PER_ROW = TW * NT;
    for (int i = tid; i < TH * CHUNKS_PER_ROW; i += THREADS) {
      const int r = i / CHUNKS_PER_ROW, q = i - r * CHUNKS_PER_ROW;
      if (r < nrows && q < ncols * NT) {
        const uint4 val = *reinterpret_cast<const uint4*>(
            stage + (r * TW + q / NT) * SS + (q % NT) * 8);
        *reinterpret_cast<uint4*>(
            out + (((size_t)b * H2 + oy0 + r) * W2 + ox0) * NP + q * 8) = val;
      }
    }
  } else {
    for (int i = tid; i < TH * TW * C; i += THREADS) {
      const int p = i / C, c = i - p * C;
      const int r = p / TW, cx = p - r * TW;
      if (r < nrows && cx < ncols)
        out[(((size_t)b * H2 + oy0 + r) * W2 + ox0 + cx) * C + c] =
            stage[p * SS + c];
    }
  }
}

template <int NT>
cudaError_t launch(const void* x, const void* wpack, const void* bias,
                   void* out, int B, int H, int W, int C,
                   cudaStream_t stream) {
  const dim3 grid((W / 2 + TW - 1) / TW, (H / 2 + TH - 1) / TH, B);
  conv1_pool_mma_kernel<NT><<<grid, THREADS, 0, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const uint32_t*>(wpack),
      static_cast<const float*>(bias), static_cast<uint16_t*>(out), H, W, C);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. x (B, H, W, 3) NHWC bf16 contiguous; wpack
// (8*ceil(C/8), 32) bf16 contiguous, row n = output channel n's taps
// k = (ky*3 + kx)*3 + ci, zero for k >= 27 and for n >= C; bias (C,) fp32;
// out (B, H/2, W/2, C) bf16, allocated by the caller, 16-byte aligned;
// device: the CUDA device that holds them (on_device.cuh). Launches on
// `stream` and returns cudaGetLastError() after the launch (0 =
// cudaSuccess).
extern "C" int mc_input_stage_mma(const void* x, const void* wpack,
                                  const void* bias, void* out, int B, int H,
                                  int W, int C, int device, void* stream) {
  if (B < 1 || H < 2 || W < 2 || (H & 1) || (W & 1) || C < 1 || C > 32 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    switch ((C + 7) / 8) {
      case 1: return (int)launch<1>(x, wpack, bias, out, B, H, W, C, s);
      case 2: return (int)launch<2>(x, wpack, bias, out, B, H, W, C, s);
      case 3: return (int)launch<3>(x, wpack, bias, out, B, H, W, C, s);
      default: return (int)launch<4>(x, wpack, bias, out, B, H, W, C, s);
    }
  });
}
