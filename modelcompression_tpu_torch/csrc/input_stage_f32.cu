// Fused input stage on Hopper's CUDA cores (sm_90a), the fp32 (BITMATCH)
// route: conv1 (3x3, stride 1, pad 1, C_in = 3) + bias + leaky 0.1 + 2x2/2
// maxpool in one pass, fp32 throughout.
//
// Replaces the TPU kernel modelcompression_tpu/ops/input_stage.py::_kernel
// (launched by fused_conv1_pool_pallas) for fp32 operands. For every pooled
// output (b, y, x, c) it computes
//
//   leaky(max over phases (py, px) of
//         sum_{ky,kx,ci} x[b, 2y+py+ky-1, 2x+px+kx-1, ci] * w[c, ci, ky, kx]
//         + bias[c])
//
// with zero padding outside the image: fp32 products and sums (fmaf, no
// tensor cores, no TF32), bias and leaky in fp32. It differs from the plain
// version only in summation order. The bf16 route is csrc/input_stage_mma.cu.
//
// What bounds it on an H100 SXM (B=64, 416x416): 4 phases x 27 taps x C
// FMAs per pooled pixel, 19.1 GFLOP at C=32 (4.8 at C=8), ~0.29 ms (~0.07)
// at the 67 TFLOP/s of fp32 outside the tensor cores; the bytes (133 MB in,
// 354 MB out at C=32) take ~0.15 ms at 3.35 TB/s. So it is bound by FFMA
// issue, and the design keeps every other instruction out of the way:
//
// * Loop order. Taps outside, phases inside: a thread loads the 8 weights
//   of its channels for one tap once (two 16-byte broadcast loads from
//   shared memory) and uses them for both its pixels and all four pool
//   phases (acc[2][4][8]: 64 independent FMA chains, 64 FMAs per weight
//   pair). The pool is a register max at the end. An empty asm memory
//   clobber per pass and per kernel row keeps the compiler from hoisting
//   every tap's weights and rows into registers (it spilled: 128
//   registers and a 1.2 KB stack at CP = 32).
// * Work per thread. CB = 8 channels of two horizontally adjacent pooled
//   pixels (tx = 2k, 2k + 1); G = CP/8 threads per pixel pair, adjacent
//   lanes, so their window loads are broadcasts. Per pair: 1728 FFMA
//   against 54 weight loads and 30 window loads.
// * Window loads. The halo keeps the image's NHWC interleaving, one row of
//   104 floats per image row (image floats [6*ox0 - 4, 6*ox0 + 100)), so
//   the pair's two 4x4x3 windows (6 columns, two shared) are floats
//   12k + 1 .. 12k + 18 of each row: five aligned 16-byte loads at 12k,
//   conflict-free (lanes 48 bytes apart). Two rows are live at a time
//   (kernel row ky reads rows ky and ky + 1).
// * Persistent blocks, double-buffered halo. One wave of 4-warp blocks (SMs
//   x resident blocks, 4 per SM at 128 registers) walks the
//   16x16-pooled-pixel tiles; the next tile's halo streams in with
//   cp.async (16-byte chunks, src-size 0 for the zero padding; 4-byte
//   copies when W is not a multiple of 4 or x is not 16-byte aligned)
//   while the current one computes. One __syncthreads per tile. Small
//   blocks keep more tiles in flight per SM, which matters most at C = 8,
//   where a tile is one pixel pair per thread.
// * Stores. Each thread writes each pixel's 8 channels as two 16-byte
//   stores, a pixel pair at C = 8 being 64 contiguous bytes. (Pairing lanes
//   with a shuffle so that each instruction writes whole 32-byte sectors
//   measured slower.)
// * Tiles of 16 divide W/2 = 208 at 416x416; other sizes mask the ragged
//   edge at the store.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "on_device.cuh"

namespace {

constexpr int TH = 16;  // pooled rows per tile
constexpr int TW = 16;  // pooled columns per tile (208 = 13 x 16)
constexpr int WARPS = 4;  // per block
constexpr int THREADS = WARPS * 32;
constexpr int MIN_BLOCKS = 4;  // 16 resident warps per SM: <= 128 registers
constexpr int CB = 8;  // channels per thread
constexpr int HALO_ROWS = 2 * TH + 2;
constexpr int ROW_FLOATS = 6 * TW + 8;  // 2*TW + 2 pixels x 3, aligned
constexpr int ROW_CHUNKS = ROW_FLOATS / 4;
constexpr int HALO_FLOATS = HALO_ROWS * ROW_FLOATS;

static_assert(TH == 16 && TW == 16, "the lane mapping covers 16x16 tiles");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// src-size 0 writes zeros and reads nothing (src must still be a valid
// address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct Tile {
  int b, oy0, ox0;
};

__device__ __forceinline__ Tile tile_of(int t, int tiles_x, int tiles_y) {
  const int r = t / tiles_x;
  return {r / tiles_y, (r % tiles_y) * TH, (t - r * tiles_x) * TW};
}

// Halo row r holds image row 2*oy0 - 1 + r, floats [6*ox0 - 4, +104) of it
// (pixel 2*ox0 - 1 starts at float 1); zero outside the image.
template <bool VEC>
__device__ __forceinline__ void issue_halo(const float* __restrict__ x, int H,
                                           int W, Tile tile, uint32_t dst,
                                           int tid) {
  const int iy0 = 2 * tile.oy0 - 1;
  const int f0 = 6 * tile.ox0 - 4;
  const int rowf = 3 * W;
  const float* xb = x + (size_t)tile.b * H * rowf;
  if (VEC) {
    // W % 4 == 0: every chunk is 16-byte aligned and lies wholly inside
    // or wholly outside its image row
    for (int i = tid; i < HALO_ROWS * ROW_CHUNKS; i += THREADS) {
      const int r = i / ROW_CHUNKS, c = i - r * ROW_CHUNKS;
      const int iy = iy0 + r, f = f0 + 4 * c;
      const bool ok = iy >= 0 && iy < H && f >= 0 && f < rowf;
      cp_async16(dst + (r * ROW_FLOATS + 4 * c) * 4,
                 ok ? xb + (size_t)iy * rowf + f : x, ok);
    }
  } else {
    for (int i = tid; i < HALO_FLOATS; i += THREADS) {
      const int r = i / ROW_FLOATS, e = i - r * ROW_FLOATS;
      const int iy = iy0 + r, f = f0 + e;
      const bool ok = iy >= 0 && iy < H && f >= 0 && f < rowf;
      cp_async4(dst + i * 4, ok ? xb + (size_t)iy * rowf + f : x, ok);
    }
  }
}

__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// One halo row's floats for a pixel pair (tx = 2k, 2k + 1): five aligned
// 16-byte loads at 12k; floats 1 .. 18 are the pair's 6 window columns.
__device__ __forceinline__ void load_row(const float* p, float (&r)[20]) {
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(p + 4 * j);
    r[4 * j] = v.x;
    r[4 * j + 1] = v.y;
    r[4 * j + 2] = v.z;
    r[4 * j + 3] = v.w;
  }
}

// One tile from the staged halo. Lane = (pixel pair k, channel group g);
// a warp's pairs are the 8 pairs of each of 32/(8G) rows, and warp w
// serves row groups w + WARPS*pass.
template <int CP>
__device__ __forceinline__ void compute_tile(
    const float* __restrict__ halo, const float* __restrict__ ws,
    const float* __restrict__ bs, float* __restrict__ out, Tile tile, int H2,
    int W2, int C, int warp, int lane) {
  constexpr int G = CP / CB;
  constexpr int UPW = 32 / G / 8;  // rows per warp pass
  constexpr int PASSES = TH / UPW / WARPS;
  static_assert(PASSES * WARPS * UPW == TH, "lane mapping");
  const int g = lane % G, pl = lane / G;
  const int u = pl >> 3, k = pl & 7;
  const int c0 = CB * g;
  const float4* w4 = reinterpret_cast<const float4*>(ws) + 2 * g;

#pragma unroll 1
  for (int pass = 0; pass < PASSES; ++pass) {
    asm volatile("" ::: "memory");  // no weight load hoisted out of a pass
    const int ty = (warp + WARPS * pass) * UPW + u;
    const float* hp = halo + 2 * ty * ROW_FLOATS + 12 * k;

    float acc[2][4][CB];  // [pixel][phase][channel]
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int c = 0; c < CB; ++c) acc[j][p][c] = 0.f;

#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      asm volatile("" ::: "memory");  // nor out of a kernel row
      float r[2][20];  // window rows ky (py = 0) and ky + 1 (py = 1)
      load_row(hp + ky * ROW_FLOATS, r[0]);
      load_row(hp + (ky + 1) * ROW_FLOATS, r[1]);
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
#pragma unroll
        for (int ci = 0; ci < 3; ++ci) {
          const int t = (ky * 3 + kx) * 3 + ci;
          const float4 wa = w4[t * (CP / 4)];
          const float4 wb = w4[t * (CP / 4) + 1];
          const float wt[CB] = {wa.x, wa.y, wa.z, wa.w,
                                wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              const float v =
                  r[p >> 1][1 + 6 * j + 3 * ((p & 1) + kx) + ci];
#pragma unroll
              for (int c = 0; c < CB; ++c)
                acc[j][p][c] = fmaf(v, wt[c], acc[j][p][c]);
            }
        }
    }

    const float4 ba = reinterpret_cast<const float4*>(bs + c0)[0];
    const float4 bb = reinterpret_cast<const float4*>(bs + c0)[1];
    const float bv[CB] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
    const int oy = tile.oy0 + ty;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float y[CB];
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        const float m = fmaxf(fmaxf(acc[j][0][c], acc[j][1][c]),
                              fmaxf(acc[j][2][c], acc[j][3][c])) + bv[c];
        y[c] = m > 0.f ? m : 0.1f * m;
      }
      const int ox = tile.ox0 + 2 * k + j;
      if (oy >= H2 || ox >= W2) continue;  // ragged last tile
      float* o = out + (((size_t)tile.b * H2 + oy) * W2 + ox) * C + c0;
      if ((C & 3) == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
          if (c0 + 4 * h + 4 <= C) st4(o + 4 * h, y + 4 * h);
      } else {
#pragma unroll
        for (int c = 0; c < CB; ++c)
          if (c0 + c < C) o[c] = y[c];
      }
    }
  }
}

// CP: channel count padded to 8, 16 or 32; channels c >= C carry zero
// weights and are not stored.
template <int CP, bool VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
conv1_pool_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ bias, float* __restrict__ out,
                      int H, int W, int C, int tiles_x, int tiles_y,
                      int n_tiles) {
  __shared__ __align__(16) float halo[2][HALO_FLOATS];
  __shared__ __align__(16) float ws[27 * CP];
  __shared__ __align__(16) float bs[CP];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int H2 = H / 2, W2 = W / 2;
  const int step = gridDim.x;

  int t = blockIdx.x;
  if (t >= n_tiles) return;
  Tile tile = tile_of(t, tiles_x, tiles_y);
  issue_halo<VEC>(x, H, W, tile, smem_addr(halo[0]), tid);
  cp_async_commit();

  // weights OIHW (C, 3, 3, 3) -> ws[tap * CP + c], tap = (ky*3 + kx)*3 + ci
  for (int i = tid; i < 27 * CP; i += THREADS) {
    const int tap = i / CP, c = i - tap * CP;
    const int ky = tap / 9, kx = (tap / 3) % 3, ci = tap % 3;
    ws[i] = c < C ? w[((c * 3 + ci) * 3 + ky) * 3 + kx] : 0.f;
  }
  for (int i = tid; i < CP; i += THREADS) bs[i] = i < C ? bias[i] : 0.f;

  for (int s = 0;; s ^= 1) {
    // this tile's halo has landed for every thread, and every thread is
    // done with the other buffer (read by the previous tile)
    cp_async_wait_all();
    __syncthreads();
    const int tn = t + step;
    Tile next = tile;
    if (tn < n_tiles) {
      next = tile_of(tn, tiles_x, tiles_y);
      issue_halo<VEC>(x, H, W, next, smem_addr(halo[s ^ 1]), tid);
    }
    cp_async_commit();
    compute_tile<CP>(halo[s], ws, bs, out, tile, H2, W2, C, warp, lane);
    if (tn >= n_tiles) break;
    t = tn;
    tile = next;
  }
}

template <int CP, bool VEC>
cudaError_t launch(const float* x, const float* w, const float* bias,
                   float* out, int B, int H, int W, int C,
                   cudaStream_t stream) {
  const auto kernel = conv1_pool_f32_kernel<CP, VEC>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, 0);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W / 2 + TW - 1) / TW, tiles_y = (H / 2 + TH - 1) / TH;
  const long long n_tiles = (long long)B * tiles_y * tiles_x;
  if (n_tiles > INT_MAX) return cudaErrorInvalidValue;
  // one wave of persistent blocks
  const long long wave = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const int grid = (int)(n_tiles < wave ? n_tiles : wave);
  kernel<<<grid, THREADS, 0, stream>>>(x, w, bias, out, H, W, C, tiles_x,
                                       tiles_y, (int)n_tiles);
  return cudaGetLastError();
}

template <int CP>
cudaError_t launch_cp(bool vec, const float* x, const float* w,
                      const float* bias, float* out, int B, int H, int W,
                      int C, cudaStream_t s) {
  return vec ? launch<CP, true>(x, w, bias, out, B, H, W, C, s)
             : launch<CP, false>(x, w, bias, out, B, H, W, C, s);
}

}  // namespace

// Plain C entry for ctypes. x (B, H, W, 3) NHWC fp32 contiguous, w
// (C, 3, 3, 3) OIHW fp32 contiguous, bias (C,) fp32; out (B, H/2, W/2, C)
// fp32, allocated by the caller, 16-byte aligned; device: the CUDA device
// that holds them (on_device.cuh). Launches on `stream` and returns
// cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int mc_input_stage_f32(const void* x, const void* w,
                                  const void* bias, void* out, int B, int H,
                                  int W, int C, int device, void* stream) {
  if (B < 1 || H < 2 || W < 2 || (H & 1) || (W & 1) || C < 1 || C > 32 ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorInvalidValue;
  const bool vec = W % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* bp = static_cast<const float*>(bias);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    cudaError_t err;
    if (C <= 8)
      err = launch_cp<8>(vec, xp, wp, bp, op, B, H, W, C, s);
    else if (C <= 16)
      err = launch_cp<16>(vec, xp, wp, bp, op, B, H, W, C, s);
    else
      err = launch_cp<32>(vec, xp, wp, bp, op, B, H, W, C, s);
    return (int)err;
  });
}
