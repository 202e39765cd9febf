// Shared building blocks of the flash-attention kernels (sm_90a).
//
// Layout: q, k, v, o, dO, dq, dk, dv are [B, S, H, D] bf16, contiguous; a
// (batch, head) pair walks rows of stride H*D. lse and delta are [B, H, S]
// f32. Tiles are 64 rows (queries or keys) by D = 64.
//
// The operands that the JAX reference keeps in f32 (the probabilities P and
// the score gradient dS) enter the tensor cores as a two-term bf16 split,
// x = hi + lo, so they keep 16 mantissa bits instead of bf16's 8; q, k, v
// and dO are bf16 already and enter exactly. TFT_SPLIT_LO=0 drops the lo
// term from every kernel: a build for the test that the tolerance needs it.
//
// The helpers below are flash_bwd_dq's: mma.sync m16n8k16 on one block of
// four warps per 64-row tile, each warp owning 16 of its rows. The forward
// and dK/dV kernels use hopper.cuh.
#pragma once

#ifndef TFT_SPLIT_LO
#define TFT_SPLIT_LO 1
#endif

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tft {

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;             // rows of a q tile and of a k/v tile
constexpr int kHeadDim = 64;          // the only head size these kernels take
constexpr int kStride = kHeadDim + 8; // shared-memory row stride (bf16): the
                                      // 16-byte pad spreads fragment loads
                                      // over all 32 banks
constexpr int kDSteps = kHeadDim / 16;  // k-steps of a product over D
constexpr int kDTiles = kHeadDim / 8;   // n-tiles of an output over D
constexpr int kRowTiles = kTile / 8;    // n-tiles of a score tile over rows
constexpr float kNegInf = -1e30f;       // the reference's mask value

// D += A * B for one 16x8x16 tile: A row-major (4 regs), B column-major
// (2 regs), D/C f32 (4 regs). Fragment coordinates, with g = lane / 4 and
// t = lane % 4: a0 (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..),
// a3 (g+8, 2t+8..); b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8.., n = g);
// c0,c1 (g, 2t..2t+1), c2,c3 (g+8, 2t..2t+1).
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two f32 values as (hi, lo) bf16 pairs with x ~= hi + lo; the value with
// the lower column index sits in the low half of each register.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// Row pair (r, c..c+1) of a shared tile: a contiguous 32-bit load.
__device__ __forceinline__ uint32_t ld_row2(const bf16* s, int r, int c) {
  return *reinterpret_cast<const uint32_t*>(s + r * kStride + c);
}

// Column pair (r..r+1, c) of a shared tile, packed low = row r.
__device__ __forceinline__ uint32_t ld_col2(const bf16* s, int r, int c) {
  const uint16_t* u = reinterpret_cast<const uint16_t*>(s);
  return (uint32_t)u[r * kStride + c] |
         ((uint32_t)u[(r + 1) * kStride + c] << 16);
}

// Copy one 64 x D tile from global (row stride ld elements) to shared,
// 16 bytes per thread per pass.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int ld) {
  constexpr int kChunks = kHeadDim / 8;
  for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = (c % kChunks) * 8;
    *reinterpret_cast<uint4*>(dst + r * kStride + cc) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * ld + cc);
  }
}

// A-operand fragments of a warp's 16 rows (starting at row r0) of a shared
// tile, for all kDSteps k-steps over D.
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[kDSteps][4],
                                             const bf16* s, int r0, int t) {
#pragma unroll
  for (int kk = 0; kk < kDSteps; ++kk) {
    a[kk][0] = ld_row2(s, r0, kk * 16 + 2 * t);
    a[kk][1] = ld_row2(s, r0 + 8, kk * 16 + 2 * t);
    a[kk][2] = ld_row2(s, r0, kk * 16 + 8 + 2 * t);
    a[kk][3] = ld_row2(s, r0 + 8, kk * 16 + 8 + 2 * t);
  }
}

// acc[j] = A (16 x D, fragments a) times the transpose of the shared tile s
// (64 x D): a 16 x 64 product, one 16x8 accumulator per 8 rows of s.
__device__ __forceinline__ void mma_abt(float (&acc)[kRowTiles][4],
                                        const uint32_t (&a)[kDSteps][4],
                                        const bf16* s, int g, int t) {
#pragma unroll
  for (int j = 0; j < kRowTiles; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kDSteps; ++kk) {
      mma16816(acc[j], a[kk], ld_row2(s, j * 8 + g, kk * 16 + 2 * t),
               ld_row2(s, j * 8 + g, kk * 16 + 8 + 2 * t));
    }
  }
}

// out += X (16 x 64, f32 in accumulator layout x) times the shared tile s
// (64 x D), with X split into bf16 hi + lo terms.
__device__ __forceinline__ void mma_xs(float (&out)[kDTiles][4],
                                       const float (&x)[kRowTiles][4],
                                       const bf16* s, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kTile / 16; ++kk) {
    uint32_t hi[4], lo[4];
    split2(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
    split2(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
    split2(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
    split2(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      const uint32_t b0 = ld_col2(s, kk * 16 + 2 * t, n * 8 + g);
      const uint32_t b1 = ld_col2(s, kk * 16 + 8 + 2 * t, n * 8 + g);
      mma16816(out[n], hi, b0, b1);
#if TFT_SPLIT_LO
      mma16816(out[n], lo, b0, b1);
#endif
    }
  }
}

// Write a warp's 16 x D accumulator (rows row0 and row0 + 8 of this
// thread) times mul as bf16 into a [.., D] row-major global tile.
__device__ __forceinline__ void store_rows(bf16* dst, int ld, int row0,
                                           const float (&acc)[kDTiles][4],
                                           float mul0, float mul1, int g,
                                           int t) {
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
    const int c = n * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row0 * ld + c) =
        __floats2bfloat162_rn(acc[n][0] * mul0, acc[n][1] * mul0);
    *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)(row0 + 8) * ld + c) =
        __floats2bfloat162_rn(acc[n][2] * mul1, acc[n][3] * mul1);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffff, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffff, x, 1);
  return x + __shfl_xor_sync(0xffffffff, x, 2);
}

}  // namespace tft
