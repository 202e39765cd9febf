// Shared constants of the flash-attention kernels (sm_90a); hopper.cuh
// holds their building blocks and includes this file.
//
// Layout: q, k, v, o, dO, dq, dk, dv are [B, S, H, D] bf16, contiguous; a
// (batch, head) pair walks rows of stride H*D. lse and delta are [B, H, S]
// f32. Tiles are 64 rows (queries or keys) by D. The head size D is a
// template parameter of every kernel, instantiated at 16, 32, 64 and 128
// (hopper.cuh's TileLayout); each entry point dispatches on it and returns
// cudaErrorInvalidValue for any other.
//
// The operands that the JAX reference keeps in f32 (the probabilities P and
// the score gradient dS) enter the tensor cores as a two-term bf16 split,
// x = hi + lo, so they keep 16 mantissa bits instead of bf16's 8; q, k, v
// and dO are bf16 already and enter exactly. TFT_SPLIT_LO=0 drops the lo
// term from every kernel: a build for the test that the tolerance needs it.
#pragma once

#ifndef TFT_SPLIT_LO
#define TFT_SPLIT_LO 1
#endif

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tft {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;             // rows of a q tile and of a k/v tile
constexpr float kNegInf = -1e30f;     // the reference's mask value

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

}  // namespace tft
