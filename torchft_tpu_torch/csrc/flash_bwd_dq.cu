// flash_bwd_dq: dQ of attention from the forward's lse and Delta.
//
// Replaces the TPU kernels _flash_bwd_dq_kernel (K3) and
// _flash_bwd_dq_streamed_kernel (K5) of torchft_tpu/ops/flash.py. lse and
// Delta = rowsum(dO * O) come from outside, as flash_block_attention_bwd
// needs for the ring backward.
//
// One block per (64-query tile, batch x head); each warp owns 16 query rows
// and sweeps the key tiles up to the diagonal, recomputing per tile
//   P  = exp(scale * Q K^T - lse)      (mask -1e30 past the diagonal)
//   dS = P * (dO V^T - Delta)
//   dQ += dS K                          (dS kept in f32: two-term bf16 split)
// and finally writes dQ * scale in bf16. Nothing S x S touches memory.
//
// Bound on an H100 at the 125m shape (B*H = 96, S = 1024, D = 64, causal):
// three S x S x D products, 19.3 GFLOP (19.5 us of bf16 tensor time),
// against 63.7 MB of Q, K, V, dO, lse, Delta and dQ (19.0 us of HBM time):
// operations bound by a hair. The split dS doubles the dS K product.
#include "flash_common.cuh"

namespace tft {

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq,
                        int S, int H, float scale, int causal) {
  __shared__ __align__(16) bf16 sQ[kTile * kStride];
  __shared__ __align__(16) bf16 sO[kTile * kStride];  // dO tile
  __shared__ __align__(16) bf16 sK[kTile * kStride];
  __shared__ __align__(16) bf16 sV[kTile * kStride];

  const int qt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int ld = H * kHeadDim;
  const size_t base = (size_t)b * S * ld + (size_t)h * kHeadDim;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qt * kTile + warp * 16 + g, q1 = q0 + 8;

  load_tile(sQ, q + base + (size_t)qt * kTile * ld, ld);
  load_tile(sO, dout + base + (size_t)qt * kTile * ld, ld);
  __syncthreads();
  uint32_t qa[kDSteps][4], da[kDSteps][4];
  load_a_frags(qa, sQ, warp * 16 + g, t);
  load_a_frags(da, sO, warp * 16 + g, t);
  const float lse0 = lse[(size_t)bh * S + q0], lse1 = lse[(size_t)bh * S + q1];
  const float dl0 = delta[(size_t)bh * S + q0];
  const float dl1 = delta[(size_t)bh * S + q1];

  float acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int nk = S / kTile;
  const int upper = causal ? min(nk, qt + 1) : nk;
  for (int kt = 0; kt < upper; ++kt) {
    __syncthreads();
    load_tile(sK, k + base + (size_t)kt * kTile * ld, ld);
    load_tile(sV, v + base + (size_t)kt * kTile * ld, ld);
    __syncthreads();

    float s[kRowTiles][4], dp[kRowTiles][4];
    mma_abt(s, qa, sK, g, t);
    mma_abt(dp, da, sV, g, t);
#pragma unroll
    for (int j = 0; j < kRowTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        const int kp = kt * kTile + j * 8 + 2 * t + (e & 1);
        if (causal && kp > (e < 2 ? q0 : q1)) x = kNegInf;
        const float p = expf(x - (e < 2 ? lse0 : lse1));
        s[j][e] = p * (dp[j][e] - (e < 2 ? dl0 : dl1));  // dS
      }
    }
    mma_xs(acc, s, sK, g, t);
  }
  store_rows(dq + base, ld, q0, acc, scale, scale, g, t);
}

}  // namespace tft

extern "C" int tft_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int S,
                                int H, int D, float scale, int causal,
                                void* stream) {
  using namespace tft;
  if (D != kHeadDim || S % kTile != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid(S / kTile, B * H);
  flash_bwd_dq_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, S, H, scale, causal);
  return (int)cudaGetLastError();
}
