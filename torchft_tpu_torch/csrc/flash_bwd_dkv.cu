// flash_bwd_dkv: dK and dV of attention from the forward's lse and Delta.
//
// Replaces the TPU kernels _flash_bwd_dkv_kernel (K4) and
// _flash_bwd_dkv_streamed_kernel (K6) of torchft_tpu/ops/flash.py. lse and
// Delta = rowsum(dO * O) come from outside, as flash_block_attention_bwd
// needs for the ring backward.
//
// One block per (64-key tile, batch x head); each warp owns 16 key rows and
// sweeps the query tiles from the causal lower bound, working on the
// transposed scores so that its keys stay the rows of every product:
//   P^T  = exp(scale * K Q^T - lse)     (mask -1e30 where key > query)
//   dS^T = P^T * (V dO^T - Delta)
//   dV  += P^T dO,   dK += dS^T Q       (P, dS kept in f32: bf16 split)
// and finally writes dK * scale and dV in bf16.
//
// Bound on an H100 at the 125m shape (B*H = 96, S = 1024, D = 64, causal):
// four S x S x D products, 25.8 GFLOP (26.1 us of bf16 tensor time),
// against 76.3 MB of Q, K, V, dO, lse, Delta, dK and dV (22.8 us of HBM
// time): operations bound.
#include "flash_common.cuh"

namespace tft {

__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                         int H, float scale, int causal) {
  __shared__ __align__(16) bf16 sK[kTile * kStride];
  __shared__ __align__(16) bf16 sV[kTile * kStride];
  __shared__ __align__(16) bf16 sQ[kTile * kStride];
  __shared__ __align__(16) bf16 sO[kTile * kStride];  // dO tile
  __shared__ float sL[kTile];
  __shared__ float sD[kTile];

  const int kt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int ld = H * kHeadDim;
  const size_t base = (size_t)b * S * ld + (size_t)h * kHeadDim;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kt * kTile + warp * 16 + g, k1 = k0 + 8;

  load_tile(sK, k + base + (size_t)kt * kTile * ld, ld);
  load_tile(sV, v + base + (size_t)kt * kTile * ld, ld);
  __syncthreads();
  uint32_t ka[kDSteps][4], va[kDSteps][4];
  load_a_frags(ka, sK, warp * 16 + g, t);
  load_a_frags(va, sV, warp * 16 + g, t);

  float dka[kDTiles][4], dva[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n) {
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  }

  const int nq = S / kTile;
  const int lower = causal ? kt : 0;
  for (int qt = lower; qt < nq; ++qt) {
    __syncthreads();
    load_tile(sQ, q + base + (size_t)qt * kTile * ld, ld);
    load_tile(sO, dout + base + (size_t)qt * kTile * ld, ld);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      sL[i] = lse[(size_t)bh * S + qt * kTile + i];
      sD[i] = delta[(size_t)bh * S + qt * kTile + i];
    }
    __syncthreads();

    float pt[kRowTiles][4], dpt[kRowTiles][4];
    mma_abt(pt, ka, sQ, g, t);
    mma_abt(dpt, va, sO, g, t);
#pragma unroll
    for (int j = 0; j < kRowTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + 2 * t + (e & 1);  // query column in the tile
        float x = pt[j][e] * scale;
        if (causal && (e < 2 ? k0 : k1) > qt * kTile + qc) x = kNegInf;
        const float p = expf(x - sL[qc]);
        pt[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - sD[qc]);  // dS^T
      }
    }
    mma_xs(dva, pt, sO, g, t);
    mma_xs(dka, dpt, sQ, g, t);
  }
  store_rows(dk + base, ld, k0, dka, scale, scale, g, t);
  store_rows(dv + base, ld, k0, dva, 1.f, 1.f, g, t);
}

}  // namespace tft

extern "C" int tft_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int B,
                                 int S, int H, int D, float scale, int causal,
                                 void* stream) {
  using namespace tft;
  if (D != kHeadDim || S % kTile != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid(S / kTile, B * H);
  flash_bwd_dkv_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, S, H,
      scale, causal);
  return (int)cudaGetLastError();
}
