// flash_fwd: causal/non-causal attention forward with the log-sum-exp.
//
// Replaces the TPU kernels _flash_kernel (K1) and _flash_streamed_kernel
// (K2) of torchft_tpu/ops/flash.py. The TPU keeps K/V resident in VMEM or
// streams them over the grid depending on size; on Hopper one kernel
// streams 64 x 64 K/V tiles through shared memory for every size, so the
// split is gone.
//
// One block per (64-query tile, batch x head); four warps, 16 query rows
// each, run the online softmax in registers: S = Q K^T on the tensor cores,
// scale, mask past the diagonal with -1e30, running max m and sum l, then
// O = O * alpha + P V with P kept in f32 (two-term bf16 split). Key tiles
// strictly past the diagonal are skipped. l == 0 is guarded as in the
// reference; O is written in bf16, lse = m + log(l) in f32.
//
// Bound on an H100 at the 125m shape (B*H = 96, S = 1024, D = 64, causal):
// 12.9 GFLOP against 50 MB of Q, K, V and O, i.e. about 15 us of HBM time
// and 13 us of bf16 tensor time. This simple kernel re-reads K/V per query
// tile, loads without cp.async/TMA and doubles the P V products for the
// split; those are the levers of a later, faster version.
#include "flash_common.cuh"

namespace tft {

__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int S, int H, float scale,
                     int causal) {
  __shared__ __align__(16) bf16 sQ[kTile * kStride];
  __shared__ __align__(16) bf16 sK[kTile * kStride];
  __shared__ __align__(16) bf16 sV[kTile * kStride];

  const int qt = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int ld = H * kHeadDim;
  const size_t base = (size_t)b * S * ld + (size_t)h * kHeadDim;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;             // this thread's rows in the tile
  const int q0 = qt * kTile + r0, q1 = q0 + 8;

  load_tile(sQ, q + base + (size_t)qt * kTile * ld, ld);
  __syncthreads();
  uint32_t qa[kDSteps][4];
  load_a_frags(qa, sQ, warp * 16 + g, t);

  float acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running row max (quad-uniform)
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sum

  const int nk = S / kTile;
  const int upper = causal ? min(nk, qt + 1) : nk;
  for (int kt = 0; kt < upper; ++kt) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(sK, k + base + (size_t)kt * kTile * ld, ld);
    load_tile(sV, v + base + (size_t)kt * kTile * ld, ld);
    __syncthreads();

    float s[kRowTiles][4];
    mma_abt(s, qa, sK, g, t);

    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kRowTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        const int kp = kt * kTile + j * 8 + 2 * t + (e & 1);
        if (causal && kp > (e < 2 ? q0 : q1)) x = kNegInf;
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = expf(m0 - mn0), alpha1 = expf(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < kRowTiles; ++j) {
      s[j][0] = expf(s[j][0] - mn0);
      s[j][1] = expf(s[j][1] - mn0);
      s[j][2] = expf(s[j][2] - mn1);
      s[j][3] = expf(s[j][3] - mn1);
      ps0 += s[j][0] + s[j][1];
      ps1 += s[j][2] + s[j][3];
    }
    l0 = alpha0 * l0 + ps0;
    l1 = alpha1 * l1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }
    mma_xs(acc, s, sV, g, t);
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (l0 == 0.f) l0 = 1.f;
  if (l1 == 0.f) l1 = 1.f;
  store_rows(o + base, ld, q0, acc, 1.f / l0, 1.f / l1, g, t);
  if (t == 0) {
    lse[(size_t)bh * S + q0] = m0 + logf(l0);
    lse[(size_t)bh * S + q1] = m1 + logf(l1);
  }
}

}  // namespace tft

extern "C" int tft_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int S, int H, int D,
                             float scale, int causal, void* stream) {
  using namespace tft;
  if (D != kHeadDim || S % kTile != 0 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid(S / kTile, B * H);
  flash_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      S, H, scale, causal);
  return (int)cudaGetLastError();
}
