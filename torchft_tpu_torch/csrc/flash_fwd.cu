// flash_fwd: causal/non-causal attention forward with the log-sum-exp.
//
// Replaces the TPU kernels _flash_kernel (K1) and _flash_streamed_kernel
// (K2) of torchft_tpu/ops/flash.py. The TPU keeps K/V resident in VMEM or
// streams them over the grid depending on size; here one kernel streams
// 64-key K/V tiles through shared memory for every size, so the split is
// gone.
//
// Bound on an H100 at the 125m shape (B*H = 96, S = 1024, D = 64, causal):
// 12.9 GFLOP of Q K^T and P V against 50 MB of Q, K, V, O and lse, i.e.
// about 15 us of HBM time and 13 us of bf16 tensor time: bytes bound. The
// hi + lo split of P (flash_common.cuh) makes the P V products 2x, so the
// tensor cores see 19 GFLOP (20 us); the 2 x 4096 exp2 of a 64 x 64 tile
// and the bf16 conversions of the split cost about as much again on the
// SM's other units.
//
// Design (hopper.cuh): one block of four warpgroups per 192 query rows of
// one (batch, head). Warpgroup 3 is the producer: one thread issues TMA
// loads of the block's Q tiles, then of the K/V tiles into a ring of
// kFwdStages slots, each guarded by a full and an empty mbarrier, so the
// copies run while the tensor cores work; it hands its registers to the
// consumers (setmaxnreg: 24 for it, 160 for each consumer thread).
// Warpgroups 0-2 own 64 query rows each and run the online softmax in
// registers: S = Q K^T on wgmma (Q from registers, K from its swizzled
// tile), the mask only on the diagonal tile, exp2 of log2(e)-prescaled
// scores, then O += P V as two wgmmas (P's hi and lo halves from the S
// accumulator's registers, V read MN-major from its tile). Each tile's
// Q K^T is issued ahead of the previous tile's P V, so a warpgroup's
// softmax overlaps its own P V as well as the other warpgroups' products
// (FlashAttention-3's intra-warpgroup pipelining). The per-tile chain of a
// warpgroup is latency-bound, so a third consumer warpgroup (measured 4.5%
// faster than two at the 125m shape) hides more of it. The grid runs the
// heaviest causal blocks first; when S is not a multiple of 192 the last
// block holds 64 or 128 rows and its idle warpgroups return at once. O is
// written in bf16, lse = m + log(l) in f32, with the reference's l == 0
// guard.
#include "hopper.cuh"

namespace tft {

constexpr int kFwdConsumers = 3;  // warpgroups of 64 query rows a block
constexpr int kFwdRows = kFwdConsumers * kTile;
constexpr int kFwdStages = 3;
constexpr int kFwdThreads = 128 * (kFwdConsumers + 1);
// registers a consumer thread claims once the producer keeps 24: the SM's
// 65,536 less the producer's, over the consumers, a multiple of 8, <= 240
constexpr int kFwdSpareRegs = (65536 - 128 * 24) / (128 * kFwdConsumers);
constexpr int kFwdRegs = kFwdSpareRegs >= 240 ? 240 : kFwdSpareRegs / 8 * 8;
constexpr int kFwdSmem = (kFwdConsumers + 2 * kFwdStages) * kTileBytes +
                         8 * (1 + 2 * kFwdStages) + 1024;

__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     bf16* __restrict__ o, float* __restrict__ lse, int S,
                     int H, float scale_log2, int causal) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = smem_base_1k(smem_raw);
  uint8_t* sK = sQ + kFwdConsumers * kTileBytes;
  uint8_t* sV = sK + kFwdStages * kTileBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kFwdStages * kTileBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kFwdStages;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int qb = gridDim.y - 1 - blockIdx.y;  // heaviest causal block first
  const int row0 = qb * kFwdRows;
  const int n_wg = min(kFwdConsumers, (S - row0) / kTile);
  const int nk = S / kTile;
  const int n_kv = causal ? min(nk, kFwdConsumers * (qb + 1)) : nk;
  const int wg = warpgroup();

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * n_wg);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kFwdConsumers) {  // producer
    regs_release<24>();
    if (threadIdx.x == 128 * kFwdConsumers) {
      const int col = h * kHeadDim, grow = b * S;
      mbar_expect_tx(q_full, n_wg * kTileBytes);
      for (int w = 0; w < n_wg; ++w)
        tma_load_2d(sQ + w * kTileBytes, &map_q, col, grow + row0 + w * kTile,
                    q_full);
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % kFwdStages;
        if (t >= kFwdStages) mbar_wait(&empty[s], ((t / kFwdStages) + 1) & 1);
        mbar_expect_tx(&full[s], 2 * kTileBytes);
        tma_load_2d(sK + s * kTileBytes, &map_k, col, grow + t * kTile,
                    &full[s]);
        tma_load_2d(sV + s * kTileBytes, &map_v, col, grow + t * kTile,
                    &full[s]);
      }
    }
    return;
  }
  regs_claim<kFwdRegs>();
  if (wg >= n_wg) return;

  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int diag = kFwdConsumers * qb + wg;  // key tile of our diagonal
  const int upper = causal ? diag + 1 : nk;  // key tiles attended

  mbar_wait(q_full, 0);
  uint32_t qa[4][4];
  load_a_swz(qa, sQ + wg * kTileBytes, 16 * warp + g, t4);

  float acc[32], sc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  uint32_t hi[4][4], lo[4][4];       // P of the previous tile, split
  float m0 = kNegInf, m1 = kNegInf;  // running row max, log2 units
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sum
  float al0 = 1.f, al1 = 1.f;        // rescale of O for the newest tile

  // Online softmax of the scores of key tile t (in sc, as they came from
  // the tensor cores): the new row max, P = exp2 of the log2-prescaled
  // scores less it in sc, O's rescale in al0/al1, and the row sums.
  auto softmax = [&](int t) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] *= scale_log2;
    if (causal && t == diag) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (acc_col(i, t4) > acc_row(i, warp, g)) sc[i] = kNegInf;
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      mx0 = fmaxf(mx0, fmaxf(sc[i], sc[i + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[i + 2], sc[i + 3]));
    }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    al0 = fast_exp2(m0 - mx0);
    al1 = fast_exp2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      sc[i] = fast_exp2(sc[i] - m0);
      sc[i + 1] = fast_exp2(sc[i + 1] - m0);
      sc[i + 2] = fast_exp2(sc[i + 2] - m1);
      sc[i + 3] = fast_exp2(sc[i + 3] - m1);
      ps0 += sc[i] + sc[i + 1];
      ps1 += sc[i + 2] + sc[i + 3];
    }
    l0 = al0 * l0 + ps0;
    l1 = al1 * l1 + ps1;
  };
  // Once the previous P V is done: rescale O and split P for the next one.
  auto rescale_split = [&]() {
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      acc[i] *= al0;
      acc[i + 1] *= al0;
      acc[i + 2] *= al1;
      acc[i + 3] *= al1;
    }
    acc_to_a(sc, hi, lo);
  };

  mbar_wait(&full[0], 0);
  wgmma_fence();
  wgmma_abt(sc, qa, sK);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(sc);
  softmax(0);
  rescale_split();
  // Tile t: its Q K^T goes to the tensor cores ahead of the previous tile's
  // P V, so its softmax runs while P V does.
  for (int t = 1; t < upper; ++t) {
    const int s = t % kFwdStages, sp = (t - 1) % kFwdStages;
    mbar_wait(&full[s], (t / kFwdStages) & 1);
    fence_acc(sc);
    fence_acc(acc);
    fence_frags(hi);
    fence_frags(lo);
    wgmma_fence();
    wgmma_abt(sc, qa, sK + s * kTileBytes);
    wgmma_commit();
    wgmma_split(acc, hi, lo, sV + sp * kTileBytes);
    wgmma_commit();
    wgmma_wait<1>();  // Q K^T of tile t is done
    fence_acc(sc);
    softmax(t);
    wgmma_wait<0>();  // P V of tile t - 1 is done: release its slot
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[sp]);
    rescale_split();
  }
  fence_acc(acc);
  fence_frags(hi);
  fence_frags(lo);
  wgmma_fence();
  wgmma_split(acc, hi, lo, sV + ((upper - 1) % kFwdStages) * kTileBytes);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (l0 == 0.f) l0 = 1.f;
  if (l1 == 0.f) l1 = 1.f;
  const int ld = H * kHeadDim;
  const int r0 = row0 + wg * kTile;  // this warpgroup's first query
  store_acc(o + (size_t)(b * S + r0) * ld + h * kHeadDim, ld, acc, 1.f / l0,
            1.f / l1, warp, g, t4);
  if (t4 == 0) {
    const int r = r0 + 16 * warp + g;
    lse[(size_t)bh * S + r] = m0 * kLn2 + logf(l0);
    lse[(size_t)bh * S + r + 8] = m1 * kLn2 + logf(l1);
  }
}

}  // namespace tft

extern "C" int tft_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int S, int H, int D,
                             float scale, int causal, void* stream) {
  using namespace tft;
  const int nblk = (S + kFwdRows - 1) / kFwdRows;
  if (D != kHeadDim || B <= 0 || H <= 0 || S <= 0 || S % kTile != 0 ||
      nblk > 65535)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * S, cols = (long long)H * kHeadDim;
  CUtensorMap mq, mk, mv;
  int rc;
  if ((rc = make_tile_map(&mq, q, rows, cols)) != 0) return rc;
  if ((rc = make_tile_map(&mk, k, rows, cols)) != 0) return rc;
  if ((rc = make_tile_map(&mv, v, rows, cols)) != 0) return rc;
  static std::atomic<uint64_t> smem_set{0};
  if ((rc = func_attr_once(flash_fwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kFwdSmem, smem_set)) != 0)
    return rc;
  dim3 grid(B * H, nblk);
  flash_fwd_kernel<<<grid, kFwdThreads, kFwdSmem, (cudaStream_t)stream>>>(
      mq, mk, mv, (bf16*)o, (float*)lse, S, H, scale * kLog2e, causal);
  return (int)cudaGetLastError();
}
