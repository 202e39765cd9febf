// flash_bwd_dq: dQ of attention from the forward's lse and Delta.
//
// Replaces the TPU kernels _flash_bwd_dq_kernel (K3) and
// _flash_bwd_dq_streamed_kernel (K5) of torchft_tpu/ops/flash.py. lse and
// Delta = rowsum(dO * O) come from outside, as flash_block_attention_bwd
// needs for the ring backward. Per key tile, for a block's queries:
//   P  = exp(scale * Q K^T - lse)       (mask -1e30 past the diagonal)
//   dS = P * (dO V^T - Delta)
//   dQ += dS K                           (dS kept in f32: bf16 hi + lo split)
// and finally dQ * scale is written in bf16. Nothing S x S touches memory.
//
// Bound on an H100 at the 125m shape (B*H = 96, S = 1024, D = 64, causal):
// three S x S x D products, 19.3 GFLOP (19.6 us of bf16 tensor time),
// against 63.7 MB of Q, K, V, dO, lse, Delta and dQ (19.0 us of HBM time):
// operations bound by a hair. The hi + lo split doubles the dS K product,
// so the tensor cores see 25.8 GFLOP (26.1 us at peak).
//
// Design (hopper.cuh), templated on the head size D (DqTraits): seen from
// the queries, dQ has the forward's shape without its online softmax (lse
// and Delta are given, nothing rescales). One block of C + 1 warpgroups
// per C x 64 queries of one (batch, head), C = 3 consumers at D <= 64 and
// 2 at D = 128, the heaviest causal blocks first. The last warpgroup
// is the producer: it gives its registers back, loads the block's Q and dO
// tiles once by TMA with their lse and Delta slices (1-D bulk copies), then
// streams K and V tiles from key tile 0 up to the causal diagonal through a
// ring of kStages slots under full and empty mbarriers. Each consumer
// warpgroup owns 64 queries: S = Q K^T and dP = dO V^T run on wgmma with Q,
// dO and the slot's K and V all K-major in shared memory; P = exp2 of the
// log2(e)-prescaled scores less lse (the mask on the diagonal tile only)
// and dS are formed in registers; dQ += dS K takes dS's hi and lo halves
// straight from those registers (the forward's layout for P) and reads K
// MN-major from the same slot. The next tile's S and dP are issued right
// behind that product, so a warpgroup's 16 multiplies of a tile reach the
// tensor cores back to back. When S is not a multiple of C x 64 the last
// block holds fewer queries and its idle warpgroups return at once.
// Registers per consumer thread: dQ takes D / 2 f32, S and dP 32 each and
// the split dS 32 more: at D <= 64 that fits the 160 that three consumers
// get, at D = 128 (160 live) the 240 of two. Three
// measured 7% faster than two at the 125m shape (kernel_ab.py): as in the
// forward, a warpgroup's per-tile chain (wait, exp2, split, issue) is
// latency-bound, and a third one hides more of it. That chain, the 64 x 64
// tile's fixed costs and the exp2 of every score still hold it back.
#include "hopper.cuh"

namespace tft {

template <int D>
struct DqTraits {
  static constexpr int kConsumers = D == 128 ? 2 : 3;  // 64-query warpgroups
  static constexpr int kRows = kConsumers * kTile;     // queries a block
  static constexpr int kStages = 3;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kRegs = consumer_regs(kConsumers);
  static constexpr int kStatBytes = kTile * 4;  // one tile's lse or Delta
  static constexpr int kTileBytes = TileLayout<D>::kBytes;
  static constexpr int kSmem = (2 * kConsumers + 2 * kStages) * kTileBytes +
                               2 * kConsumers * kStatBytes +
                               8 * (1 + 2 * kStages) + 1024;
  // a warpgroup that stops before the last key tiles never releases their
  // slots, so the ring must hold every tile past the first stopper's
  static_assert(kStages >= kConsumers, "ring shorter than a block");
};

template <int D>
__global__ void __launch_bounds__(DqTraits<D>::kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v,
                        const __grid_constant__ CUtensorMap map_do,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, bf16* __restrict__ dq,
                        int S, int H, float scale, float scale_log2,
                        int causal) {
  using T = DqTraits<D>;
  constexpr int kConsumers = T::kConsumers, kStages = T::kStages;
  constexpr int kTileBytes = T::kTileBytes, kStatBytes = T::kStatBytes;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = smem_base_1k(smem_raw);
  uint8_t* sO = sQ + kConsumers * kTileBytes;  // dO tiles
  uint8_t* sK = sO + kConsumers * kTileBytes;
  uint8_t* sV = sK + kStages * kTileBytes;
  float* sL = reinterpret_cast<float*>(sV + kStages * kTileBytes);
  float* sD = sL + kConsumers * kTile;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sD + kConsumers * kTile);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int qb = gridDim.y - 1 - blockIdx.y;  // heaviest causal block first
  const int row0 = qb * T::kRows;
  const int n_wg = min(kConsumers, (S - row0) / kTile);
  const int nk = S / kTile;
  const int n_kv = causal ? min(nk, kConsumers * qb + n_wg) : nk;
  const int wg = warpgroup();

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * n_wg);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {  // producer
    regs_release<24>();
    if (threadIdx.x == 128 * kConsumers) {
      const int col = h * D, grow = b * S;
      mbar_expect_tx(q_full, n_wg * (2 * kTileBytes + 2 * kStatBytes));
      for (int w = 0; w < n_wg; ++w) {
        tma_load_tile<D>(sQ + w * kTileBytes, &map_q, col,
                         grow + row0 + w * kTile, q_full);
        tma_load_tile<D>(sO + w * kTileBytes, &map_do, col,
                         grow + row0 + w * kTile, q_full);
      }
      const size_t at = (size_t)bh * S + row0;
      bulk_load(sL, lse + at, n_wg * kStatBytes, q_full);
      bulk_load(sD, delta + at, n_wg * kStatBytes, q_full);
      for (int t = 0; t < n_kv; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(&empty[s], ((t / kStages) + 1) & 1);
        mbar_expect_tx(&full[s], 2 * kTileBytes);
        tma_load_tile<D>(sK + s * kTileBytes, &map_k, col, grow + t * kTile,
                         &full[s]);
        tma_load_tile<D>(sV + s * kTileBytes, &map_v, col, grow + t * kTile,
                         &full[s]);
      }
    }
    return;
  }
  regs_claim<T::kRegs>();
  if (wg >= n_wg) return;

  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int qt = kConsumers * qb + wg;        // this warpgroup's query tile
  const int upper = causal ? qt + 1 : nk;     // key tiles attended

  const uint8_t* tq = sQ + wg * kTileBytes;
  const uint8_t* to = sO + wg * kTileBytes;
  float dqa[D / 2], sc[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
  uint32_t dhi[4][4], dlo[4][4];

  mbar_wait(q_full, 0);
  // this thread's two query rows: lse in log2 units, and Delta
  const int r0 = 16 * warp + g;
  const float ls0 = sL[wg * kTile + r0] * kLog2e;
  const float ls1 = sL[wg * kTile + r0 + 8] * kLog2e;
  const float dl0 = sD[wg * kTile + r0], dl1 = sD[wg * kTile + r0 + 8];

  // S = Q K^T and dP = dO V^T of key tile t.
  auto issue_scores = [&](int t) {
    const int s = t % kStages;
    mbar_wait(&full[s], (t / kStages) & 1);
    wgmma_abt_ss<D>(sc, tq, sK + s * kTileBytes);
    wgmma_abt_ss<D>(dp, to, sV + s * kTileBytes);
    wgmma_commit();
  };
  // With tile t's scores in: P and dS, then dQ += dS K issued.
  auto grads = [&](int t) {
    const int s = t % kStages;
    const bool on_diag = causal && t == qt;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool hi_row = (i >> 1) & 1;
      float p = fast_exp2(sc[i] * scale_log2 - (hi_row ? ls1 : ls0));
      if (on_diag && acc_col(i, t4) > acc_row(i, warp, g)) p = 0.f;
      dp[i] = p * (dp[i] - (hi_row ? dl1 : dl0));  // dS
    }
    acc_to_a(dp, dhi, dlo);
    fence_frags(dhi);
    fence_frags(dlo);
    fence_acc(sc);  // the next issue_scores writes them
    fence_acc(dp);
    fence_acc(dqa);
    wgmma_fence();
    wgmma_split(dqa, dhi, dlo, sK + s * kTileBytes);
    wgmma_commit();
  };
  auto settle = [&]() {
    wgmma_wait<0>();
    fence_acc(sc);
    fence_acc(dp);
    fence_acc(dqa);
  };

  // Every group of multiplies is waited for in the iteration that issues
  // it; tile t's dS K and tile t + 1's scores go to the tensor cores back
  // to back. The last tile is peeled off so that no wgmma sits in a branch.
  wgmma_fence();
  issue_scores(0);
  settle();
  for (int t = 0; t + 1 < upper; ++t) {
    grads(t);
    issue_scores(t + 1);
    settle();
    if (lane == 0) mbar_arrive(&empty[t % kStages]);
  }
  grads(upper - 1);
  settle();

  const int ld = H * D;
  store_acc(dq + (size_t)(b * S + row0 + wg * kTile) * ld + h * D, ld, dqa,
            scale, scale, warp, g, t4);
}

template <int D>
static int launch_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int B, int S, int H, float scale, int causal,
                     cudaStream_t stream) {
  using T = DqTraits<D>;
  const int nblk = (S + T::kRows - 1) / T::kRows;
  if (B <= 0 || H <= 0 || S <= 0 || S % kTile != 0 || nblk > 65535)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * S, cols = (long long)H * D;
  CUtensorMap mq, mk, mv, mdo;
  int rc;
  if ((rc = make_tile_map<D>(&mq, q, rows, cols)) != 0) return rc;
  if ((rc = make_tile_map<D>(&mk, k, rows, cols)) != 0) return rc;
  if ((rc = make_tile_map<D>(&mv, v, rows, cols)) != 0) return rc;
  if ((rc = make_tile_map<D>(&mdo, dout, rows, cols)) != 0) return rc;
  static std::atomic<uint64_t> smem_set{0};
  if ((rc = func_attr_once(flash_bwd_dq_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           T::kSmem, smem_set)) != 0)
    return rc;
  dim3 grid(B * H, nblk);
  flash_bwd_dq_kernel<D><<<grid, T::kThreads, T::kSmem, stream>>>(
      mq, mk, mv, mdo, (const float*)lse, (const float*)delta, (bf16*)dq, S,
      H, scale, scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

}  // namespace tft

extern "C" int tft_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int S,
                                int H, int D, float scale, int causal,
                                void* stream) {
  return tft::with_head_dim(D, [&](auto d) {
    return tft::launch_dq<decltype(d)::value>(q, k, v, dout, lse, delta, dq,
                                              B, S, H, scale, causal,
                                              (cudaStream_t)stream);
  });
}
