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
// Design (hopper.cuh), templated on the head size D (FwdTraits): one block
// of C + 1 warpgroups per C x 64 query rows of one (batch, head), C = 3
// consumers at D <= 64 and 2 at D = 128. The last warpgroup is the
// producer: one thread issues TMA loads of the block's Q tiles, then of
// the K/V tiles into a ring of kStages slots, each guarded by a full and
// an empty mbarrier, so the copies run while the tensor cores work; it
// hands its registers to the consumers (setmaxnreg: 24 for it, 160 for
// each of three consumer threads, 240 for each of two). The consumers own
// 64 query rows each and run the online softmax in
// registers: S = Q K^T on wgmma (Q from registers, K from its swizzled
// tile), the mask only on the diagonal tile, exp2 of log2(e)-prescaled
// scores, then O += P V as two wgmmas (P's hi and lo halves from the S
// accumulator's registers, V read MN-major from its tile). Each tile's
// Q K^T is issued ahead of the previous tile's P V, so a warpgroup's
// softmax overlaps its own P V as well as the other warpgroups' products
// (FlashAttention-3's intra-warpgroup pipelining). The per-tile chain of a
// warpgroup is latency-bound, so a third consumer warpgroup (measured 4.5%
// faster than two at the 125m shape) hides more of it. At D = 128 the O
// accumulator (64 f32 a thread) and Q's fragments (32) double, so a
// consumer holds ~160 live registers and the block has two consumers of
// 240. The grid runs the heaviest causal blocks first; when S is not a
// multiple of C x 64 the last block holds fewer rows and its idle
// warpgroups return at once. O is written in bf16, lse = m + log(l) in
// f32, with the reference's l == 0 guard.
#include "hopper.cuh"

namespace tft {

template <int D>
struct FwdTraits {
  static constexpr int kConsumers = D == 128 ? 2 : 3;  // 64-row warpgroups
  static constexpr int kRows = kConsumers * kTile;     // query rows a block
  static constexpr int kStages = 3;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kRegs = consumer_regs(kConsumers);
  static constexpr int kTileBytes = TileLayout<D>::kBytes;
  static constexpr int kSmem = (kConsumers + 2 * kStages) * kTileBytes +
                               8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__global__ void __launch_bounds__(FwdTraits<D>::kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     bf16* __restrict__ o, float* __restrict__ lse, int S,
                     int H, float scale_log2, int causal) {
  using T = FwdTraits<D>;
  constexpr int kConsumers = T::kConsumers, kStages = T::kStages;
  constexpr int kTileBytes = T::kTileBytes, kAcc = D / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = smem_base_1k(smem_raw);
  uint8_t* sK = sQ + kConsumers * kTileBytes;
  uint8_t* sV = sK + kStages * kTileBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * kTileBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int qb = gridDim.y - 1 - blockIdx.y;  // heaviest causal block first
  const int row0 = qb * T::kRows;
  const int n_wg = min(kConsumers, (S - row0) / kTile);
  const int nk = S / kTile;
  const int n_kv = causal ? min(nk, kConsumers * (qb + 1)) : nk;
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
      mbar_expect_tx(q_full, n_wg * kTileBytes);
      for (int w = 0; w < n_wg; ++w)
        tma_load_tile<D>(sQ + w * kTileBytes, &map_q, col,
                         grow + row0 + w * kTile, q_full);
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
  const int diag = kConsumers * qb + wg;     // key tile of our diagonal
  const int upper = causal ? diag + 1 : nk;  // key tiles attended

  mbar_wait(q_full, 0);
  uint32_t qa[D / 16][4];
  load_a_swz<D>(qa, sQ + wg * kTileBytes, 16 * warp + g, t4);

  float acc[kAcc], sc[32];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
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
    for (int i = 0; i < kAcc; i += 4) {
      acc[i] *= al0;
      acc[i + 1] *= al0;
      acc[i + 2] *= al1;
      acc[i + 3] *= al1;
    }
    acc_to_a(sc, hi, lo);
  };

  mbar_wait(&full[0], 0);
  wgmma_fence();
  wgmma_abt<D>(sc, qa, sK);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(sc);
  softmax(0);
  rescale_split();
  // Tile t: its Q K^T goes to the tensor cores ahead of the previous tile's
  // P V, so its softmax runs while P V does.
  for (int t = 1; t < upper; ++t) {
    const int s = t % kStages, sp = (t - 1) % kStages;
    mbar_wait(&full[s], (t / kStages) & 1);
    fence_acc(sc);
    fence_acc(acc);
    fence_frags(hi);
    fence_frags(lo);
    wgmma_fence();
    wgmma_abt<D>(sc, qa, sK + s * kTileBytes);
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
  wgmma_split(acc, hi, lo, sV + ((upper - 1) % kStages) * kTileBytes);
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (l0 == 0.f) l0 = 1.f;
  if (l1 == 0.f) l1 = 1.f;
  const int ld = H * D;
  const int r0 = row0 + wg * kTile;  // this warpgroup's first query
  store_acc(o + (size_t)(b * S + r0) * ld + h * D, ld, acc, 1.f / l0,
            1.f / l1, warp, g, t4);
  if (t4 == 0) {
    const int r = r0 + 16 * warp + g;
    lse[(size_t)bh * S + r] = m0 * kLn2 + logf(l0);
    lse[(size_t)bh * S + r + 8] = m1 * kLn2 + logf(l1);
  }
}

template <int D>
static int launch_fwd(const void* q, const void* k, const void* v, void* o,
                      void* lse, int B, int S, int H, float scale, int causal,
                      cudaStream_t stream) {
  using T = FwdTraits<D>;
  const int nblk = (S + T::kRows - 1) / T::kRows;
  if (B <= 0 || H <= 0 || S <= 0 || S % kTile != 0 || nblk > 65535)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)B * S, cols = (long long)H * D;
  CUtensorMap mq, mk, mv;
  int rc;
  if ((rc = make_tile_map<D>(&mq, q, rows, cols)) != 0) return rc;
  if ((rc = make_tile_map<D>(&mk, k, rows, cols)) != 0) return rc;
  if ((rc = make_tile_map<D>(&mv, v, rows, cols)) != 0) return rc;
  static std::atomic<uint64_t> smem_set{0};
  if ((rc = func_attr_once(flash_fwd_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           T::kSmem, smem_set)) != 0)
    return rc;
  dim3 grid(B * H, nblk);
  flash_fwd_kernel<D><<<grid, T::kThreads, T::kSmem, stream>>>(
      mq, mk, mv, (bf16*)o, (float*)lse, S, H, scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

}  // namespace tft

extern "C" int tft_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int S, int H, int D,
                             float scale, int causal, void* stream) {
  return tft::with_head_dim(D, [&](auto d) {
    return tft::launch_fwd<decltype(d)::value>(q, k, v, o, lse, B, S, H,
                                               scale, causal,
                                               (cudaStream_t)stream);
  });
}
