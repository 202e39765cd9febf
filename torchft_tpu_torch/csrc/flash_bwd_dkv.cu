// flash_bwd_dkv: dK and dV of attention from the forward's lse and Delta.
//
// Replaces the TPU kernels _flash_bwd_dkv_kernel (K4) and
// _flash_bwd_dkv_streamed_kernel (K6) of torchft_tpu/ops/flash.py. lse and
// Delta = rowsum(dO * O) come from outside, as flash_block_attention_bwd
// needs for the ring backward. Working on the transposed scores keeps a
// block's keys the rows of every product:
//   P^T  = exp(scale * K Q^T - lse)     (mask -1e30 where key > query)
//   dS^T = P^T * (V dO^T - Delta)
//   dV  += P^T dO,   dK += dS^T Q       (P, dS kept in f32: bf16 split)
// and finally dK * scale and dV are written in bf16.
//
// Bound on an H100 at the 125m shape (B*H = 96, S = 1024, D = 64, causal):
// four S x S x D products, 25.8 GFLOP (26.1 us of bf16 tensor time),
// against 76.3 MB of Q, K, V, dO, lse, Delta, dK and dV (22.8 us of HBM
// time): operations bound. The hi + lo split doubles the two products with
// P^T and dS^T, so the tensor cores see 38.7 GFLOP (39 us at peak).
//
// Design (hopper.cuh), templated on the head size D (DkvTraits): one block
// of three warpgroups per 128 keys of one (batch, head). Warpgroup 2 is
// the producer: one thread issues TMA loads of the block's K and V tiles,
// then streams Q and dO tiles with their lse and Delta slices (1-D bulk
// copies) through a ring of kStages slots from
// the causal lower bound, and hands its registers to the consumers.
// Warpgroups 0 and 1 own 64 keys each: S^T = K Q^T and dP^T = V dO^T run
// on wgmma with K, V and the slot's Q and dO all K-major in shared memory,
// P^T and dS^T are formed in registers (exp2 of prescaled scores, the mask
// only on the diagonal tile), and dV += P^T dO, dK += dS^T Q take their hi
// and lo halves straight from those registers against the same slot's
// tiles read MN-major. The next tile's S^T and dP^T are issued right behind
// those products, so a warpgroup's 24 multiplies of a tile reach the tensor
// cores back to back. A warpgroup skips a query tile that lies wholly
// before its keys. For S = 64 * odd the last block holds 64 keys and its
// second warpgroup stays idle. Registers per consumer thread at D = 64:
// dK, dV, S^T and dP^T take 32 f32 each, the split P^T and dS^T 64 more,
// which is why a block has two consumer warpgroups and not the forward's
// three. At D = 128 dK and dV take 64 each, and the overlap would keep 256
// live: there a warpgroup waits for its dV/dK products before it issues
// the next tile's scores (kOverlap false), so the split fragments and the
// scores are never live together (about 192), and the two warpgroups
// overlap each other instead.
#include "hopper.cuh"

namespace tft {

template <int D>
struct DkvTraits {
  static constexpr int kStages = 3;
  static constexpr int kThreads = 384;  // two consumers and the producer
  static constexpr int kStatBytes = kTile * 4;  // one tile's lse or Delta
  static constexpr int kTileBytes = TileLayout<D>::kBytes;
  static constexpr int kSmem = (4 + 2 * kStages) * kTileBytes +
                               2 * kStages * kStatBytes +
                               8 * (1 + 2 * kStages) + 1024;
  // issue tile u + 1's scores behind tile u's dV/dK products
  static constexpr bool kOverlap = D <= 64;
};

template <int D>
__global__ void __launch_bounds__(DkvTraits<D>::kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap map_q,
                         const __grid_constant__ CUtensorMap map_k,
                         const __grid_constant__ CUtensorMap map_v,
                         const __grid_constant__ CUtensorMap map_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int S,
                         int H, float scale, float scale_log2, int causal) {
  using T = DkvTraits<D>;
  constexpr int kStages = T::kStages, kTileBytes = T::kTileBytes;
  constexpr int kStatBytes = T::kStatBytes;
  constexpr bool kOverlap = T::kOverlap;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sK = smem_base_1k(smem_raw);
  uint8_t* sV = sK + 2 * kTileBytes;
  uint8_t* sQ = sV + 2 * kTileBytes;
  uint8_t* sO = sQ + kStages * kTileBytes;  // dO tiles
  float* sL = reinterpret_cast<float*>(sO + kStages * kTileBytes);
  float* sD = sL + kStages * kTile;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sD + kStages * kTile);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kb = blockIdx.y;  // causal: block 0 sweeps the most query tiles
  const int key0 = kb * 2 * kTile;
  const int n_wg = min(2, (S - key0) / kTile);
  const int nq = S / kTile;
  const int q_begin = causal ? 2 * kb : 0;
  const int n_q = nq - q_begin;
  const int wg = warpgroup();

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * n_wg);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // producer
    regs_release<24>();
    if (threadIdx.x == 256) {
      const int col = h * D, grow = b * S;
      mbar_expect_tx(kv_full, 2 * n_wg * kTileBytes);
      for (int w = 0; w < n_wg; ++w) {
        tma_load_tile<D>(sK + w * kTileBytes, &map_k, col,
                         grow + key0 + w * kTile, kv_full);
        tma_load_tile<D>(sV + w * kTileBytes, &map_v, col,
                         grow + key0 + w * kTile, kv_full);
      }
      for (int u = 0; u < n_q; ++u) {
        const int s = u % kStages, qt = q_begin + u;
        if (u >= kStages) mbar_wait(&empty[s], ((u / kStages) + 1) & 1);
        mbar_expect_tx(&full[s], 2 * kTileBytes + 2 * kStatBytes);
        tma_load_tile<D>(sQ + s * kTileBytes, &map_q, col, grow + qt * kTile,
                         &full[s]);
        tma_load_tile<D>(sO + s * kTileBytes, &map_do, col,
                         grow + qt * kTile, &full[s]);
        const size_t at = (size_t)bh * S + (size_t)qt * kTile;
        bulk_load(sL + s * kTile, lse + at, kStatBytes, &full[s]);
        bulk_load(sD + s * kTile, delta + at, kStatBytes, &full[s]);
      }
    }
    return;
  }
  regs_claim<240>();
  if (wg >= n_wg) return;

  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int kt = 2 * kb + wg;  // this warpgroup's key tile

  const uint8_t* tk = sK + wg * kTileBytes;
  const uint8_t* tv = sV + wg * kTileBytes;
  float dka[D / 2], dva[D / 2], st[32], dpt[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  uint32_t phi[4][4], plo[4][4], dhi[4][4], dlo[4][4];

  // A query tile wholly before this warpgroup's keys (its first one, for
  // warpgroup 1 under the causal mask) is skipped. A parity wait may run
  // at most one phase ahead, so a skipped slot is still waited for.
  const int u0 = (causal && q_begin < kt) ? 1 : 0;
  for (int u = 0; u < u0; ++u) {
    mbar_wait(&full[u % kStages], (u / kStages) & 1);
    if (lane == 0) mbar_arrive(&empty[u % kStages]);
  }
  mbar_wait(kv_full, 0);

  // S^T = K Q^T and dP^T = V dO^T of query tile u.
  auto issue_scores = [&](int u) {
    const int s = u % kStages;
    mbar_wait(&full[s], (u / kStages) & 1);
    wgmma_abt_ss<D>(st, tk, sQ + s * kTileBytes);
    wgmma_abt_ss<D>(dpt, tv, sO + s * kTileBytes);
    wgmma_commit();
  };
  // With tile u's scores in: P^T and dS^T, then dV += P^T dO and
  // dK += dS^T Q issued.
  auto grads = [&](int u) {
    const int s = u % kStages, qt = q_begin + u;
    const float* L = sL + s * kTile;
    const float* Dl = sD + s * kTile;
    const bool on_diag = causal && qt == kt;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int c = acc_col(i, t4);  // query within the tile (even)
      const float2 lv = *reinterpret_cast<const float2*>(L + c);
      const float2 dl = *reinterpret_cast<const float2*>(Dl + c);
      float p0 = fast_exp2(st[i] * scale_log2 - lv.x * kLog2e);
      float p1 = fast_exp2(st[i + 1] * scale_log2 - lv.y * kLog2e);
      if (on_diag) {
        const int r = acc_row(i, warp, g);  // key within the tile
        if (r > c) p0 = 0.f;
        if (r > c + 1) p1 = 0.f;
      }
      st[i] = p0;
      st[i + 1] = p1;
      dpt[i] = p0 * (dpt[i] - dl.x);
      dpt[i + 1] = p1 * (dpt[i + 1] - dl.y);
    }
    acc_to_a(st, phi, plo);
    acc_to_a(dpt, dhi, dlo);
    fence_frags(phi);
    fence_frags(plo);
    fence_frags(dhi);
    fence_frags(dlo);
    if constexpr (kOverlap) {
      fence_acc(st);  // the next issue_scores writes them
      fence_acc(dpt);
    }
    fence_acc(dka);
    fence_acc(dva);
    wgmma_fence();
    wgmma_split(dva, phi, plo, sO + s * kTileBytes);
    wgmma_split(dka, dhi, dlo, sQ + s * kTileBytes);
    wgmma_commit();
  };
  // Wait for every multiply in flight; `scores`: tile scores among them.
  auto settle = [&](bool scores) {
    wgmma_wait<0>();
    if (scores) {
      fence_acc(st);
      fence_acc(dpt);
    }
    fence_acc(dka);
    fence_acc(dva);
  };

  // Every group of multiplies is waited for in the iteration that issues
  // it; with kOverlap, tile u's products and tile u + 1's scores go to the
  // tensor cores back to back. The last tile is peeled off so that no
  // wgmma sits in a branch.
  wgmma_fence();
  issue_scores(u0);
  settle(true);
  for (int u = u0; u + 1 < n_q; ++u) {
    grads(u);
    if constexpr (!kOverlap) {
      settle(false);
      clear_acc(st);
      clear_acc(dpt);
      wgmma_fence();
    }
    issue_scores(u + 1);
    settle(true);
    if (lane == 0) mbar_arrive(&empty[u % kStages]);
  }
  grads(n_q - 1);
  settle(kOverlap);

  const int ld = H * D;
  const size_t at = (size_t)(b * S + key0 + wg * kTile) * ld + h * D;
  store_acc(dk + at, ld, dka, scale, scale, warp, g, t4);
  store_acc(dv + at, ld, dva, 1.f, 1.f, warp, g, t4);
}

template <int D>
static int launch_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int B, int S, int H, float scale,
                      int causal, cudaStream_t stream) {
  using T = DkvTraits<D>;
  const int nblk = (S + 2 * kTile - 1) / (2 * kTile);
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
  if ((rc = func_attr_once(flash_bwd_dkv_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           T::kSmem, smem_set)) != 0)
    return rc;
  dim3 grid(B * H, nblk);
  flash_bwd_dkv_kernel<D><<<grid, T::kThreads, T::kSmem, stream>>>(
      mq, mk, mv, mdo, (const float*)lse, (const float*)delta, (bf16*)dk,
      (bf16*)dv, S, H, scale, scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

}  // namespace tft

extern "C" int tft_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv, int B,
                                 int S, int H, int D, float scale, int causal,
                                 void* stream) {
  return tft::with_head_dim(D, [&](auto d) {
    return tft::launch_dkv<decltype(d)::value>(q, k, v, dout, lse, delta, dk,
                                               dv, B, S, H, scale, causal,
                                               (cudaStream_t)stream);
  });
}
