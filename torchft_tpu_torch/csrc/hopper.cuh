// Hopper (sm_90a) building blocks of the port's kernels: mbarriers, TMA
// loads, warpgroup matrix multiplies (wgmma), register hand-over, and
// kernel attributes set once per device.
//
// Operand tiles are 64 rows x D bf16, D the head size (16, 32, 64 or 128;
// TileLayout<D>), loaded by TMA with the swizzle whose span is a row's
// bytes, at most 128: 32 bytes at D = 16, 64 at D = 32, 128 at D = 64.
// The 16-byte chunk c of row r lands at chunk c ^ ((r * span / 128) %
// (span / 16)), in a tile aligned to 1024 bytes. A D = 128 tile is two
// 64-column sub-tiles of the 128-byte layout, one after the other (two TMA
// boxes). wgmma reads the same tiles through shared-memory descriptors of
// that layout, either K-major (the D values of a row are the reduction
// dimension: S = Q K^T reads K so, D / 16 k-steps) or MN-major (the rows
// are the reduction dimension: O += P V reads V so, N = D). A operands
// come from registers, in the mma.sync m16n8k16 fragment layout of each
// warp's 16 rows; an m64nN accumulator is N / 2 f32 per thread.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "flash_common.cuh"

namespace tft {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The shared-memory layout of a 64 x D bf16 tile.
template <int D>
struct TileLayout {
  static_assert(D == 16 || D == 32 || D == 64 || D == 128,
                "the kernels take head sizes 16, 32, 64 and 128");
  static constexpr int kSpan = D >= 64 ? 128 : 2 * D;  // swizzle span, bytes
  static constexpr int kSubCols = kSpan / 2;       // columns of a sub-tile
  static constexpr int kSubBytes = kTile * kSpan;  // one 64-row sub-tile
  static constexpr int kSubs = D / kSubCols;       // 2 at D = 128, else 1
  static constexpr int kBytes = kTile * D * 2;     // the whole tile
  // descriptor layout type: 1 = SWIZZLE_128B, 2 = 64B, 3 = 32B
  static constexpr uint64_t kDescLayout = kSpan == 128 ? 1 : kSpan == 64 ? 2 : 3;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory, rounded up to the 1024 bytes that the
// 128-byte swizzle needs (the launch allocates 1 KB of slack for it).
__device__ __forceinline__ uint8_t* smem_base_1k(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + ((1024 - (a & 1023)) & 1023);
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Make the barriers' initialisation visible to the async (TMA) proxy.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to wait for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Spin until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}

// -------------------------------------------------------------------- TMA

// One box of the 2-D tensor map (c0 the inner coordinate, c1 the row) into
// shared memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// A 64 x D tile from column `col`, row `row` of a map made by
// make_tile_map<D>: one box per sub-tile.
template <int D>
__device__ __forceinline__ void tma_load_tile(uint8_t* dst,
                                              const CUtensorMap* map, int col,
                                              int row, uint64_t* bar) {
  using L = TileLayout<D>;
#pragma unroll
  for (int s = 0; s < L::kSubs; ++s)
    tma_load_2d(dst + s * L::kSubBytes, map, col + s * L::kSubCols, row, bar);
}

// A contiguous run of `bytes` (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ------------------------------------------------------- warpgroups

// This thread's warpgroup, read from lane 0 so that the compiler sees a
// value uniform across the warp (a branch on it then holds no divergent
// wgmma).
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffff, (int)threadIdx.x / 128, 0);
}


// The producer warpgroup gives registers back; the consumers take them.
template <int N>
__device__ __forceinline__ void regs_release() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void regs_claim() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// Registers a consumer thread of a block of `consumers` warpgroups claims
// once the producer keeps 24: the SM's 65,536 less the producer's, over
// the consumers, a multiple of 8, at most 240.
constexpr int consumer_regs(int consumers) {
  return (65536 - 128 * 24) / (128 * consumers) >= 240
             ? 240
             : (65536 - 128 * 24) / (128 * consumers) / 8 * 8;
}

// ------------------------------------------------------------------- wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pin an accumulator's or fragment's registers in program order against
// the wgmma instructions (volatile asm keeps its order): before a
// wgmma_fence, so that every value a multiply reads is computed by then,
// and after a wgmma_wait, so that nothing reads a result early.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
template <int K>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < 4 * K; ++i)
    asm volatile("" : "+r"(a[i / 4][i % 4]) :: "memory");
}

// Fresh zeros in an accumulator's registers, in program order (after a
// wgmma_wait): its old values then die where they were last read, where a
// product's "+f" operands would keep them live up to the product that
// overwrites them.
template <int N>
__device__ __forceinline__ void clear_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("mov.f32 %0, 0f00000000;\n" : "=f"(d[i]) :: "memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), layout type (TileLayout::kDescLayout).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (layout << 62);
}

// K-major 64 x D tile (rows are M or N, a row's D values are K): k-step kk
// starts 32 bytes further into every row, in the next sub-tile past 64
// columns; 8-row groups are 8 spans apart.
template <int D>
__device__ __forceinline__ uint64_t desc_kmajor(const uint8_t* tile, int kk) {
  using L = TileLayout<D>;
  const int col = 16 * kk;
  return smem_desc(tile + (col / L::kSubCols) * L::kSubBytes +
                       (col % L::kSubCols) * 2,
                   16, 8 * L::kSpan, L::kDescLayout);
}

// MN-major 64 x D tile (rows are K, a row's D values are N): k-step kk
// starts 16 rows further; the two 8-row groups of a step are 8 spans
// apart (stride offset), and the swizzle atoms across N one sub-tile apart
// (leading offset; used only at D = 128, where N spans two atoms).
template <int D>
__device__ __forceinline__ uint64_t desc_mnmajor(const uint8_t* tile, int kk) {
  using L = TileLayout<D>;
  return smem_desc(tile + kk * 16 * L::kSpan, L::kSubBytes, 8 * L::kSpan,
                   L::kDescLayout);
}

#define TFT_ACC8(d, o)                                                   \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),            \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define TFT_RS_IN(a, desc_b, accumulate, trans)                           \
  "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),                \
      "r"(accumulate), "n"(trans)

// d (64 x N f32, N / 2 a thread) = A (64 x 16 bf16, registers) B (16 x N
// bf16, shared) + (accumulate ? d : 0), N = 16, 32, 64 or 128 from d's
// size. TRANS_B = 0: B is K-major, 1: MN-major.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n"
      "}\n"
      : TFT_ACC8(d, 0)
      : TFT_RS_IN(a, desc_b, accumulate, TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n"
      "}\n"
      : TFT_ACC8(d, 0), TFT_ACC8(d, 8)
      : TFT_RS_IN(a, desc_b, accumulate, TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : TFT_ACC8(d, 0), TFT_ACC8(d, 8), TFT_ACC8(d, 16), TFT_ACC8(d, 24)
      : TFT_RS_IN(a, desc_b, accumulate, TRANS_B));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : TFT_ACC8(d, 0), TFT_ACC8(d, 8), TFT_ACC8(d, 16), TFT_ACC8(d, 24),
        TFT_ACC8(d, 32), TFT_ACC8(d, 40), TFT_ACC8(d, 48), TFT_ACC8(d, 56)
      : TFT_RS_IN(a, desc_b, accumulate, TRANS_B));
}

// d (64 x 64) = A B + (accumulate ? d : 0) with A (64 x 16) and B (16 x
// 64) both K-major tiles in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : TFT_ACC8(d, 0), TFT_ACC8(d, 8), TFT_ACC8(d, 16), TFT_ACC8(d, 24)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

#undef TFT_ACC8
#undef TFT_RS_IN

// ------------------------------------------------------ register fragments

// bf16 pair (r, c..c+1) of a swizzled 64 x D tile (c even).
template <int D>
__device__ __forceinline__ uint32_t ld_swz(const uint8_t* tile, int r, int c) {
  using L = TileLayout<D>;
  const int sub = c / L::kSubCols, cc = c % L::kSubCols;
  const int chunk = (cc >> 3) ^ (((r * L::kSpan) >> 7) & (L::kSpan / 16 - 1));
  return *reinterpret_cast<const uint32_t*>(
      tile + sub * L::kSubBytes + r * L::kSpan + (chunk << 4) +
      ((cc & 7) << 1));
}

// A fragments of a warp's 16 rows (r = its first row + lane / 4) of a
// swizzled K-major 64 x D tile, for the D / 16 k-steps over its columns.
template <int D>
__device__ __forceinline__ void load_a_swz(uint32_t (&a)[D / 16][4],
                                           const uint8_t* tile, int r, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    a[kk][0] = ld_swz<D>(tile, r, kk * 16 + 2 * t);
    a[kk][1] = ld_swz<D>(tile, r + 8, kk * 16 + 2 * t);
    a[kk][2] = ld_swz<D>(tile, r, kk * 16 + 8 + 2 * t);
    a[kk][3] = ld_swz<D>(tile, r + 8, kk * 16 + 8 + 2 * t);
  }
}

// An m64n64 accumulator x (64 rows x 64 columns, f32) as the A operand of
// the four k-steps over its columns, split into bf16 hi + lo: the columns
// of k-step kk are the accumulator's 8-column blocks 2kk and 2kk + 1.
__device__ __forceinline__ void acc_to_a(const float (&x)[32],
                                         uint32_t (&hi)[4][4],
                                         uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      split2(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1], hi[kk][r], lo[kk][r]);
    }
  }
}

// out (64 x D, D / 2 = A f32 a thread) += X B over the 64 rows of an
// MN-major 64 x D tile B, with X = hi + lo.
template <int A>
__device__ __forceinline__ void wgmma_split(float (&out)[A],
                                            const uint32_t (&hi)[4][4],
                                            const uint32_t (&lo)[4][4],
                                            const uint8_t* tile_b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = desc_mnmajor<2 * A>(tile_b, kk);
    wgmma_rs<1>(out, hi[kk], db, 1);
#if TFT_SPLIT_LO
    wgmma_rs<1>(out, lo[kk], db, 1);
#endif
  }
}

// d (64 x 64) = A B^T over the D columns of A (registers) and of the
// K-major 64 x D tile B.
template <int D>
__device__ __forceinline__ void wgmma_abt(float (&d)[32],
                                          const uint32_t (&a)[D / 16][4],
                                          const uint8_t* tile_b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_rs<0>(d, a[kk], desc_kmajor<D>(tile_b, kk), kk > 0);
  }
}

// d (64 x 64) = A B^T over the D columns of two K-major 64 x D tiles in
// shared memory.
template <int D>
__device__ __forceinline__ void wgmma_abt_ss(float (&d)[32],
                                             const uint8_t* tile_a,
                                             const uint8_t* tile_b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wgmma_ss(d, desc_kmajor<D>(tile_a, kk), desc_kmajor<D>(tile_b, kk),
             kk > 0);
  }
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Max and sum over the four threads (t = lane % 4) that share an
// accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffff, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffff, x, 1);
  return x + __shfl_xor_sync(0xffffffff, x, 2);
}

// Accumulator element i of a thread (lane = 4 g + t) of warp w sits at row
// 16 w + g + 8 ((i >> 1) & 1) and column 8 (i >> 2) + 2 t + (i & 1).
__device__ __forceinline__ int acc_col(int i, int t) {
  return 8 * (i >> 2) + 2 * t + (i & 1);
}
__device__ __forceinline__ int acc_row(int i, int warp, int g) {
  return 16 * warp + g + 8 * ((i >> 1) & 1);
}

// Write a warpgroup's 64 x N accumulator (N / 2 f32 a thread) times mul
// as bf16 rows of a [.., ld] global array, from row row0.
template <int A>
__device__ __forceinline__ void store_acc(bf16* dst, int ld,
                                          const float (&x)[A], float mul0,
                                          float mul1, int warp, int g,
                                          int t) {
#pragma unroll
  for (int i = 0; i < A; i += 2) {
    const float m = ((i >> 1) & 1) ? mul1 : mul0;
    *reinterpret_cast<__nv_bfloat162*>(
        dst + (size_t)acc_row(i, warp, g) * ld + acc_col(i, t)) =
        __floats2bfloat162_rn(x[i] * m, x[i + 1] * m);
  }
}

// --------------------------------------------------------------- host side

// A 2-D tensor map over a row-major [rows, cols] bf16 array in boxes of 64
// rows by one sub-tile's columns (TileLayout<D>), with the swizzle of that
// layout. cuTensorMapEncodeTiled is a driver function: it is fetched
// through the runtime, so the library needs no -lcuda. Returns a
// cudaError_t.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

template <int D>
static inline int make_tile_map(CUtensorMap* map, const void* base,
                                long long rows, long long cols) {
  using L = TileLayout<D>;
  static EncodeTiledFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                             cudaEnableDefault, &found);
#endif
    if (rc != cudaSuccess) return (int)rc;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorNotSupported;
    encode = reinterpret_cast<EncodeTiledFn>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)L::kSubCols, kTile};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle swizzle =
      L::kSpan == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : L::kSpan == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// f(std::integral_constant<int, D>{}) for a head size d the flash kernels
// are instantiated at (TileLayout); cudaErrorInvalidValue for any other.
template <typename F>
static inline int with_head_dim(int d, F&& f) {
  switch (d) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// Set a kernel's attribute (its dynamic shared-memory limit, or leave to
// launch clusters of a non-portable size) to `value` on the current device,
// once per device: `done` holds a bit for each device already set, so
// later launches skip cudaFuncSetAttribute. Returns a cudaError_t.
template <typename Kernel>
static inline int func_attr_once(Kernel kernel, cudaFuncAttribute attr,
                                 int value, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return 0;
  e = cudaFuncSetAttribute(kernel, attr, value);
  if (e != cudaSuccess) return (int)e;
  done.fetch_or(bit, std::memory_order_release);
  return 0;
}

}  // namespace tft
