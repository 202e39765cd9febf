// Hopper (sm_90a) building blocks of the port's kernels: mbarriers, TMA
// loads, warpgroup matrix multiplies (wgmma), register hand-over, and
// kernel attributes set once per device.
//
// Operand tiles are 64 rows x 64 bf16 (128 bytes a row), loaded by TMA with
// the 128-byte swizzle: the 16-byte chunk c of row r lands at chunk
// c ^ (r % 8), in a tile aligned to 1024 bytes. wgmma reads the same tiles
// through shared-memory descriptors of that layout, either K-major (the 64
// values of a row are the reduction dimension: S = Q K^T reads K so) or
// MN-major (the rows are the reduction dimension: O += P V reads V so). A
// operands come from registers, in the mma.sync m16n8k16 fragment layout of
// each warp's 16 rows; accumulators are m64n64 f32, 32 per thread.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "flash_common.cuh"

namespace tft {

constexpr int kTileBytes = kTile * kHeadDim * 2;  // one 64 x 64 bf16 tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    asm volatile("" : "+r"(a[i / 4][i % 4]) :: "memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 =
// SWIZZLE_128B.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

// K-major tile (rows are M or N, a row's 64 values are K): k-step kk starts
// 32 bytes further into every row; 8-row groups are 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_kmajor(const uint8_t* tile, int kk) {
  return smem_desc(tile + kk * 32, 16, 1024);
}

// MN-major tile (rows are K, a row's 64 values are N): k-step kk starts 16
// rows further; the two 8-row groups of a step are 1024 bytes apart. N = 64
// is one swizzle atom wide, so the leading offset is never used.
__device__ __forceinline__ uint64_t desc_mnmajor(const uint8_t* tile, int kk) {
  return smem_desc(tile + kk * 2048, kTileBytes, 1024);
}

#define TFT_ACC32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// d (64 x 64 f32) = A (64 x 16 bf16, registers) B (16 x 64 bf16, shared)
// + (accumulate ? d : 0). TRANS_B = 0: B is K-major, 1: MN-major.
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
      : TFT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate), "n"(TRANS_B));
}

// d = A B + (accumulate ? d : 0) with A (64 x 16) and B (16 x 64) both
// K-major tiles in shared memory.
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
      : TFT_ACC32(d)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

#undef TFT_ACC32

// ------------------------------------------------------ register fragments

// bf16 pair (r, c..c+1) of a swizzled 64 x 64 tile (c even).
__device__ __forceinline__ uint32_t ld_swz(const uint8_t* tile, int r, int c) {
  return *reinterpret_cast<const uint32_t*>(
      tile + r * 128 + ((((c >> 3) ^ (r & 7))) << 4) + ((c & 7) << 1));
}

// A fragments of a warp's 16 rows (r = its first row + lane / 4) of a
// swizzled K-major tile, for the four k-steps over its 64 columns.
__device__ __forceinline__ void load_a_swz(uint32_t (&a)[4][4],
                                           const uint8_t* tile, int r, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = ld_swz(tile, r, kk * 16 + 2 * t);
    a[kk][1] = ld_swz(tile, r + 8, kk * 16 + 2 * t);
    a[kk][2] = ld_swz(tile, r, kk * 16 + 8 + 2 * t);
    a[kk][3] = ld_swz(tile, r + 8, kk * 16 + 8 + 2 * t);
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

// out += X B over the 64 rows of an MN-major tile B, with X = hi + lo.
__device__ __forceinline__ void wgmma_split(float (&out)[32],
                                            const uint32_t (&hi)[4][4],
                                            const uint32_t (&lo)[4][4],
                                            const uint8_t* tile_b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = desc_mnmajor(tile_b, kk);
    wgmma_rs<1>(out, hi[kk], db, 1);
#if TFT_SPLIT_LO
    wgmma_rs<1>(out, lo[kk], db, 1);
#endif
  }
}

// d = A B^T over the 64 columns of A (registers) and of the K-major tile B.
__device__ __forceinline__ void wgmma_abt(float (&d)[32],
                                          const uint32_t (&a)[4][4],
                                          const uint8_t* tile_b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs<0>(d, a[kk], desc_kmajor(tile_b, kk), kk > 0);
  }
}

// d = A B^T over the 64 columns of two K-major tiles in shared memory.
__device__ __forceinline__ void wgmma_abt_ss(float (&d)[32],
                                             const uint8_t* tile_a,
                                             const uint8_t* tile_b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_ss(d, desc_kmajor(tile_a, kk), desc_kmajor(tile_b, kk), kk > 0);
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

// Write a warpgroup's 64 x 64 accumulator times mul as bf16 rows of a
// [.., ld] global array, from row row0.
__device__ __forceinline__ void store_acc(bf16* dst, int ld,
                                          const float (&x)[32], float mul0,
                                          float mul1, int warp, int g,
                                          int t) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const float m = ((i >> 1) & 1) ? mul1 : mul0;
    *reinterpret_cast<__nv_bfloat162*>(
        dst + (size_t)acc_row(i, warp, g) * ld + acc_col(i, t)) =
        __floats2bfloat162_rn(x[i] * m, x[i + 1] * m);
  }
}

// --------------------------------------------------------------- host side

// A 2-D tensor map over a row-major [rows, cols] bf16 array in 64 x 64
// boxes with the 128-byte swizzle. cuTensorMapEncodeTiled is a driver
// function: it is fetched through the runtime, so the library needs no
// -lcuda. Returns a cudaError_t.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

static inline int make_tile_map(CUtensorMap* map, const void* base,
                                long long rows, long long cols) {
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
  const cuuint32_t box[2] = {kHeadDim, kTile};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
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
