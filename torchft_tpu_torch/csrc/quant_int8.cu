// quant_int8 and dequant_acc_int8: the int8 block codec of the on-device
// gradient plane (torchft_tpu_torch/comm/cuda_backend.py).
//
// quant_int8 replaces the TPU kernel _pallas_quant_kernel (K7, launched by
// pallas_block_quant) of torchft_tpu/comm/xla_backend.py. Per block of
// `step` elements on the chunk grid of each row: absmax, scale =
// f32(f64(absmax) / 127) (1 when absmax is 0, NaN when a value is not
// finite), q = clip(rint(x / scale), -127, 127) as int8 (0 when not
// finite). That is the reference's default, bitwise quantizer
// (_dev_quant_int8, equal to the host _Int8Codec._quantize), not the
// Pallas kernel's f32 scale, which a TPU without f64 forced and which
// bought only +-1 parity. The H100 divides in f64 natively.
//
// dequant_acc_int8 is the owner side the reference leaves to XLA
// (reduce_int8): out[j] = sum over sources r, in rank order, of
// f32(q[r][j]) * scale[r][chunk(j)], each product and each add rounded to
// f32, then an optional / divisor. chunk(j) = (j / seg) * cps +
// (j % seg) / step covers the three layouts the plane needs: one grid over
// the whole payload (seg >= N), and per-shard or per-row grids (seg = the
// shard or row length, cps = chunks per segment). j >= valid is padding
// and is written as 0.
//
// Every rounding is explicit (__ddiv_rn, __fdiv_rn, __fmul_rn, __fadd_rn,
// rintf): nvcc contracts a * b + c into one FMA by default, which would
// skip the product's rounding and break bitwise parity with numpy.
//
// Bound on an H100: both are pure streams. quant_int8 reads 4 B and writes
// 1 B per element (plus 4 B per chunk); dequant_acc_int8 reads 1 B per
// element per source (plus the scales) and writes 4 B. At the 125m
// gradient (2 x 136 M elements) that is 0.41 ms of HBM time for quant_int8
// and 0.24 ms for dequant_acc_int8.
//
// quant_int8's design: one thread-block cluster of kQuantCluster CTAs per
// (row, chunk), launched with cudaLaunchKernelEx. Each CTA owns a slice of
// the chunk (16,384 f32 at the plane's 1 MiB grid), loads it once with
// 16-byte loads into registers (scalar loads for an unaligned head and the
// tail: rows of x and q may start on any 4-byte or 1-byte boundary), and
// reduces its absmax and, apart, its non-finite flag. The CTAs swap those
// partials through distributed shared memory between two cluster
// barriers; every CTA derives the same scale from the same exact max, rank
// 0 writes it, and each CTA quantizes the values it holds (quant1: a
// multiply by the reciprocal, the exact division only where it can change
// the result) and stores them four to a 32-bit word. So x is read once: 5 B
// an element. A short chunk (the tail, a small shard grid) leaves CTAs with
// shorter or empty slices; a chunk longer than a cluster holds (a grid
// coarser than 1 MiB) reads its excess twice. Two CTAs share an SM (62
// registers a thread), so one can load while the other reduces or stores.
// What still holds it back (0.74 ms against 0.41 at the 125m gradient):
// every CTA runs load, cluster barrier, quantize and store once, then
// exits; the cluster's barrier and the launch of the next cluster leave
// the SM's memory pipe idle between waves. A persistent cluster that
// prefetches its next chunk into shared memory (1-D TMA) would hide that.
//
// dequant_acc_int8's design: each thread decodes a run of kRun = 16
// consecutive elements, reading each source row's 16 int8 as one 16-byte
// load; a warp's 32 runs, 512 consecutive floats of out, pass through
// shared memory so that each of its four 16-byte stores a thread writes
// 512 contiguous bytes across the warp (a thread's own run written
// directly, 64 bytes apart across the warp, measured 1.31x slower at the
// 125m gradient). The runs start where row 0 of q is 16-byte aligned, and
// the first threads handle the scalar head before it and the scalar tail
// past the last run (a row of another phase is read byte by byte, a
// partial last warp or an unaligned out stored element by element). The
// chunk index (64-bit divisions) and each source's scale are found once
// per run. A run crosses a chunk boundary only where `step` or `seg` falls
// inside it, and a run that does, or that straddles `valid`, takes the
// element-by-element path (dequant1), the same products and sums in the
// same order. One run per thread and blocks of 128 threads: the drill's
// smallest launch (787,968 elements) is 385 blocks, one wave on 132 SMs.
#include <cooperative_groups.h>

#include "hopper.cuh"

namespace tft {

namespace cg = cooperative_groups;

// CTAs per (row, chunk): 16 is past the portable 8, and measured faster
// at the 125m gradient (two CTAs of 512 threads per SM; kernel_ab.py)
constexpr int kQuantCluster = 16;
constexpr int kQuantThreads = 512;
constexpr int kQuantVecs = 8;        // float4s a thread holds
constexpr int kQuantHeld = kQuantThreads * kQuantVecs;  // float4s a CTA holds
constexpr int kDequantThreads = 128;
constexpr int kRun = 16;  // elements a dequant thread decodes per source row

__device__ __forceinline__ void absmax1(float v, float& m, int& bad) {
  if (!isfinite(v)) bad = 1;  // fmaxf drops NaN: carry the flag apart
  m = fmaxf(m, fabsf(v));
}

__device__ __forceinline__ void absmax4(float4 v, float& m, int& bad) {
  absmax1(v.x, m, bad);
  absmax1(v.y, m, bad);
  absmax1(v.z, m, bad);
  absmax1(v.w, m, bad);
}

// rint(v / scale) clipped to [-127, 127], as a byte, with the quotient
// correctly rounded (__fdiv_rn) as the reference's. The division costs
// about ten instructions, so it is taken only where it can matter: y = v *
// rcp, rcp = 1 / scale correctly rounded, lies within 2^-16 of the rounded
// quotient (both are within 2^-17 + 2^-18 of v / scale, which is at most
// ~127 in size), and rint is constant between half-integers, so rint(y) is
// the answer unless y lies within 2^-14 of a half-integer (about one value
// in 8,000) or is not finite (a reciprocal that overflowed).
__device__ __forceinline__ uint32_t quant1(float v, float scale, float rcp) {
  const float y = __fmul_rn(v, rcp);
  float r = rintf(y);
  if (!(fabsf(__fsub_rn(y, r)) < 0.5f - 0x1p-14f))
    r = rintf(__fdiv_rn(v, scale));
  r = fminf(fmaxf(r, -127.0f), 127.0f);
  return (uint32_t)(uint8_t)(int8_t)(int)r;
}

// Four int8 of a float4, packed little-endian; 0 for a non-finite chunk.
__device__ __forceinline__ uint32_t quant4(float4 v, float scale, float rcp,
                                           int nonfinite) {
  if (nonfinite) return 0u;
  return quant1(v.x, scale, rcp) | (quant1(v.y, scale, rcp) << 8) |
         (quant1(v.z, scale, rcp) << 16) | (quant1(v.w, scale, rcp) << 24);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__global__ void __launch_bounds__(kQuantThreads, 2)
    quant_int8_kernel(const float* __restrict__ x, long long ldx,
                      int8_t* __restrict__ q, long long ldq,
                      float* __restrict__ scales, long long n, long long step,
                      long long cpr, long long slice) {
  __shared__ float s_max[kQuantThreads / 32];
  __shared__ int s_bad[kQuantThreads / 32];
  __shared__ float s_part_max;  // this CTA's partials, read by the cluster
  __shared__ int s_part_bad;
  __shared__ float s_scale;
  __shared__ int s_nonfinite;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long blk = blockIdx.x / kQuantCluster;
  const long long row = blk / cpr, c = blk % cpr;
  const long long end = min(c * step + step, n);
  const long long a = min(c * step + rank * slice, end);  // this CTA's slice
  const long long e = min(a + slice, end);
  const float* xr = x + row * ldx;
  int8_t* qr = q + row * ldq;
  // [a, va) scalar head, [va, vb) float4s, [vb, e) scalar tail
  const int mis = (int)((reinterpret_cast<uintptr_t>(xr + a) >> 2) & 3);
  const long long va = min(a + ((4 - mis) & 3), e);
  const long long nvec = (e - va) / 4;
  const long long vb = va + 4 * nvec;
  const int nh = (int)(va - a), nt = (int)(e - vb);
  const float4* xv = reinterpret_cast<const float4*>(xr + va);
  const int tid = threadIdx.x;

  float m = 0.0f;
  int bad = 0;
  float4 v[kQuantVecs];
#pragma unroll
  for (int j = 0; j < kQuantVecs; ++j) {
    const long long k = (long long)j * kQuantThreads + tid;
    if (k < nvec) {
      v[j] = xv[k];
      absmax4(v[j], m, bad);
    }
  }
  // a slice longer than the CTA holds: its excess is read again below
  for (long long k = kQuantHeld + tid; k < nvec; k += kQuantThreads)
    absmax4(xv[k], m, bad);
  float hx = 0.0f, tx = 0.0f;
  if (tid < nh) absmax1(hx = xr[a + tid], m, bad);
  if (tid < nt) absmax1(tx = xr[vb + tid], m, bad);

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    bad |= __shfl_xor_sync(0xffffffffu, bad, off);
  }
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) {
    s_max[warp] = m;
    s_bad[warp] = bad;
  }
  __syncthreads();
  if (warp == 0) {
    m = lane < kQuantThreads / 32 ? s_max[lane] : 0.0f;
    bad = lane < kQuantThreads / 32 ? s_bad[lane] : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      bad |= __shfl_xor_sync(0xffffffffu, bad, off);
    }
    if (lane == 0) {
      s_part_max = m;
      s_part_bad = bad;
    }
  }
  cluster.sync();  // every CTA's partials are written
  if (warp == 0) {
    m = 0.0f;
    bad = 0;
    if (lane < kQuantCluster) {
      m = *cluster.map_shared_rank(&s_part_max, lane);
      bad = *cluster.map_shared_rank(&s_part_bad, lane);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      bad |= __shfl_xor_sync(0xffffffffu, bad, off);
    }
    if (lane == 0) {
      float scale;
      if (bad)
        scale = __int_as_float(0x7fc00000);  // NaN
      else if (m > 0.0f)
        scale = __double2float_rn(__ddiv_rn((double)m, 127.0));
      else
        scale = 1.0f;
      s_scale = scale;
      s_nonfinite = bad;
      if (rank == 0) scales[row * cpr + c] = scale;
    }
  }
  __syncthreads();
  cluster_arrive();  // this CTA has read the others' partials

  const float scale = s_scale;
  const float rcp = __frcp_rn(scale);
  const int nonfinite = s_nonfinite;
  // q's words line up with x's float4s only when both rows share the phase
  const bool words = ((reinterpret_cast<uintptr_t>(qr + va)) & 3) == 0;
  auto store4 = [&](long long k, uint32_t w) {
    if (words) {
      reinterpret_cast<uint32_t*>(qr + va)[k] = w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) qr[va + 4 * k + i] = (int8_t)(w >> (8 * i));
    }
  };
#pragma unroll
  for (int j = 0; j < kQuantVecs; ++j) {
    const long long k = (long long)j * kQuantThreads + tid;
    if (k < nvec) store4(k, quant4(v[j], scale, rcp, nonfinite));
  }
  for (long long k = kQuantHeld + tid; k < nvec; k += kQuantThreads)
    store4(k, quant4(xv[k], scale, rcp, nonfinite));
  if (tid < nh) qr[a + tid] = nonfinite ? 0 : (int8_t)quant1(hx, scale, rcp);
  if (tid < nt) qr[vb + tid] = nonfinite ? 0 : (int8_t)quant1(tx, scale, rcp);
  cluster_wait();  // no CTA leaves while another may read its partials
}

// acc + v * s with both roundings: nvcc would contract it into one FMA,
// which skips the product's rounding and breaks bitwise parity with numpy.
__device__ __forceinline__ float mul_add_rn(float acc, float v, float s) {
  return __fadd_rn(acc, __fmul_rn(v, s));
}

__device__ __forceinline__ float finish(float acc, int divisor) {
  return divisor > 0 ? __fdiv_rn(acc, (float)divisor) : acc;
}

// out[j] alone: 0 past `valid`, else the sum over the sources in order.
__device__ __forceinline__ float dequant1(const int8_t* __restrict__ q,
                                         long long ldq,
                                         const float* __restrict__ scales,
                                         long long lds, int n_src,
                                         long long j, long long valid,
                                         long long seg, long long cps,
                                         long long step, int divisor) {
  if (j >= valid) return 0.0f;
  const long long chunk = (j / seg) * cps + (j % seg) / step;
  float acc = 0.0f;
  for (int r = 0; r < n_src; ++r)
    acc = mul_add_rn(acc, (float)q[r * ldq + j], scales[r * lds + chunk]);
  return finish(acc, divisor);
}

__global__ void __launch_bounds__(kDequantThreads)
    dequant_acc_int8_kernel(const int8_t* __restrict__ q, long long ldq,
                            const float* __restrict__ scales, long long lds,
                            float* __restrict__ out, int n_src, long long N,
                            long long valid, long long seg, long long cps,
                            long long step, int divisor, long long head,
                            long long n_runs) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // the scalar head [0, head) and tail [tail0, N): fewer than 16 each
  const long long tail0 = head + kRun * n_runs;
  if (k < head)
    out[k] = dequant1(q, ldq, scales, lds, n_src, k, valid, seg, cps, step,
                      divisor);
  if (k < N - tail0)
    out[tail0 + k] = dequant1(q, ldq, scales, lds, n_src, tail0 + k, valid,
                              seg, cps, step, divisor);
  if (k >= n_runs) return;

  const long long j0 = head + kRun * k;
  float* o = out + j0;
  float acc[kRun];
  const long long s0 = j0 / seg, o0 = j0 - s0 * seg;
  const long long c0 = o0 / step;
  if (j0 + kRun <= valid && o0 + kRun <= seg &&
      o0 - c0 * step + kRun <= step) {  // one chunk, all valid
    const long long chunk = s0 * cps + c0;
#pragma unroll
    for (int i = 0; i < kRun; ++i) acc[i] = 0.0f;
    for (int r = 0; r < n_src; ++r) {
      const int8_t* src = q + r * ldq + j0;
      uint32_t w[4];
      if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        const int4 v = *reinterpret_cast<const int4*>(src);
        w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
      } else {  // a row of another phase than row 0's
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = (uint32_t)(uint8_t)src[4 * i] |
                 ((uint32_t)(uint8_t)src[4 * i + 1] << 8) |
                 ((uint32_t)(uint8_t)src[4 * i + 2] << 16) |
                 ((uint32_t)(uint8_t)src[4 * i + 3] << 24);
      }
      const float sc = scales[r * lds + chunk];
#pragma unroll
      for (int i = 0; i < kRun; ++i)
        acc[i] = mul_add_rn(acc[i], (float)(int8_t)(w[i / 4] >> (8 * (i % 4))),
                            sc);
    }
#pragma unroll
    for (int i = 0; i < kRun; ++i) acc[i] = finish(acc[i], divisor);
  } else {  // a chunk or segment boundary, or `valid`, inside the run
#pragma unroll
    for (int i = 0; i < kRun; ++i)
      acc[i] = dequant1(q, ldq, scales, lds, n_src, j0 + i, valid, seg, cps,
                        step, divisor);
  }
  const int lane = threadIdx.x & 31;
  const long long k0 = k - lane;  // the warp's first run
  if (k0 + 32 <= n_runs &&
      (reinterpret_cast<uintptr_t>(out + head) & 15) == 0) {
    // the warp's 32 runs are 512 consecutive floats: stage them in shared
    // memory (rows of 20 floats: conflict-free float4 writes) and store
    // them 512 contiguous bytes per instruction
    __shared__ __align__(16) float stage[kDequantThreads / 32][32 * 20];
    float* w = stage[threadIdx.x >> 5];
#pragma unroll
    for (int i = 0; i < kRun; i += 4)
      *reinterpret_cast<float4*>(w + lane * 20 + i) =
          make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
    __syncwarp();
    float* wo = out + head + kRun * k0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = lane + 32 * i;
      *reinterpret_cast<float4*>(wo + 4 * f) =
          *reinterpret_cast<const float4*>(w + (f >> 2) * 20 + (f & 3) * 4);
    }
  } else {  // the last, partial warp, or an unaligned out
#pragma unroll
    for (int i = 0; i < kRun; ++i) o[i] = acc[i];
  }
}

}  // namespace tft

extern "C" int tft_quant_int8(const void* x, long long ldx, void* q,
                              long long ldq, void* scales, long long rows,
                              long long n, long long step, void* stream) {
  using namespace tft;
  if (rows <= 0 || n <= 0) return 0;
  if (step <= 0) return (int)cudaErrorInvalidValue;
  const long long cpr = (n + step - 1) / step;
  const long long blocks = rows * cpr * kQuantCluster;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  // the CTAs' slices, whole float4s; past 4 kQuantHeld f32 a CTA reads
  // its excess twice
  long long slice = (step + kQuantCluster - 1) / kQuantCluster;
  slice = (slice + 3) / 4 * 4;
  static std::atomic<uint64_t> cluster_set{0};
  int rc = func_attr_once(quant_int8_kernel,
                          cudaFuncAttributeNonPortableClusterSizeAllowed, 1,
                          cluster_set);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks);
  cfg.blockDim = dim3(kQuantThreads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kQuantCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, quant_int8_kernel, (const float*)x, ldx, (int8_t*)q, ldq,
      (float*)scales, n, step, cpr, slice);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int tft_dequant_acc_int8(const void* q, long long ldq,
                                    const void* scales, long long lds,
                                    void* out, int n_src, long long N,
                                    long long valid, long long seg,
                                    long long cps, long long step,
                                    int divisor, void* stream) {
  using namespace tft;
  if (N <= 0) return 0;
  if (n_src <= 0 || seg <= 0 || step <= 0) return (int)cudaErrorInvalidValue;
  // the runs start where row 0 of q is 16-byte aligned
  long long head = (16 - (long long)(reinterpret_cast<uintptr_t>(q) & 15)) & 15;
  if (head > N) head = N;
  const long long n_runs = (N - head) / kRun;
  const long long threads = n_runs > kRun ? n_runs : kRun;
  const long long blocks = (threads + kDequantThreads - 1) / kDequantThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  dequant_acc_int8_kernel<<<(unsigned)blocks, kDequantThreads, 0,
                            (cudaStream_t)stream>>>(
      (const int8_t*)q, ldq, (const float*)scales, lds, (float*)out, n_src,
      N, valid, seg, cps, step, divisor, head, n_runs);
  return (int)cudaGetLastError();
}
