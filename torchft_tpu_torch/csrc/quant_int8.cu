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
// gradient (2 x 136 M elements) that is ~0.41 ms of HBM time for
// quant_int8. This simple version runs one block per (row, chunk) and
// reads the chunk twice (absmax, then quantize), the second time mostly
// from L2; the dequantizer is a grid-stride elementwise loop.
#include <cuda_runtime.h>
#include <stdint.h>

namespace tft {

constexpr int kQuantThreads = 512;
constexpr int kDequantThreads = 256;

__global__ void __launch_bounds__(kQuantThreads)
    quant_int8_kernel(const float* __restrict__ x, long long ldx,
                      int8_t* __restrict__ q, long long ldq,
                      float* __restrict__ scales, long long n, long long step,
                      long long cpr) {
  __shared__ float s_max[kQuantThreads / 32];
  __shared__ int s_bad[kQuantThreads / 32];
  __shared__ float s_scale;
  __shared__ int s_nonfinite;

  const long long blk = blockIdx.x;
  const long long row = blk / cpr, c = blk % cpr;
  const long long lo = c * step;
  const long long hi = lo + step < n ? lo + step : n;
  const float* xr = x + row * ldx;
  int8_t* qr = q + row * ldq;

  float m = 0.0f;
  int bad = 0;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const float v = xr[i];
    if (!isfinite(v)) bad = 1;  // fmaxf drops NaN: carry the flag apart
    m = fmaxf(m, fabsf(v));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    bad |= __shfl_xor_sync(0xffffffffu, bad, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
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
      float scale;
      if (bad)
        scale = __int_as_float(0x7fc00000);  // NaN
      else if (m > 0.0f)
        scale = __double2float_rn(__ddiv_rn((double)m, 127.0));
      else
        scale = 1.0f;
      s_scale = scale;
      s_nonfinite = bad;
      scales[row * cpr + c] = scale;
    }
  }
  __syncthreads();
  const float scale = s_scale;
  const int nonfinite = s_nonfinite;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    int8_t out = 0;
    if (!nonfinite) {
      float r = rintf(__fdiv_rn(xr[i], scale));
      r = fminf(fmaxf(r, -127.0f), 127.0f);
      out = (int8_t)(int)r;
    }
    qr[i] = out;
  }
}

__global__ void __launch_bounds__(kDequantThreads)
    dequant_acc_int8_kernel(const int8_t* __restrict__ q, long long ldq,
                            const float* __restrict__ scales, long long lds,
                            float* __restrict__ out, int n_src, long long N,
                            long long valid, long long seg, long long cps,
                            long long step, int divisor) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < N;
       j += stride) {
    if (j >= valid) {
      out[j] = 0.0f;
      continue;
    }
    const long long chunk = (j / seg) * cps + (j % seg) / step;
    float acc = 0.0f;
    for (int r = 0; r < n_src; ++r) {
      const float v = (float)q[r * ldq + j];
      acc = __fadd_rn(acc, __fmul_rn(v, scales[r * lds + chunk]));
    }
    if (divisor > 0) acc = __fdiv_rn(acc, (float)divisor);
    out[j] = acc;
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
  const long long blocks = rows * cpr;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  quant_int8_kernel<<<(unsigned)blocks, kQuantThreads, 0,
                      (cudaStream_t)stream>>>(
      (const float*)x, ldx, (int8_t*)q, ldq, (float*)scales, n, step, cpr);
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
  long long blocks = (N + kDequantThreads - 1) / kDequantThreads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond that
  dequant_acc_int8_kernel<<<(unsigned)blocks, kDequantThreads, 0,
                            (cudaStream_t)stream>>>(
      (const int8_t*)q, ldq, (const float*)scales, lds, (float*)out, n_src,
      N, valid, seg, cps, step, divisor);
  return (int)cudaGetLastError();
}
