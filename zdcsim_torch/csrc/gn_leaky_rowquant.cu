// Fused GroupNorm -> scale/bias -> LeakyReLU(0.1) -> per-sample symmetric int8.
//
// Replaces the Pallas TPU kernel `gn_leaky_rowquant`
// (zdcsim/ops/pallas_decode.py:308, body `_make_gn_kernel`). Computes, per
// sample of x [B, HW, C] (NHWC, groups of cg = C / G consecutive channels):
//   s1, s2 = sum x, sum x^2 over HW and the group's channels    (f32)
//   mu = s1 / n;  var = max(s2 / n - mu^2, 0);  n = HW * cg     (one pass)
//   y  = (x - mu) * (1 / sqrt(var + 1e-6)) * scale + bias
//   y  = y >= 0 ? y : 0.1 y
//   s  = max(max|y| / 127, 1e-12);  q = clip(rint(y / s), -127, 127)
// over the whole sample. rint rounds half to even, as jnp.round does. The
// JAX kernel takes lax.rsqrt; this kernel and its plain version
// (zdcsim_torch/ops/decode_kernels.py) take the IEEE 1 / sqrt.
//
// Bound on the H100: bytes. A few f32 operations per element against 3
// bytes of compulsory traffic (2 in, 1 out). On the serving tile (64
// samples of 35x19x256 bf16) the kernel must read 21.8 MB and write
// 10.9 MB: about 9.8 us at 3.35 TB/s.
//
// Design: one block of 512 threads per sample. A sample (340 KB of bf16) is
// larger than an SM's shared memory, so it is read three times (group sums;
// y and its max; quantise, recomputing y); the 21.8 MB tile stays in the
// 50 MB L2, so only the first pass goes to device memory. Each thread owns
// one block of 8 consecutive channels (one 16-byte bf16 load) and a fixed
// stride of pixels, so it keeps 8 per-channel sums in registers; the block
// reduces them per channel in shared memory in a fixed order (no atomics:
// the result does not vary from run to run), then per group. The
// elementwise transform uses __fmul_rn/__fadd_rn/__fsub_rn so the compiler
// does not contract it into FMAs: it rounds exactly as the plain version.
// A first, simple kernel: with 64 samples only 64 of 132 SMs work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxC = 1024;  // C / 8 must divide 128

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float v[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float transform(float x, float mu, float rstd, float sc, float bi) {
  float y = __fmul_rn(__fsub_rn(x, mu), rstd);
  y = __fadd_rn(__fmul_rn(y, sc), bi);
  return y >= 0.0f ? y : __fmul_rn(0.1f, y);
}

// Per-channel column sums of red[rows][c] for c < c_total, into out[c].
__device__ void column_sums(const float* red, int rows, int c_total, float* out) {
  for (int c = threadIdx.x; c < c_total; c += blockDim.x) {
    float acc = 0.0f;
    for (int k = 0; k < rows; ++k) acc += red[k * c_total + c];
    out[c] = acc;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gn_leaky_rowquant_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                             const float* __restrict__ bias, int8_t* __restrict__ q,
                             float* __restrict__ s, int hw, int c, int groups) {
  __shared__ float red[kThreads * 8];
  __shared__ float cs1[kMaxC], cs2[kMaxC];
  __shared__ float gmu[kMaxC], grs[kMaxC];
  __shared__ float wmax[kThreads / 32];

  const int ncb = c >> 3;              // channel blocks of 8
  const int cb = threadIdx.x % ncb;    // this thread's channel block
  const int p0 = threadIdx.x / ncb;    // first pixel
  const int ps = kThreads / ncb;       // pixel stride
  const T* xs = x + (size_t)blockIdx.x * hw * c + cb * 8;
  int8_t* qs = q + (size_t)blockIdx.x * hw * c + cb * 8;

  // pass 1: per-channel sums of x and x^2
  float s1[8], s2[8], v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s1[i] = s2[i] = 0.0f;
  for (int p = p0; p < hw; p += ps) {
    load8(xs + (size_t)p * c, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s1[i] += v[i];
      s2[i] = fmaf(v[i], v[i], s2[i]);
    }
  }
  // red[p0][cb*8 + i]: ps rows of c channels, kThreads * 8 slots in all
#pragma unroll
  for (int i = 0; i < 8; ++i) red[p0 * c + cb * 8 + i] = s1[i];
  __syncthreads();
  column_sums(red, ps, c, cs1);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) red[p0 * c + cb * 8 + i] = s2[i];
  __syncthreads();
  column_sums(red, ps, c, cs2);
  __syncthreads();

  const int cg = c / groups;
  const float n = (float)hw * (float)cg;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float a1 = 0.0f, a2 = 0.0f;
    for (int k = 0; k < cg; ++k) {
      a1 += cs1[g * cg + k];
      a2 += cs2[g * cg + k];
    }
    const float mu = __fdiv_rn(a1, n);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(a2, n), __fmul_rn(mu, mu)), 0.0f);
    gmu[g] = mu;
    grs[g] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, 1e-6f)));
  }
  __syncthreads();

  float mu_r[8], rs_r[8], sc_r[8], bi_r[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ch = cb * 8 + i;
    mu_r[i] = gmu[ch / cg];
    rs_r[i] = grs[ch / cg];
    sc_r[i] = scale[ch];
    bi_r[i] = bias[ch];
  }

  // pass 2: max |y| over the sample
  float amax = 0.0f;
  for (int p = p0; p < hw; p += ps) {
    load8(xs + (size_t)p * c, v);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      amax = fmaxf(amax, fabsf(transform(v[i], mu_r[i], rs_r[i], sc_r[i], bi_r[i])));
  }
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x < 32) {
    amax = threadIdx.x < kThreads / 32 ? wmax[threadIdx.x] : 0.0f;  // 0 is neutral: |y| >= 0
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (threadIdx.x == 0) wmax[0] = amax;
  }
  __syncthreads();
  const float sc = fmaxf(__fdiv_rn(wmax[0], 127.0f), 1e-12f);

  // pass 3: quantise, 8 int8 values (one 8-byte store) per load
  for (int p = p0; p < hw; p += ps) {
    load8(xs + (size_t)p * c, v);
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float r = rintf(__fdiv_rn(transform(v[i], mu_r[i], rs_r[i], sc_r[i], bi_r[i]), sc));
      r = fminf(fmaxf(r, -127.0f), 127.0f);
      const uint32_t b = (uint32_t)(uint8_t)(int8_t)r;
      if (i < 4) lo |= b << (8 * i); else hi |= b << (8 * (i - 4));
    }
    *reinterpret_cast<uint2*>(qs + (size_t)p * c) = make_uint2(lo, hi);
  }
  if (threadIdx.x == 0) s[blockIdx.x] = sc;
}

}  // namespace

// x: [b, hw, c] bf16 (x_is_bf16 = 1) or f32, 16-byte aligned; scale, bias:
// [c] f32; q: [b, hw, c] int8; s: [b] f32. c must be a multiple of 8 with
// c / 8 dividing 128, and groups must divide c. Returns cudaGetLastError()
// after the launch.
extern "C" int zdc_gn_leaky_rowquant(const void* x, int x_is_bf16, const void* scale,
                                     const void* bias, void* q, void* s, int b, int hw, int c,
                                     int groups, void* stream) {
  if (b <= 0 || hw <= 0) return (int)cudaSuccess;
  if (c <= 0 || c % 8 != 0 || 128 % (c / 8) != 0 || groups <= 0 || c % groups != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (x_is_bf16) {
    gn_leaky_rowquant_kernel<__nv_bfloat16><<<b, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (const float*)scale, (const float*)bias, (int8_t*)q,
        (float*)s, hw, c, groups);
  } else {
    gn_leaky_rowquant_kernel<float><<<b, kThreads, 0, st>>>(
        (const float*)x, (const float*)scale, (const float*)bias, (int8_t*)q, (float*)s, hw,
        c, groups);
  }
  return (int)cudaGetLastError();
}
