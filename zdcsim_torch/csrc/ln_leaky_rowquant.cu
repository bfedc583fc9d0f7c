// Fused LayerNorm -> scale/bias -> LeakyReLU(0.1) -> per-row symmetric int8.
//
// Replaces the Pallas TPU kernel `ln_leaky_rowquant`
// (zdcsim/ops/pallas_decode.py:74, body `_ln_quant_kernel`). Computes, per
// row of y [B, F]:
//   mu = mean(y); var = mean((y - mu)^2)            (f32, centred two-pass)
//   z  = (y - mu) / sqrt(var + 1e-6) * scale + bias
//   z  = z >= 0 ? z : 0.1 z
//   s  = max(max|z| / 127, 1e-12);  q = clip(rint(z / s), -127, 127)
// rint rounds half to even, as jnp.round does.
//
// Bound on the H100: bytes. Each element costs a handful of f32 operations
// against 3 bytes of compulsory traffic (2 in, 1 out), far below the card's
// ~20 operations per byte in f32. On the serving tile (64 rows of 92160) the
// kernel must read 11.8 MB and write 5.9 MB: about 5.3 us at 3.35 TB/s.
//
// Design: one block of 1024 threads per row. The row is read four times
// (mean, centred variance, amax, quantise), but a 184 KB row - and the whole
// 11.8 MB tile - stays in the 50 MB L2, so only the first pass goes to
// device memory. Block reductions are warp shuffles plus one shared-memory
// step. The elementwise transform uses __fmul_rn/__fadd_rn so the compiler
// does not contract it into FMAs: it rounds exactly as the plain PyTorch
// version (zdcsim_torch/ops/decode_kernels.py) does. A first, simple kernel:
// with 64 rows only 64 of 132 SMs work; splitting rows over blocks is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ float load_f32(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}

// Sum (is_max = false) or max over the block; every thread gets the result.
__device__ float block_reduce(float v, bool is_max, float* red) {
  for (int o = 16; o > 0; o >>= 1) {
    float u = __shfl_xor_sync(0xffffffffu, v, o);
    v = is_max ? fmaxf(v, u) : v + u;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red[] may still be read by a previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = (lane < (int)(blockDim.x >> 5)) ? red[lane] : 0.0f;  // 0 is neutral: max is over |z|
    for (int o = 16; o > 0; o >>= 1) {
      float u = __shfl_xor_sync(0xffffffffu, v, o);
      v = is_max ? fmaxf(v, u) : v + u;
    }
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

template <typename T>
__device__ __forceinline__ float transform(const T* row, const float* scale,
                                           const float* bias, int i, float mu,
                                           float rstd) {
  float z = __fmul_rn(load_f32(row, i) - mu, rstd);
  z = __fadd_rn(__fmul_rn(z, scale[i]), bias[i]);
  return z >= 0.0f ? z : __fmul_rn(0.1f, z);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_leaky_rowquant_kernel(const T* __restrict__ y, const float* __restrict__ scale,
                             const float* __restrict__ bias, int8_t* __restrict__ q,
                             float* __restrict__ s, int f) {
  __shared__ float red[33];
  const T* row = y + (size_t)blockIdx.x * f;
  int8_t* qrow = q + (size_t)blockIdx.x * f;

  float acc = 0.0f;
  for (int i = threadIdx.x; i < f; i += blockDim.x) acc += load_f32(row, i);
  const float mu = block_reduce(acc, false, red) / (float)f;

  acc = 0.0f;
  for (int i = threadIdx.x; i < f; i += blockDim.x) {
    const float d = load_f32(row, i) - mu;
    acc = fmaf(d, d, acc);
  }
  const float var = block_reduce(acc, false, red) / (float)f;
  const float rstd = 1.0f / sqrtf(var + 1e-6f);

  float amax = 0.0f;
  for (int i = threadIdx.x; i < f; i += blockDim.x)
    amax = fmaxf(amax, fabsf(transform(row, scale, bias, i, mu, rstd)));
  amax = block_reduce(amax, true, red);
  const float sc = fmaxf(amax / 127.0f, 1e-12f);

  for (int i = threadIdx.x; i < f; i += blockDim.x) {
    float r = rintf(transform(row, scale, bias, i, mu, rstd) / sc);
    r = fminf(fmaxf(r, -127.0f), 127.0f);
    qrow[i] = (int8_t)r;
  }
  if (threadIdx.x == 0) s[blockIdx.x] = sc;
}

}  // namespace

// y: [b, f] bf16 (y_is_bf16 = 1) or f32; scale, bias: [f] f32;
// q: [b, f] int8; s: [b] f32. Returns cudaGetLastError() after the launch.
extern "C" int zdc_ln_leaky_rowquant(const void* y, int y_is_bf16, const void* scale,
                                     const void* bias, void* q, void* s, int b, int f,
                                     void* stream) {
  if (b <= 0 || f <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (y_is_bf16) {
    ln_leaky_rowquant_kernel<__nv_bfloat16><<<b, kThreads, 0, st>>>(
        (const __nv_bfloat16*)y, (const float*)scale, (const float*)bias, (int8_t*)q,
        (float*)s, f);
  } else {
    ln_leaky_rowquant_kernel<float><<<b, kThreads, 0, st>>>(
        (const float*)y, (const float*)scale, (const float*)bias, (int8_t*)q, (float*)s,
        f);
  }
  return (int)cudaGetLastError();
}
