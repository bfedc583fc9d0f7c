// The fused int8 post-MLP decode of the full-width proton generator, front
// half (G) and whole (H), as a short fixed sequence of launches.
//
// Replaces the Pallas TPU kernels `fused_decode_front`
// (zdcsim/ops/pallas_decode_fused.py:586, body `_make_front_kernel`) and
// `fused_decode` (:479, body `_make_fused_kernel`); both share the front
// stages `_front_stages` (:215), as G and H share `run_front` here. Per
// sample, from the Dense_1 output x [92160] (18 x 10 x 512, HWC):
//
//   front (G; launches 1-3)
//   1. LayerNorm (two-pass, eps 1e-6) -> scale/bias -> LeakyReLU(0.1) ->
//      per-sample int8: xq = rint(z / sx), sx = max(max|z| / 127, 1e-12).
//   2. Conv_0 = nearest-2x upsample + 4x4 pad-1 conv as four parity phases
//      (25 taps, int32 sums), epilogue (f32(acc) * sk[p]) * sx + bias0 kept
//      in f32 on the 35 x 19 grid.
//   3. GroupNorm_0 (32 groups of 8, one pass: var = max(E[y^2] - E[y]^2, 0),
//      eps 1e-6) -> scale/bias -> leaky -> ONE per-sample int8 scale s1 over
//      the 35 x 19 grid, written through the nearest resize to 56 x 30:
//      q [56, 30, 256] int8, s1.
//   tail (H; launches 4-7)
//   4. Conv_1: plain 4x4 pad-1 int8 conv on the resized grid (per-cout
//      weights) -> 55 x 29 x 128, (f32(acc) * sk1) * s1 + bias1.
//   5. GroupNorm_1 (32 groups of 4) -> leaky -> per-sample int8 (q2, s2).
//   6. Conv_2: 3x3 pad-1 int8 conv -> 55 x 29 x 64, (f32(acc) * sk2) * s2 + bias2.
//   7. GroupNorm_2 (32 groups of 2) -> leaky, kept in f32, then Conv_3, a
//      2x2 pad-1 f32 conv to 56 x 30, + bias3 -> ReLU [-> expm1].
//
// rint rounds half to even, as jnp.round does. The JAX kernels take
// lax.rsqrt; these take the IEEE 1 / sqrt, as kernels A and C do. Every
// elementwise step rounds with __fmul_rn/__fadd_rn/__fsub_rn/__fdiv_rn, so
// nvcc does not contract it into an FMA and it rounds as the plain PyTorch
// versions (zdcsim_torch/ops/fused_decode_kernels.py) do, op for op.
//
// Bound on the H100: operations. Per sample G does 553 M int8 MACs on the
// taps that read the source grid and moves 0.6 MB (184 KB of bf16 in, 430 KB
// of int8 out); H adds about 836 M (Conv_1) and 118 M (Conv_2) MACs and a
// small f32 Conv_3. At 1979 TOP/s the 64-row serving tile needs about 36 us
// (G) and 96 us (H); chip_smoke.py computes the exact counts. The three convs
// are nearly all of that work, so they run on the int8 tensor cores.
//
// Design: one sample's f32 Conv_0 output (680 KB) exceeds the 227 KB of
// shared memory of a block, and the LayerNorm and each GroupNorm need the
// whole sample's statistics before any int8 value exists. So each stage is a
// launch, with the intermediates in two workspaces the wrapper allocates
// (one int8, one f32, each reused by the later stages in stream order):
//  - LN-quant: one block of 1024 threads per sample, four passes over the
//    row (the first from device memory, the rest from L2);
//  - the convs: conv_mma.cuh's implicit GEMM on the int8 tensor cores
//    (wgmma s8, exact int32 sums, f32 epilogue), one plan each: Conv_0's four
//    parity phases written through the (2i + pr, 2j + pc) map, Conv_1 and
//    Conv_2 as one pad-1 phase; the wrappers pack the weights once as
//    [Cout, taps x Cin]. Kernels B and D run the same core;
//  - the GroupNorms: one block of 512 threads per sample, per-channel then
//    per-group sums in a fixed order (no atomics: a rerun is bit-identical);
//    the quantise pass walks the OUTPUT grid, so the nearest resize costs
//    nothing beyond reading a source pixel once per output pixel;
//  - GroupNorm_2 + Conv_3: one block per sample; after the statistics, one
//    warp per output pixel normalises its 4 x 64 inputs on the fly and sums
//    them with a fixed shuffle tree.
// Left for later: a cluster that keeps a sample on chip between the stages
// (the conv core's own open items are in conv_mma.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_mma.cuh"

namespace {

// Geometry of the full-width generator (pallas_decode_fused.py:88-91).
constexpr int H0 = 18, W0 = 10, C0 = 512;  // MLP grid
constexpr int H1 = 35, W1 = 19, C1 = 256;  // Conv_0 output
constexpr int HG = 56, WG = 30;            // resized and final grid
constexpr int HV = HG - 1, WV = WG - 1;    // Conv_1 and Conv_2 output, 55 x 29
constexpr int C2 = 128, C3 = 64;
constexpr int kGroups = 32;

// ---------------------------------------------------------------------------
// 1. LayerNorm + LeakyReLU + per-sample int8
// ---------------------------------------------------------------------------

constexpr int kLnThreads = 1024;

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
__device__ __forceinline__ float ln_transform(const T* row, const float* scale,
                                              const float* bias, int i, float mu, float rstd) {
  float z = __fmul_rn(__fsub_rn(load_f32(row, i), mu), rstd);
  z = __fadd_rn(__fmul_rn(z, scale[i]), bias[i]);
  return z >= 0.0f ? z : __fmul_rn(0.1f, z);
}

template <typename T>
__global__ void __launch_bounds__(kLnThreads)
    ln_quant_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ bias, int8_t* __restrict__ q,
                    float* __restrict__ s) {
  constexpr int f = H0 * W0 * C0;
  __shared__ float red[33];
  const T* row = x + (size_t)blockIdx.x * f;
  int8_t* qrow = q + (size_t)blockIdx.x * f;

  float acc = 0.0f;
  for (int i = threadIdx.x; i < f; i += blockDim.x) acc += load_f32(row, i);
  const float mu = __fdiv_rn(block_reduce(acc, false, red), (float)f);

  acc = 0.0f;
  for (int i = threadIdx.x; i < f; i += blockDim.x) {
    const float d = __fsub_rn(load_f32(row, i), mu);
    acc = fmaf(d, d, acc);
  }
  const float var = __fdiv_rn(block_reduce(acc, false, red), (float)f);
  const float rstd = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, 1e-6f)));

  float amax = 0.0f;
  for (int i = threadIdx.x; i < f; i += blockDim.x)
    amax = fmaxf(amax, fabsf(ln_transform(row, scale, bias, i, mu, rstd)));
  amax = block_reduce(amax, true, red);
  const float sc = fmaxf(__fdiv_rn(amax, 127.0f), 1e-12f);

  for (int i = threadIdx.x; i < f; i += blockDim.x) {
    float r = rintf(__fdiv_rn(ln_transform(row, scale, bias, i, mu, rstd), sc));
    qrow[i] = (int8_t)fminf(fmaxf(r, -127.0f), 127.0f);
  }
  if (threadIdx.x == 0) s[blockIdx.x] = sc;
}

// ---------------------------------------------------------------------------
// 3, 5, 7. GroupNorm statistics of one f32 sample, per block
// ---------------------------------------------------------------------------

constexpr int kGnThreads = 512;
constexpr int kMaxC = 256;

struct GnShared {
  float red[kGnThreads * 8];
  float cs1[kMaxC], cs2[kMaxC];
  float gmu[kGroups], grs[kGroups];
  float wmax[kGnThreads / 32];
};

__device__ __forceinline__ void load8(const float* p, float v[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ float gn_transform(float x, float mu, float rstd, float sc, float bi) {
  float y = __fmul_rn(__fsub_rn(x, mu), rstd);
  y = __fadd_rn(__fmul_rn(y, sc), bi);
  return y >= 0.0f ? y : __fmul_rn(0.1f, y);
}

// Group mean and 1 / sqrt(var + 1e-6) of the sample xs [hw, c] (c a multiple
// of 8 with c / 8 dividing 512, kGroups groups of consecutive channels) into
// sh.gmu, sh.grs. Each thread owns 8 consecutive channels and a fixed stride
// of pixels; the block sums per channel, then per group, in a fixed order.
__device__ void gn_stats(const float* xs, int hw, int c, GnShared& sh) {
  const int ncb = c >> 3, cb = threadIdx.x % ncb;
  const int p0 = threadIdx.x / ncb, ps = kGnThreads / ncb;
  float s1[8], s2[8], v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s1[i] = s2[i] = 0.0f;
  for (int p = p0; p < hw; p += ps) {
    load8(xs + (size_t)p * c + cb * 8, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s1[i] += v[i];
      s2[i] = fmaf(v[i], v[i], s2[i]);
    }
  }
  for (int pass = 0; pass < 2; ++pass) {
    float* dst = pass ? sh.cs2 : sh.cs1;
#pragma unroll
    for (int i = 0; i < 8; ++i) sh.red[p0 * c + cb * 8 + i] = pass ? s2[i] : s1[i];
    __syncthreads();
    for (int ch = threadIdx.x; ch < c; ch += kGnThreads) {
      float acc = 0.0f;
      for (int k = 0; k < ps; ++k) acc += sh.red[k * c + ch];
      dst[ch] = acc;
    }
    __syncthreads();
  }
  const int cg = c / kGroups;
  const float n = (float)hw * (float)cg;
  if (threadIdx.x < kGroups) {
    const int g = threadIdx.x;
    float a1 = 0.0f, a2 = 0.0f;
    for (int k = 0; k < cg; ++k) {
      a1 += sh.cs1[g * cg + k];
      a2 += sh.cs2[g * cg + k];
    }
    const float mu = __fdiv_rn(a1, n);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(a2, n), __fmul_rn(mu, mu)), 0.0f);
    sh.gmu[g] = mu;
    sh.grs[g] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, 1e-6f)));
  }
  __syncthreads();
}

// GroupNorm -> leaky -> one per-sample int8 scale over the h x w source grid,
// quantised values written through the nearest resize to oh x ow (source
// pixel (floor((2r+1) h / 2oh), floor((2c+1) w / 2ow)); the identity when
// oh = h and ow = w). x: [nb, h, w, c] f32; q: [nb, oh, ow, c]; s: [nb].
__global__ void __launch_bounds__(kGnThreads)
    gn_quant_kernel(const float* __restrict__ x, const float* __restrict__ scale,
                    const float* __restrict__ bias, int8_t* __restrict__ q,
                    float* __restrict__ s, int h, int w, int c, int oh, int ow) {
  __shared__ GnShared sh;
  const int hw = h * w;
  const float* xs = x + (size_t)blockIdx.x * hw * c;
  gn_stats(xs, hw, c, sh);

  const int ncb = c >> 3, cb = threadIdx.x % ncb;
  const int p0 = threadIdx.x / ncb, ps = kGnThreads / ncb;
  const int cg = c / kGroups;
  float mu_r[8], rs_r[8], sc_r[8], bi_r[8], v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ch = cb * 8 + i;
    mu_r[i] = sh.gmu[ch / cg];
    rs_r[i] = sh.grs[ch / cg];
    sc_r[i] = scale[ch];
    bi_r[i] = bias[ch];
  }

  // max |y| over the source grid (every source pixel appears in the resize)
  float amax = 0.0f;
  for (int p = p0; p < hw; p += ps) {
    load8(xs + (size_t)p * c + cb * 8, v);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      amax = fmaxf(amax, fabsf(gn_transform(v[i], mu_r[i], rs_r[i], sc_r[i], bi_r[i])));
  }
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if ((threadIdx.x & 31) == 0) sh.wmax[threadIdx.x >> 5] = amax;
  __syncthreads();
  if (threadIdx.x < 32) {
    amax = threadIdx.x < kGnThreads / 32 ? sh.wmax[threadIdx.x] : 0.0f;  // |y| >= 0
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    if (threadIdx.x == 0) sh.wmax[0] = amax;
  }
  __syncthreads();
  const float sc = fmaxf(__fdiv_rn(sh.wmax[0], 127.0f), 1e-12f);

  // quantise, walking the output grid: 8 int8 values (one 8-byte store) per load
  int8_t* qs = q + (size_t)blockIdx.x * oh * ow * c + cb * 8;
  for (int po = p0; po < oh * ow; po += ps) {
    const int r = po / ow, col = po % ow;
    const int src = ((2 * r + 1) * h / (2 * oh)) * w + (2 * col + 1) * w / (2 * ow);
    load8(xs + (size_t)src * c + cb * 8, v);
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float rq = rintf(__fdiv_rn(gn_transform(v[i], mu_r[i], rs_r[i], sc_r[i], bi_r[i]), sc));
      rq = fminf(fmaxf(rq, -127.0f), 127.0f);
      const uint32_t byte = (uint32_t)(uint8_t)(int8_t)rq;
      if (i < 4) lo |= byte << (8 * i); else hi |= byte << (8 * (i - 4));
    }
    *reinterpret_cast<uint2*>(qs + (size_t)po * c) = make_uint2(lo, hi);
  }
  if (threadIdx.x == 0) s[blockIdx.x] = sc;
}

// GroupNorm_2 -> leaky (f32), then Conv_3 (2x2 pad 1, 64 -> 1) + bias3 ->
// ReLU [-> expm1]. y: [nb, 55, 29, 64] f32; k3: [2, 2, 64] f32; b3: [1];
// out: [nb, 56, 30] f32. With 2 channels a group, lane l of a warp owns
// channels 2l, 2l + 1, which form group l.
__global__ void __launch_bounds__(kGnThreads)
    gn_conv3_kernel(const float* __restrict__ y, const float* __restrict__ scale,
                    const float* __restrict__ bias, const float* __restrict__ k3,
                    const float* __restrict__ b3, float* __restrict__ out, int apply_expm1) {
  __shared__ GnShared sh;
  const float* ys = y + (size_t)blockIdx.x * HV * WV * C3;
  gn_stats(ys, HV * WV, C3, sh);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ch = 2 * lane;
  const float mu = sh.gmu[lane], rs = sh.grs[lane];
  const float sc0 = scale[ch], sc1 = scale[ch + 1], bi0 = bias[ch], bi1 = bias[ch + 1];
  float k0[4], k1[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    k0[t] = k3[t * C3 + ch];
    k1[t] = k3[t * C3 + ch + 1];
  }
  const float bias3 = b3[0];
  for (int po = warp; po < HG * WG; po += kGnThreads / 32) {
    const int r = po / WG, col = po % WG;
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int si = r + (t >> 1) - 1, sj = col + (t & 1) - 1;
      if (si < 0 || si >= HV || sj < 0 || sj >= WV) continue;  // zero padding
      const float2 v = *reinterpret_cast<const float2*>(ys + (size_t)(si * WV + sj) * C3 + ch);
      acc = fmaf(gn_transform(v.x, mu, rs, sc0, bi0), k0[t], acc);
      acc = fmaf(gn_transform(v.y, mu, rs, sc1, bi1), k1[t], acc);
    }
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      float v = fmaxf(__fadd_rn(acc, bias3), 0.0f);
      out[(size_t)blockIdx.x * HG * WG + po] = apply_expm1 ? expm1f(v) : v;
    }
  }
}

// ---------------------------------------------------------------------------
// The launch sequences
// ---------------------------------------------------------------------------

// A plain k x k pad-1 conv from an h x w grid to the 55 x 29 grid.
ConvPlan pad1_plan(int k, int h, int w) {
  ConvPlan plan{};
  plan.ph[0] = ConvPhase{HV, WV, 1, k, k, -1, -1, 0, 1, 0, 1, 0, 0};
  plan.h = h; plan.w = w; plan.oh = HV; plan.ow = WV;
  plan.taps = k * k;
  return plan;
}

struct Front {
  const void* x; int x_is_bf16;
  const float *ln_scale, *ln_bias;
  const int8_t* kp0; const float *sk0, *b0, *g0s, *g0b;
};

// Launches 1-3: q [nb, 56, 30, 256] int8 and s [nb]; ws_i8 holds xq
// [nb, 92160], ws_f32 the Conv_0 output [nb, 35, 19, 256], ws_sx [nb].
int run_front(const Front& f, int8_t* ws_i8, float* ws_f32, float* ws_sx, int8_t* q, float* s,
              int nb, cudaStream_t st) {
  if (f.x_is_bf16)
    ln_quant_kernel<__nv_bfloat16><<<nb, kLnThreads, 0, st>>>(
        (const __nv_bfloat16*)f.x, f.ln_scale, f.ln_bias, ws_i8, ws_sx);
  else
    ln_quant_kernel<float><<<nb, kLnThreads, 0, st>>>((const float*)f.x, f.ln_scale,
                                                      f.ln_bias, ws_i8, ws_sx);
  int err = (int)cudaGetLastError();
  if (err) return err;
  err = launch_conv(ws_i8, ws_sx, f.kp0, f.sk0, f.b0, ws_f32, nb, C0, C1,
                    conv0_plan(H0, W0, C1), 4, st);
  if (err) return err;
  gn_quant_kernel<<<nb, kGnThreads, 0, st>>>(ws_f32, f.g0s, f.g0b, q, s, H1, W1, C1, HG, WG);
  return (int)cudaGetLastError();
}

}  // namespace

// G. x: [nb, 92160] bf16 (x_is_bf16 = 1) or f32; ln_scale, ln_bias: [92160]
// f32; kp0: [256, 25 * 512] int8, the parity-phase taps [25, 512, 256] packed
// K-major (phase p's slab at tap0[p] * 512), and sk0: [4, 256] f32; b0, g0s,
// g0b: [256] f32. Workspaces: ws_i8 [nb * 92160] int8,
// ws_f32 [nb * 35 * 19 * 256] f32, ws_s [nb] f32. Writes q [nb, 56, 30, 256]
// int8 and s [nb] f32. Returns the first CUDA error of its 3 launches.
extern "C" int zdc_fused_decode_front(const void* x, int x_is_bf16, const void* ln_scale,
                                      const void* ln_bias, const void* kp0, const void* sk0,
                                      const void* b0, const void* g0s, const void* g0b,
                                      void* ws_i8, void* ws_f32, void* ws_s, void* q, void* s,
                                      int nb, void* stream) {
  if (nb <= 0) return (int)cudaSuccess;
  const Front f{x, x_is_bf16, (const float*)ln_scale, (const float*)ln_bias,
                (const int8_t*)kp0, (const float*)sk0, (const float*)b0, (const float*)g0s,
                (const float*)g0b};
  return run_front(f, (int8_t*)ws_i8, (float*)ws_f32, (float*)ws_s, (int8_t*)q, (float*)s, nb,
                   (cudaStream_t)stream);
}

// H. The front's arguments as for G, then kp1 [128, 16 * 256] int8 (Conv_1's
// [4, 4, 256, 128] packed K-major), sk1, b1, g1s, g1b [128] f32; kp2
// [64, 9 * 128] int8 (Conv_2's [3, 3, 128, 64]), sk2, b2, g2s, g2b [64] f32;
// k3 [2, 2, 64] f32, b3 [1] f32. Workspaces: ws_i8 [nb * 56 * 30 * 256]
// int8, ws_f32 [nb * 55 * 29 * 128] f32, ws_s [3 * nb] f32. Writes out
// [nb, 56, 30] f32 (expm1 of it when apply_expm1). Returns the first CUDA
// error of its 7 launches.
extern "C" int zdc_fused_decode(const void* x, int x_is_bf16, const void* ln_scale,
                                const void* ln_bias, const void* kp0, const void* sk0,
                                const void* b0, const void* g0s, const void* g0b,
                                const void* kp1, const void* sk1, const void* b1,
                                const void* g1s, const void* g1b, const void* kp2,
                                const void* sk2, const void* b2, const void* g2s,
                                const void* g2b, const void* k3, const void* b3, void* ws_i8,
                                void* ws_f32, void* ws_s, void* out, int apply_expm1, int nb,
                                void* stream) {
  if (nb <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  int8_t* wi = (int8_t*)ws_i8;
  float* wf = (float*)ws_f32;
  float* s = (float*)ws_s;  // [sx, s1, s2] x nb
  const Front f{x, x_is_bf16, (const float*)ln_scale, (const float*)ln_bias,
                (const int8_t*)kp0, (const float*)sk0, (const float*)b0, (const float*)g0s,
                (const float*)g0b};
  // Each stage reads what the one before wrote and overwrites what no later
  // stage reads: the resized q replaces xq in ws_i8, q2 replaces q, and the
  // f32 conv outputs replace one another in ws_f32.
  int err = run_front(f, wi, wf, s, wi, s + nb, nb, st);
  if (err) return err;
  err = launch_conv(wi, s + nb, (const int8_t*)kp1, (const float*)sk1, (const float*)b1, wf, nb,
                    C1, C2, pad1_plan(4, HG, WG), 1, st);
  if (err) return err;
  gn_quant_kernel<<<nb, kGnThreads, 0, st>>>(wf, (const float*)g1s, (const float*)g1b, wi,
                                             s + 2 * nb, HV, WV, C2, HV, WV);
  err = (int)cudaGetLastError();
  if (err) return err;
  err = launch_conv(wi, s + 2 * nb, (const int8_t*)kp2, (const float*)sk2, (const float*)b2, wf,
                    nb, C2, C3, pad1_plan(3, HV, WV), 1, st);
  if (err) return err;
  gn_conv3_kernel<<<nb, kGnThreads, 0, st>>>(wf, (const float*)g2s, (const float*)g2b,
                                             (const float*)k3, (const float*)b3, (float*)out,
                                             apply_expm1);
  return (int)cudaGetLastError();
}

// One conv stage as H launches it, for tests: conv 0 is Conv_0's four parity
// phases (xq [nb, 18, 10, 512], kp0, sk0 [4, 256], bias [256] -> out
// [nb, 35, 19, 256]); conv 1 is Conv_1 (xq [nb, 56, 30, 256], kp1, sk1, bias
// [128] -> out [nb, 55, 29, 128]); conv 2 is Conv_2 (xq [nb, 55, 29, 128], kp2,
// sk2, bias [64] -> out [nb, 55, 29, 64]). sx: [nb] f32. Returns the launch's
// CUDA error (cudaErrorInvalidValue for another conv).
extern "C" int zdc_fused_conv_int8(int conv, const void* xq, const void* sx, const void* kp,
                                   const void* sk, const void* bias, void* out, int nb,
                                   void* stream) {
  if (nb <= 0) return (int)cudaSuccess;
  const int8_t* x = (const int8_t*)xq;
  const float *s = (const float*)sx, *k = (const float*)sk, *b = (const float*)bias;
  const int8_t* w = (const int8_t*)kp;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (conv) {
    case 0: return launch_conv(x, s, w, k, b, o, nb, C0, C1, conv0_plan(H0, W0, C1), 4, st);
    case 1: return launch_conv(x, s, w, k, b, o, nb, C1, C2, pad1_plan(4, HG, WG), 1, st);
    case 2: return launch_conv(x, s, w, k, b, o, nb, C2, C3, pad1_plan(3, HV, WV), 1, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
