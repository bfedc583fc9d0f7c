// The bodies of kernels A (LayerNorm -> leaky -> per-row int8) and C
// (GroupNorm -> leaky -> per-sample int8) on thread-block clusters, and
// their host launchers. ln_leaky_rowquant.cu (A), gn_leaky_rowquant.cu (C)
// and fused_decode.cu (the four norm stages of G and H) all instantiate them
// from here; each source file's copy lives in an anonymous namespace.
//
// A's body is one launch of a LayerNorm over rows of f elements; C's body is
// one launch of a GroupNorm over samples of hw pixels x c channels, with a
// writer that says what the launch makes of the normalised sample:
//  - SameGrid: C's own, q int8 at the sample's pixels and s per sample;
//  - ResizeGrid: the same int8 written through the nearest resize from the
//    H x W source grid to an OH x OW grid (G's and H's GroupNorm_0);
//  - Conv3Out: no int8, but H's last stage, Conv_3 (2x2 pad 1, 64 -> 1) +
//    bias -> ReLU [-> expm1] over the normalised f32 sample.
// The designs are described at each body and in the two kernels' sources.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_norm.cuh"

namespace {

constexpr int kNormMaxThreads = 1024;

// ===========================================================================
// Kernel A's body: LayerNorm -> scale/bias -> leaky -> per-row int8
// ===========================================================================

constexpr int kVec = 4;    // elements a thread takes at a time on aligned rows
constexpr int kShare = 16;  // a block's share is a multiple of 16 elements

// One unit as it lies in device memory: 1 element, or 4 (8 bytes of bf16,
// 16 of f32) from an aligned address.
template <typename T, int U>
struct Raw;
template <>
struct Raw<__nv_bfloat16, kVec> {
  uint2 w;
};
template <>
struct Raw<float, kVec> {
  float4 w;
};
template <typename T>
struct Raw<T, 1> {
  T x;
};

template <typename T>
__device__ __forceinline__ void load_raw(const T* p, Raw<T, 1>& r) { r.x = p[0]; }
__device__ __forceinline__ void load_raw(const __nv_bfloat16* p, Raw<__nv_bfloat16, kVec>& r) {
  r.w = *reinterpret_cast<const uint2*>(p);
}
__device__ __forceinline__ void load_raw(const float* p, Raw<float, kVec>& r) {
  r.w = *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void to_f32(const Raw<float, 1>& r, float (&v)[1]) { v[0] = r.x; }
__device__ __forceinline__ void to_f32(const Raw<__nv_bfloat16, 1>& r, float (&v)[1]) {
  v[0] = __bfloat162float(r.x);
}
__device__ __forceinline__ void to_f32(const Raw<float, kVec>& r, float (&v)[kVec]) {
  v[0] = r.w.x; v[1] = r.w.y; v[2] = r.w.z; v[3] = r.w.w;
}
__device__ __forceinline__ void to_f32(const Raw<__nv_bfloat16, kVec>& r, float (&v)[kVec]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.w);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

template <typename T, int U>
__device__ __forceinline__ void gload(const T* p, float (&v)[U]) {
  Raw<T, U> r;
  load_raw(p, r);
  to_f32(r, v);
}

// The kept share in shared memory, as f32: unit u at float (or float4) u.
// Consecutive threads take consecutive units, so no two threads of a
// quarter warp share a bank.
__device__ __forceinline__ void sstore(float* keep, int u, const float (&v)[1]) { keep[u] = v[0]; }
__device__ __forceinline__ void sload(const float* keep, int u, float (&v)[1]) { v[0] = keep[u]; }
__device__ __forceinline__ void sstore(float* keep, int u, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(keep)[u] = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void sload(const float* keep, int u, float (&v)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(keep)[u];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ float ln_transform(float y, float mu, float rstd, float sc, float bi) {
  float z = __fmul_rn(y - mu, rstd);
  z = __fadd_rn(__fmul_rn(z, sc), bi);
  return leaky(z);
}

// z of one unit in place; on aligned rows scale and bias are one float4 each.
__device__ __forceinline__ void transform_unit(float (&v)[1], const float* sc, const float* bi,
                                               float mu, float rstd) {
  v[0] = ln_transform(v[0], mu, rstd, sc[0], bi[0]);
}
__device__ __forceinline__ void transform_unit(float (&v)[kVec], const float* sc,
                                               const float* bi, float mu, float rstd) {
  const float4 s4 = *reinterpret_cast<const float4*>(sc);
  const float4 b4 = *reinterpret_cast<const float4*>(bi);
  v[0] = ln_transform(v[0], mu, rstd, s4.x, b4.x);
  v[1] = ln_transform(v[1], mu, rstd, s4.y, b4.y);
  v[2] = ln_transform(v[2], mu, rstd, s4.z, b4.z);
  v[3] = ln_transform(v[3], mu, rstd, s4.w, b4.w);
}

__device__ __forceinline__ void qstore(int8_t* p, const float (&z)[1], const Divisor& d) {
  p[0] = (int8_t)quant(z[0], d);
}
__device__ __forceinline__ void qstore(int8_t* p, const float (&z)[kVec], const Divisor& d) {
  *reinterpret_cast<uint32_t*>(p) =
      quant(z[0], d) | quant(z[1], d) << 8 | quant(z[2], d) << 16 | quant(z[3], d) << 24;
}

// One block of the cluster that serves row blockIdx.x / k: elements [rank *
// share, rank * share + len) in units of U (4 on aligned rows, else 1);
// kKeep keeps them in shared memory, else every pass reads device memory.
template <typename T, int U, bool kKeep>
__global__ void __launch_bounds__(kNormMaxThreads, 1)
    ln_leaky_rowquant_kernel(const T* __restrict__ y, const float* __restrict__ scale,
                             const float* __restrict__ bias, int8_t* __restrict__ q,
                             float* __restrict__ s, int f, int share) {
  extern __shared__ float4 keep4[];
  __shared__ float red[33];
  __shared__ float slot[3];  // one word per exchange: sum y, sum (y - mu)^2, max |z|
  float* keep = reinterpret_cast<float*>(keep4);
  cg::cluster_group cluster = cg::this_cluster();
  const int row = blockIdx.x / (int)cluster.num_blocks();
  const int start = (int)cluster.block_rank() * share;
  const int units = max(0, min(share, f - start)) / U;  // U = 4 only when 4 divides f
  const int nt = blockDim.x;
  const T* yr = y + (size_t)row * f + start;
  const float* sr = scale + start;
  const float* br = bias + start;
  int8_t* qr = q + (size_t)row * f + start;

  // the one read of device memory: kBatch units a thread in flight at once
  constexpr int kBatch = 8;
  float acc = 0.0f;
  for (int u0 = threadIdx.x; u0 < units; u0 += kBatch * nt) {
    Raw<T, U> r[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      if (u0 + j * nt < units) load_raw(yr + (u0 + j * nt) * U, r[j]);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int u = u0 + j * nt;
      if (u >= units) break;
      float v[U];
      to_f32(r[j], v);
      if (kKeep) sstore(keep, u, v);
#pragma unroll
      for (int e = 0; e < U; ++e) acc += v[e];
    }
  }
  const float mu = cluster_reduce(acc, false, red, &slot[0]) / (float)f;

  acc = 0.0f;
  for (int u = threadIdx.x; u < units; u += nt) {
    float v[U];
    if (kKeep) sload(keep, u, v); else gload(yr + u * U, v);
#pragma unroll
    for (int e = 0; e < U; ++e) {
      const float d = v[e] - mu;
      acc = fmaf(d, d, acc);
    }
  }
  const float var = cluster_reduce(acc, false, red, &slot[1]) / (float)f;
  const float rstd = 1.0f / sqrtf(var + 1e-6f);

  float amax = 0.0f;
#pragma unroll 2
  for (int u = threadIdx.x; u < units; u += nt) {
    float v[U];
    if (kKeep) sload(keep, u, v); else gload(yr + u * U, v);
    transform_unit(v, sr + u * U, br + u * U, mu, rstd);
#pragma unroll
    for (int e = 0; e < U; ++e) amax = fmaxf(amax, fabsf(v[e]));
    if (kKeep) sstore(keep, u, v);  // z over y: the quantise pass reads it back
  }
  amax = cluster_reduce(amax, true, red, &slot[2]);
  const float sc = fmaxf(amax / 127.0f, 1e-12f);
  const Divisor d = divisor(sc);

  for (int u = threadIdx.x; u < units; u += nt) {
    float z[U];
    if (kKeep) {
      sload(keep, u, z);
    } else {
      gload(yr + u * U, z);
      transform_unit(z, sr + u * U, br + u * U, mu, rstd);
    }
    qstore(qr + u * U, z, d);
  }
  if (cluster.block_rank() == 0 && threadIdx.x == 0) s[row] = sc;
  cluster.sync();  // no block exits while a peer may still read its slots
}

// A block's share of a row of f elements at cluster size k, and its dynamic
// shared memory: the share as f32 when it fits (*kept = 1), else none.
inline int ln_layout(int f, int k, int* share, int* kept) {
  *share = round_up(ceil_div(f, k), kShare);
  const int keep_bytes = *share * 4;
  *kept = keep_bytes <= kMaxDynSmem;
  return *kept ? keep_bytes : 0;
}

template <typename T, int U, bool kKeep>
int ln_launch(const T* y, const float* scale, const float* bias, int8_t* q, float* s, int b,
              int f, int share, int k, int threads, int smem, cudaStream_t st,
              int* max_clusters) {
  return launch_cluster<ln_leaky_rowquant_kernel<T, U, kKeep>>(b * k, threads, smem, k, st,
                                                               max_clusters, y, scale, bias, q,
                                                               s, f, share);
}

template <typename T>
int ln_dispatch(const void* y, const void* scale, const void* bias, void* q, void* s, int b,
                int f, int k, int threads, bool vec, int* kept, cudaStream_t st,
                int* max_clusters) {
  int share = 0;
  const int smem = ln_layout(f, k, &share, kept);
  const T* yt = (const T*)y;
  const float *sc = (const float*)scale, *bi = (const float*)bias;
  int8_t* qt = (int8_t*)q;
  float* st_ = (float*)s;
  if (vec)
    return *kept ? ln_launch<T, kVec, true>(yt, sc, bi, qt, st_, b, f, share, k, threads, smem,
                                            st, max_clusters)
                 : ln_launch<T, kVec, false>(yt, sc, bi, qt, st_, b, f, share, k, threads, smem,
                                             st, max_clusters);
  return *kept ? ln_launch<T, 1, true>(yt, sc, bi, qt, st_, b, f, share, k, threads, smem, st,
                                       max_clusters)
               : ln_launch<T, 1, false>(yt, sc, bi, qt, st_, b, f, share, k, threads, smem, st,
                                        max_clusters);
}

inline bool ln_valid_plan(int k, int threads) {
  return portable_cluster(k) && threads >= 32 && threads <= kNormMaxThreads && threads % 32 == 0;
}

// Kernel A on y [b, f] (bf16 when y_is_bf16, else f32): k blocks a row of
// `threads` threads; any other plan is refused with cudaErrorInvalidValue.
// On success *cluster_k is the cluster size launched and *kept 1 when each
// block kept its share in shared memory (0: it streamed it). Returns
// cudaGetLastError() after the launch.
inline int ln_leaky_rowquant_run(const void* y, int y_is_bf16, const void* scale,
                                 const void* bias, void* q, void* s, int b, int f, int k,
                                 int threads, int* cluster_k, int* kept, cudaStream_t st) {
  *cluster_k = 0;
  *kept = 0;
  if (!ln_valid_plan(k, threads)) return (int)cudaErrorInvalidValue;
  if (b <= 0 || f <= 0) return (int)cudaSuccess;
  const bool vec = f % kVec == 0 && aligned((const char*)y, kVec * (y_is_bf16 ? 2 : 4)) &&
                   aligned16(scale) && aligned16(bias) && aligned(q, kVec);
  const int err = y_is_bf16
      ? ln_dispatch<__nv_bfloat16>(y, scale, bias, q, s, b, f, k, threads, vec, kept, st, nullptr)
      : ln_dispatch<float>(y, scale, bias, q, s, b, f, k, threads, vec, kept, st, nullptr);
  if (err == 0) *cluster_k = k;
  return err;
}

// ===========================================================================
// Kernel C's body: GroupNorm -> scale/bias -> leaky -> a writer
// ===========================================================================

// 8 channels of one pixel as they lie in memory: 16 bytes of bf16, 32 of f32.
template <typename T>
struct Pix8 {
  uint4 w[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ Pix8<T> load_pix(const T* p) {
  Pix8<T> v;
  const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i) v.w[i] = p4[i];
  return v;
}

__device__ __forceinline__ void to_f32(const Pix8<float>& p, float v[8]) {
  const float4* f4 = reinterpret_cast<const float4*>(p.w);
  v[0] = f4[0].x; v[1] = f4[0].y; v[2] = f4[0].z; v[3] = f4[0].w;
  v[4] = f4[1].x; v[5] = f4[1].y; v[6] = f4[1].z; v[7] = f4[1].w;
}

__device__ __forceinline__ void to_f32(const Pix8<__nv_bfloat16>& p, float v[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p.w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float gn_transform(float x, float mu, float rstd, float sc, float bi) {
  float y = __fmul_rn(__fsub_rn(x, mu), rstd);
  y = __fadd_rn(__fmul_rn(y, sc), bi);
  return leaky(y);
}

enum class Op { kSum, kMin, kMax };

template <Op op>
__device__ __forceinline__ float combine(float a, float b) {
  return op == Op::kSum ? a + b : op == Op::kMin ? fminf(a, b) : fmaxf(a, b);
}

// Each thread's 8 per-channel values v into red[p0][cb * 8 + i], then their
// per-channel column reduction over the ps rows, in row order, into out[c].
template <Op op>
__device__ void column_reduce(const float v[8], float* red, int p0, int cb, int ps, int c,
                              float* out) {
  __syncthreads();  // red[] may still be read by the previous reduction
  float4* row = reinterpret_cast<float4*>(red + p0 * c + cb * 8);  // 32-byte aligned
  row[0] = make_float4(v[0], v[1], v[2], v[3]);
  row[1] = make_float4(v[4], v[5], v[6], v[7]);
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float acc = red[ch];
    for (int k = 1; k < ps; ++k) acc = combine<op>(acc, red[k * c + ch]);
    out[ch] = acc;
  }
}

// 16 bytes from device memory into shared memory, without registers.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

// The first row r of an oh-row nearest resize of h rows whose source row
// floor((2r + 1) h / 2oh) is at least src (oh when none is): (2r + 1) h >=
// 2 oh src.
__device__ __forceinline__ int first_out_row(int src, int h, int oh) {
  const int num = 2 * oh * src - h;
  const int r = (num + 2 * h - 1) / (2 * h);
  return num <= 0 ? 0 : r < oh ? r : oh;
}

// Writers of C's body. A quantising writer (kQuant: the min/max statistics,
// the scale s and the int8 pass) stores each source pixel's 8 int8 values,
// quantised once, at every output pixel that reads that source pixel; so
// every output pixel is written by exactly the block whose share holds its
// source pixel. Conv3Out runs the sample through Conv_3 instead.

// C's own: q [b, hw, c] int8 at the pixels of the block's share; s [b].
struct SameGrid {
  int8_t* q;
  float* s;
  static constexpr bool kQuant = true;
  __device__ int out_pixels(int hw) const { return hw; }
  __device__ void store(int8_t* qs, int src, int c, uint2 v) const {
    *reinterpret_cast<uint2*>(qs + (size_t)src * c) = v;
  }
};

// q [b, OH, OW, c] int8 through the nearest resize of the H x W source grid:
// output pixel (r, col) reads source pixel (floor((2r + 1) H / 2OH),
// floor((2col + 1) W / 2OW)). Source row sr is read by output rows
// first_out_row(sr) .. first_out_row(sr + 1) - 1, columns likewise: one or
// two each for 35x19 -> 56x30. The geometry is fixed at compile time, so
// these divisions are multiplications.
template <int H, int W, int OH, int OW>
struct ResizeGrid {
  int8_t* q;
  float* s;
  static constexpr bool kQuant = true;
  __device__ int out_pixels(int) const { return OH * OW; }
  __device__ void store(int8_t* qs, int src, int c, uint2 v) const {
    const int sr = src / W, sc = src - sr * W;
    const int r1 = first_out_row(sr + 1, H, OH), c0 = first_out_row(sc, W, OW);
    const int c1 = first_out_row(sc + 1, W, OW);
    for (int r = first_out_row(sr, H, OH); r < r1; ++r)
      for (int col = c0; col < c1; ++col)
        *reinterpret_cast<uint2*>(qs + (size_t)(r * OW + col) * c) = v;
  }
};

// H's last stage: the normalised f32 sample [H, W, 64] through Conv_3 (2x2,
// pad 1, 64 -> 1) + b3 -> ReLU [-> expm1] to out [b, H + 1, W + 1] f32.
// Output pixel (r, col) sums input pixels (r - 1 .. r, col - 1 .. col), all
// at or before its anchor (min(r, H - 1), min(col, W - 1)) in row-major
// order and at most W + 1 pixels before it; the block whose share holds the
// anchor computes it, reading the taps before its share from device memory
// (the previous rank's share, which no launch writes). It takes a kept
// share only: its tap sums are written over the share in shared memory.
template <int H, int W>
struct Conv3Out {
  const float* k3;  // [2, 2, 64]
  const float* b3;  // [1]
  float* out;
  int apply_expm1;
  static constexpr bool kQuant = false;
};

// Shared memory of a block: the kept pixels (kKeep), then the floats
// red[threads * 8]; part[4][c], this block's per-channel sum x, sum x^2,
// min x and max x, which the cluster reads; tot[4][c], the sample's; gmu,
// grs ([c] each, groups <= c).
inline int fixed_smem(int c, int threads) { return 4 * (threads * 8 + 10 * c); }

// The sum over one warp of 4 values a lane, in a fixed order (a butterfly
// that halves the values at each of the first two steps): lane 8t holds the
// sum of v[t], in 6 shuffles where 4 separate trees take 20.
__device__ __forceinline__ float warp_sum4(const float (&v)[4], int lane) {
  const bool hi16 = lane & 16, hi8 = lane & 8;
  float a0 = hi16 ? v[2] : v[0], a1 = hi16 ? v[3] : v[1];
  const float b0 = hi16 ? v[0] : v[2], b1 = hi16 ? v[1] : v[3];
  a0 += __shfl_xor_sync(0xffffffffu, b0, 16);
  a1 += __shfl_xor_sync(0xffffffffu, b1, 16);
  float e = hi8 ? a1 : a0;
  e += __shfl_xor_sync(0xffffffffu, hi8 ? a0 : a1, 8);
  for (int o = 4; o > 0; o >>= 1) e += __shfl_xor_sync(0xffffffffu, e, o);
  return e;
}

// Conv_3 of the normalised sample after C's statistics (gmu, grs of 32
// groups of 2 channels). Each input pixel i of the kept share and the W + 1
// before it is normalised once: a warp a pixel, lane l owning channels 2l,
// 2l + 1 (group l), forms the pixel's four tap sums d_t(i) = sum_ch y(i, ch)
// k3[t, ch] (warp_sum4) and writes them over the pixel's own kept values (at
// floats (i mod 16) + 16 t of its slot, so that consecutive pixels fall in
// different banks) or, for the W + 1 before the share, into red; then each
// thread sums the tap sums of one output pixel, taps in order.
template <int H, int W>
__device__ void conv3(const Conv3Out<H, W>& out, float* keep, const float* xsample,
                      const float* scale, const float* bias, const float* gmu, const float* grs,
                      float* red, int sample, int pbeg, int np) {
  constexpr int kC = 64, OW = W + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int ch = 2 * lane;
  const float mu = gmu[lane], rs = grs[lane];
  const float sc0 = scale[ch], sc1 = scale[ch + 1], bi0 = bias[ch], bi1 = bias[ch + 1];
  float k0[4], k1[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    k0[t] = out.k3[t * kC + ch];
    k1[t] = out.k3[t * kC + ch + 1];
  }
  const float bias3 = out.b3[0];
  float* outs = out.out + (size_t)sample * (H + 1) * OW;
  if (np <= 0) return;
  // the output rows whose anchors lie in the share's rows; the last input
  // row anchors two output rows
  const int ra = pbeg / W, rb = (pbeg + np - 1) / W;
  const int first = ra * OW, end = (rb == H - 1 ? H + 1 : rb + 1) * OW;
  const int lo = max(0, pbeg - W - 1);
  for (int i = lo + warp; i < pbeg + np; i += nw) {
    const float2 v2 = i >= pbeg
        ? *reinterpret_cast<const float2*>(keep + (size_t)(i - pbeg) * kC + ch)
        : *reinterpret_cast<const float2*>(xsample + (size_t)i * kC + ch);
    const float y0 = gn_transform(v2.x, mu, rs, sc0, bi0);
    const float y1 = gn_transform(v2.y, mu, rs, sc1, bi1);
    float dt[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) dt[t] = fmaf(y1, k1[t], __fmul_rn(y0, k0[t]));
    const float e = warp_sum4(dt, lane);
    if ((lane & 7) == 0) {
      const int t = lane >> 3;
      if (i >= pbeg)
        keep[(size_t)(i - pbeg) * kC + (i & 15) + 16 * t] = e;
      else
        red[(i - lo) * 4 + t] = e;
    }
  }
  __syncthreads();
  for (int po = first + threadIdx.x; po < end; po += blockDim.x) {
    const int r = po / OW, col = po - r * OW;
    const int anchor = min(r, H - 1) * W + min(col, W - 1);
    if (anchor < pbeg || anchor >= pbeg + np) continue;  // a neighbour's pixel
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int si = r + (t >> 1) - 1, sj = col + (t & 1) - 1;
      if (si < 0 || si >= H || sj < 0 || sj >= W) continue;  // zero padding
      const int i = si * W + sj;
      acc += i >= pbeg ? keep[(size_t)(i - pbeg) * kC + (i & 15) + 16 * t]
                       : red[(i - lo) * 4 + t];
    }
    const float y = fmaxf(__fadd_rn(acc, bias3), 0.0f);
    outs[po] = out.apply_expm1 ? expm1f(y) : y;
  }
}

// One block of the cluster that serves sample blockIdx.x / k: pixels
// [rank * share, rank * share + np).
template <typename T, bool kKeep, class Out>
__global__ void __launch_bounds__(kNormMaxThreads, 1)
    gn_leaky_rowquant_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                             const float* __restrict__ bias, Out out, int hw, int c, int groups,
                             int share) {
  extern __shared__ uint4 smem4[];
  T* keep = reinterpret_cast<T*>(smem4);
  float* red = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(smem4) + (kKeep ? (size_t)share * c * sizeof(T) : 0));
  float* part = red + blockDim.x * 8;  // [4][c]: sum, sum of squares, min, max
  float* tot = part + 4 * c;         // [4][c]
  float* gmu = tot + 4 * c;
  float* grs = gmu + c;

  cg::cluster_group cluster = cg::this_cluster();
  const int sample = blockIdx.x / (int)cluster.num_blocks();
  const int pbeg = (int)cluster.block_rank() * share;
  const int np = max(0, min(share, hw - pbeg));
  const int ncb = c >> 3;              // channel blocks of 8
  const int cb = threadIdx.x % ncb;    // this thread's channel block
  const int p0 = threadIdx.x / ncb;    // first pixel
  const int ps = blockDim.x / ncb;     // pixel stride
  const T* xsample = x + (size_t)sample * hw * c;
  const T* xs = xsample + (size_t)pbeg * c + cb * 8;
  T* ks = keep + cb * 8;

  // the one read of device memory: each thread copies its pixels into
  // shared memory with every copy in flight at once, then reads them back
  if (kKeep) {
    constexpr int kChunk = 16 / sizeof(T);  // elements a 16-byte copy moves
    for (int p = p0; p < np; p += ps)
#pragma unroll
      for (int i = 0; i < 8; i += kChunk)
        cp_async16(ks + (size_t)p * c + i, xs + (size_t)p * c + i);
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // this thread's own copies
  }
  // per-channel sum x, sum x^2 and, to quantise, min x and max x
  constexpr int kStats = Out::kQuant ? 4 : 2;
  float s1[8], s2[8], mn[8], mx[8], v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    s1[i] = s2[i] = 0.0f;
    mn[i] = INFINITY;
    mx[i] = -INFINITY;
  }
  for (int p = p0; p < np; p += ps) {
    to_f32(load_pix(kKeep ? ks + (size_t)p * c : xs + (size_t)p * c), v);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s1[i] += v[i];
      s2[i] = fmaf(v[i], v[i], s2[i]);
      if (Out::kQuant) {
        mn[i] = fminf(mn[i], v[i]);
        mx[i] = fmaxf(mx[i], v[i]);
      }
    }
  }
  column_reduce<Op::kSum>(s1, red, p0, cb, ps, c, part);
  column_reduce<Op::kSum>(s2, red, p0, cb, ps, c, part + c);
  if (Out::kQuant) {
    column_reduce<Op::kMin>(mn, red, p0, cb, ps, c, part + 2 * c);
    column_reduce<Op::kMax>(mx, red, p0, cb, ps, c, part + 3 * c);
  }
  cluster.sync();  // every block's partials are written
  // each of the kStats * c totals from the k ranks' partials, their reads in
  // flight at once, added in rank order
  const int k = (int)cluster.num_blocks();
  for (int i = threadIdx.x; i < kStats * c; i += blockDim.x) {
    float u[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < k) u[r] = cluster.map_shared_rank(part, r)[i];
    const int j = i / c;  // 0 sum x, 1 sum x^2, 2 min x, 3 max x
    float a = u[0];
#pragma unroll
    for (int r = 1; r < kMaxCluster; ++r)
      if (r < k) a = j < 2 ? a + u[r] : j == 2 ? fminf(a, u[r]) : fmaxf(a, u[r]);
    tot[i] = a;
  }
  __syncthreads();

  const int cg_ = c / groups;
  const float n = (float)hw * (float)cg_;
  for (int g = threadIdx.x; g < groups; g += blockDim.x) {
    float a1 = 0.0f, a2 = 0.0f;
    for (int i = 0; i < cg_; ++i) {
      a1 += tot[g * cg_ + i];
      a2 += tot[c + g * cg_ + i];
    }
    const float mu = __fdiv_rn(a1, n);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(a2, n), __fmul_rn(mu, mu)), 0.0f);
    gmu[g] = mu;
    grs[g] = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, 1e-6f)));
  }
  __syncthreads();

  if constexpr (Out::kQuant) {
    // max |y| over the sample from each channel's least and greatest x: y is
    // monotone in x within a channel (every rounding step is), so |y| peaks
    // at one of the two, and this max equals the max over every element bit
    // for bit. Every block holds the same totals, so no exchange is needed.
    float amax = 0.0f;
    for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
      const int g = ch / cg_;
      const float lo = gn_transform(tot[2 * c + ch], gmu[g], grs[g], scale[ch], bias[ch]);
      const float hi = gn_transform(tot[3 * c + ch], gmu[g], grs[g], scale[ch], bias[ch]);
      amax = fmaxf(amax, fmaxf(fabsf(lo), fabsf(hi)));
    }
    amax = block_reduce(amax, true, red);
    const float sc = fmaxf(__fdiv_rn(amax, 127.0f), 1e-12f);
    const Divisor d = divisor(sc);

    float mu_r[8], rs_r[8], sc_r[8], bi_r[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ch = cb * 8 + i;
      mu_r[i] = gmu[ch / cg_];
      rs_r[i] = grs[ch / cg_];
      sc_r[i] = scale[ch];
      bi_r[i] = bias[ch];
    }

    // quantise, 8 int8 values a pixel of the share, stored (one 8-byte
    // store each) at every output pixel that reads it
    int8_t* qs = out.q + (size_t)sample * out.out_pixels(hw) * c + cb * 8;
    for (int p = p0; p < np; p += ps) {
      to_f32(load_pix(kKeep ? ks + (size_t)p * c : xs + (size_t)p * c), v);
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t b = quant(gn_transform(v[i], mu_r[i], rs_r[i], sc_r[i], bi_r[i]), d);
        if (i < 4) lo |= b << (8 * i); else hi |= b << (8 * (i - 4));
      }
      out.store(qs, pbeg + p, c, make_uint2(lo, hi));
    }
    if (cluster.block_rank() == 0 && threadIdx.x == 0) out.s[sample] = sc;
  } else {
    conv3(out, keep, xsample, scale, bias, gmu, grs, red, sample, pbeg, np);
  }
  cluster.sync();  // no block exits while a peer may still read its partials
}

// A block's share of a sample of hw pixels at cluster size k, and its
// dynamic shared memory: the share as it lies (elem bytes an element) when
// it fits beside the fixed reduction space (*kept = 1), else that space.
inline int gn_layout(int hw, int c, int elem, int k, int threads, int* share, int* kept) {
  *share = ceil_div(hw, k);
  const long long keep_bytes = (long long)*share * c * elem;
  const int fixed = fixed_smem(c, threads);
  *kept = keep_bytes + fixed <= kMaxDynSmem;
  return *kept ? (int)keep_bytes + fixed : fixed;
}

template <typename T, class Out>
int gn_dispatch(const void* x, const void* scale, const void* bias, Out out, int b, int hw, int c,
                int groups, int k, int threads, int* kept, cudaStream_t st, int* max_clusters) {
  int share = 0;
  const int smem = gn_layout(hw, c, sizeof(T), k, threads, &share, kept);
  const T* xt = (const T*)x;
  const float *sc = (const float*)scale, *bi = (const float*)bias;
  if (*kept)
    return launch_cluster<gn_leaky_rowquant_kernel<T, true, Out>>(
        b * k, threads, smem, k, st, max_clusters, xt, sc, bi, out, hw, c, groups, share);
  if constexpr (Out::kQuant)
    return launch_cluster<gn_leaky_rowquant_kernel<T, false, Out>>(
        b * k, threads, smem, k, st, max_clusters, xt, sc, bi, out, hw, c, groups, share);
  else
    return (int)cudaErrorInvalidValue;  // Conv_3 takes a kept share only
}

// c a multiple of 8 with c / 8 dividing 128, groups dividing c, and a whole
// number of pixels for the threads: 128, 256, .. 1024 of them.
inline bool gn_valid_plan(int c, int groups, int k, int threads) {
  return c > 0 && c % 8 == 0 && 128 % (c / 8) == 0 && groups > 0 && c % groups == 0 &&
         portable_cluster(k) && threads % 128 == 0 && threads >= 128 &&
         threads <= kNormMaxThreads;
}

// Kernel C's body on x [b, hw, c] (bf16 when x_is_bf16, else f32; 16-byte
// aligned) with the writer `out`: k blocks a sample of `threads` threads;
// any other plan is refused with cudaErrorInvalidValue. On success
// *cluster_k is the cluster size launched and *kept 1 when each block kept
// its pixels in shared memory (0: it streamed them). Returns
// cudaGetLastError() after the launch.
template <class Out>
int gn_leaky_rowquant_run(const void* x, int x_is_bf16, const void* scale, const void* bias,
                          Out out, int b, int hw, int c, int groups, int k, int threads,
                          int* cluster_k, int* kept, cudaStream_t st) {
  *cluster_k = 0;
  *kept = 0;
  if (!gn_valid_plan(c, groups, k, threads)) return (int)cudaErrorInvalidValue;
  if (b <= 0 || hw <= 0) return (int)cudaSuccess;
  int err;
  if constexpr (Out::kQuant)
    err = x_is_bf16 ? gn_dispatch<__nv_bfloat16>(x, scale, bias, out, b, hw, c, groups, k,
                                                 threads, kept, st, nullptr)
                    : gn_dispatch<float>(x, scale, bias, out, b, hw, c, groups, k, threads, kept,
                                         st, nullptr);
  else if (x_is_bf16 || c != 64 || groups != 32)
    return (int)cudaErrorInvalidValue;  // Conv_3 takes the f32 [h, w, 64] sample in 32 groups
  else
    err = gn_dispatch<float>(x, scale, bias, out, b, hw, c, groups, k, threads, kept, st,
                             nullptr);
  if (err == 0) *cluster_k = k;
  return err;
}

}  // namespace
