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
// Design: a thread-block cluster of k blocks serves each row (grid b * k;
// k and the threads of a block from the launch plan,
// zdcsim_torch/ops/decode_kernels.py norm_quant_plan: at the serving tile
// k = 2, 128 blocks of 1024 threads, one wave). Each block takes a
// contiguous share of the row, a multiple of 16 elements, and reads it from
// device memory once: on rows whose base and length are 4-element aligned,
// 4 elements a thread at a time (8-byte loads of bf16, 16-byte of f32, so a
// warp reads 256 or 512 contiguous bytes), 8 loads in flight a thread, as
// f32 into its shared memory (float4 slots, consecutive threads on
// consecutive slots: no bank conflicts), summing y as it goes. Every later
// pass reads that copy: the centred variance; then z, with each element's
// scale and bias read once a row (from L2 after the first row), written over
// the copy, and max|z|; then the quantise pass, which writes 4 int8 a thread
// with one 4-byte store (a warp writes 128 contiguous bytes). Sum of y, sum
// of (y - mu)^2 and max|z| are each reduced in a fixed order and exchanged
// across the cluster through distributed shared memory (cluster_norm.cuh),
// so every block holds the same mu, rstd and s, bit for bit, and a rerun is
// bit-identical. A share that does not fit in 227 KB (F above about 464K at
// k = 8) is streamed from device memory in every pass instead; a row whose
// base or length is not 4-element aligned runs the same passes one element
// a thread. The transform uses __fmul_rn/__fadd_rn so the compiler does not
// contract it into FMAs: it rounds exactly as the plain PyTorch version
// does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_norm.cuh"

namespace {

constexpr int kMaxThreads = 1024;
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

__device__ __forceinline__ float transform(float y, float mu, float rstd, float sc, float bi) {
  float z = __fmul_rn(y - mu, rstd);
  z = __fadd_rn(__fmul_rn(z, sc), bi);
  return leaky(z);
}

// z of one unit in place; on aligned rows scale and bias are one float4 each.
__device__ __forceinline__ void transform_unit(float (&v)[1], const float* sc, const float* bi,
                                               float mu, float rstd) {
  v[0] = transform(v[0], mu, rstd, sc[0], bi[0]);
}
__device__ __forceinline__ void transform_unit(float (&v)[kVec], const float* sc,
                                               const float* bi, float mu, float rstd) {
  const float4 s4 = *reinterpret_cast<const float4*>(sc);
  const float4 b4 = *reinterpret_cast<const float4*>(bi);
  v[0] = transform(v[0], mu, rstd, s4.x, b4.x);
  v[1] = transform(v[1], mu, rstd, s4.y, b4.y);
  v[2] = transform(v[2], mu, rstd, s4.z, b4.z);
  v[3] = transform(v[3], mu, rstd, s4.w, b4.w);
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
__global__ void __launch_bounds__(kMaxThreads, 1)
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

template <typename T, int U, bool kKeep>
int launch(const T* y, const float* scale, const float* bias, int8_t* q, float* s, int b, int f,
           int share, int k, int threads, int smem, cudaStream_t st, int* max_clusters) {
  return launch_cluster<ln_leaky_rowquant_kernel<T, U, kKeep>>(b * k, threads, smem, k, st,
                                                               max_clusters, y, scale, bias, q,
                                                               s, f, share);
}

template <typename T>
int dispatch(const void* y, const void* scale, const void* bias, void* q, void* s, int b, int f,
             int k, int threads, bool vec, int* kept, cudaStream_t st, int* max_clusters) {
  const int share = round_up(ceil_div(f, k), kShare);
  const int keep_bytes = share * 4;
  *kept = keep_bytes <= kMaxDynSmem;
  const int smem = *kept ? keep_bytes : 0;
  const T* yt = (const T*)y;
  const float *sc = (const float*)scale, *bi = (const float*)bias;
  int8_t* qt = (int8_t*)q;
  float* st_ = (float*)s;
  if (vec)
    return *kept ? launch<T, kVec, true>(yt, sc, bi, qt, st_, b, f, share, k, threads, smem, st,
                                         max_clusters)
                 : launch<T, kVec, false>(yt, sc, bi, qt, st_, b, f, share, k, threads, smem, st,
                                          max_clusters);
  return *kept ? launch<T, 1, true>(yt, sc, bi, qt, st_, b, f, share, k, threads, smem, st,
                                    max_clusters)
               : launch<T, 1, false>(yt, sc, bi, qt, st_, b, f, share, k, threads, smem, st,
                                     max_clusters);
}

bool valid_plan(int k, int threads) {
  return portable_cluster(k) && threads >= 32 && threads <= kMaxThreads && threads % 32 == 0;
}

}  // namespace

// y: [b, f] bf16 (y_is_bf16 = 1) or f32; scale, bias: [f] f32; q: [b, f]
// int8; s: [b] f32. k blocks per row (1, 2, 4 or 8) of `threads` threads (a
// multiple of 32, at most 1024): any other plan is refused with
// cudaErrorInvalidValue. On success *cluster_k is the cluster size launched
// and *kept is 1 when each block kept its share in shared memory (0: it
// streamed it). Returns cudaGetLastError() after the launch.
extern "C" int zdc_ln_leaky_rowquant(const void* y, int y_is_bf16, const void* scale,
                                     const void* bias, void* q, void* s, int b, int f, int k,
                                     int threads, int* cluster_k, int* kept, void* stream) {
  *cluster_k = 0;
  *kept = 0;
  if (!valid_plan(k, threads)) return (int)cudaErrorInvalidValue;
  if (b <= 0 || f <= 0) return (int)cudaSuccess;
  const bool vec = f % kVec == 0 && aligned((const char*)y, kVec * (y_is_bf16 ? 2 : 4)) &&
                   aligned16(scale) && aligned16(bias) && aligned(q, kVec);
  cudaStream_t st = (cudaStream_t)stream;
  const int err = y_is_bf16
      ? dispatch<__nv_bfloat16>(y, scale, bias, q, s, b, f, k, threads, vec, kept, st, nullptr)
      : dispatch<float>(y, scale, bias, q, s, b, f, k, threads, vec, kept, st, nullptr);
  if (err == 0) *cluster_k = k;
  return err;
}

// How many clusters of this plan the card holds at once
// (cudaOccupancyMaxActiveClusters), for rows of f aligned elements.
extern "C" int zdc_ln_leaky_rowquant_max_clusters(int y_is_bf16, int f, int k, int threads,
                                                  int* max_clusters) {
  *max_clusters = 0;
  if (!valid_plan(k, threads) || f <= 0) return (int)cudaErrorInvalidValue;
  int kept = 0;
  const bool vec = f % kVec == 0;
  return y_is_bf16 ? dispatch<__nv_bfloat16>(nullptr, nullptr, nullptr, nullptr, nullptr, 1, f, k,
                                             threads, vec, &kept, nullptr, max_clusters)
                   : dispatch<float>(nullptr, nullptr, nullptr, nullptr, nullptr, 1, f, k,
                                     threads, vec, &kept, nullptr, max_clusters);
}
