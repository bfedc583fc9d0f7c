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
// Design: a thread-block cluster of k blocks serves each sample (grid b * k;
// k from the launch plan, zdcsim_torch/ops/decode_kernels.py
// norm_quant_plan: at the serving tile k = 2, 128 blocks of 512 threads, one
// wave). Each block takes a contiguous range of ceil(HW / k) pixels and
// copies it from device memory once, as it lies (bf16 or f32), into its
// shared memory with 16-byte cp.async copies, all in flight at once: at the
// serving tile 333 pixels x 256 channels, 170 KB of bf16. Each thread owns
// one block of 8 consecutive channels and a fixed stride of pixels, so the
// threads of a warp touch consecutive 16-byte chunks, and keeps 8
// per-channel sums of x and x^2, minima and maxima in registers. The block
// reduces them per channel in shared memory in a fixed order; the cluster
// exchanges the per-channel partials through distributed shared memory and
// every block adds them in rank order (cluster_norm.cuh), then forms the
// same group mu and 1/sigma, bit for bit. max|y| needs no second pass and
// no second exchange: y is monotone in x within a channel, so |y| peaks at
// the channel's least or greatest x. Then the quantise pass from the kept
// copy, 8 int8 (one 8-byte store) a thread at a time. A share that does not
// fit in 227 KB (a sample above about 1.6 MB at k = 8) is streamed from
// device memory in each pass instead. No atomics: a rerun is bit-identical.
// The elementwise transform uses __fmul_rn/__fadd_rn/__fsub_rn so the
// compiler does not contract it into FMAs: it rounds exactly as the plain
// version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_norm.cuh"

namespace {

constexpr int kMaxThreads = 1024;

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

__device__ __forceinline__ float transform(float x, float mu, float rstd, float sc, float bi) {
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

// Shared memory of a block: the kept pixels (kKeep), then the floats
// red[threads * 8]; part[4][c], this block's per-channel sum x, sum x^2,
// min x and max x, which the cluster reads; tot[4][c], the sample's; gmu,
// grs ([c] each, groups <= c).
inline int fixed_smem(int c, int threads) { return 4 * (threads * 8 + 10 * c); }

// One block of the cluster that serves sample blockIdx.x / k: pixels
// [rank * share, rank * share + np).
template <typename T, bool kKeep>
__global__ void __launch_bounds__(kMaxThreads, 1)
    gn_leaky_rowquant_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                             const float* __restrict__ bias, int8_t* __restrict__ q,
                             float* __restrict__ s, int hw, int c, int groups, int share) {
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
  const size_t base = ((size_t)sample * hw + pbeg) * c + cb * 8;
  const T* xs = x + base;
  int8_t* qs = q + base;
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
  // per-channel sum x, sum x^2, min x and max x
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
      mn[i] = fminf(mn[i], v[i]);
      mx[i] = fmaxf(mx[i], v[i]);
    }
  }
  column_reduce<Op::kSum>(s1, red, p0, cb, ps, c, part);
  column_reduce<Op::kSum>(s2, red, p0, cb, ps, c, part + c);
  column_reduce<Op::kMin>(mn, red, p0, cb, ps, c, part + 2 * c);
  column_reduce<Op::kMax>(mx, red, p0, cb, ps, c, part + 3 * c);
  cluster.sync();  // every block's partials are written
  // each of the 4c totals from the k ranks' partials, their reads in flight
  // at once, added in rank order
  const int k = (int)cluster.num_blocks();
  for (int i = threadIdx.x; i < 4 * c; i += blockDim.x) {
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

  // max |y| over the sample from each channel's least and greatest x: y is
  // monotone in x within a channel (every rounding step is), so |y| peaks at
  // one of the two, and this max equals the max over every element bit for
  // bit. Every block holds the same totals, so no exchange is needed.
  float amax = 0.0f;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const int g = ch / cg_;
    const float lo = transform(tot[2 * c + ch], gmu[g], grs[g], scale[ch], bias[ch]);
    const float hi = transform(tot[3 * c + ch], gmu[g], grs[g], scale[ch], bias[ch]);
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

  // quantise, 8 int8 values (one 8-byte store) per pixel
  for (int p = p0; p < np; p += ps) {
    to_f32(load_pix(kKeep ? ks + (size_t)p * c : xs + (size_t)p * c), v);
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t b = quant(transform(v[i], mu_r[i], rs_r[i], sc_r[i], bi_r[i]), d);
      if (i < 4) lo |= b << (8 * i); else hi |= b << (8 * (i - 4));
    }
    *reinterpret_cast<uint2*>(qs + (size_t)p * c) = make_uint2(lo, hi);
  }
  if (cluster.block_rank() == 0 && threadIdx.x == 0) s[sample] = sc;
  cluster.sync();  // no block exits while a peer may still read its partials
}

template <typename T>
int dispatch(const void* x, const void* scale, const void* bias, void* q, void* s, int b, int hw,
             int c, int groups, int k, int threads, int* kept, cudaStream_t st,
             int* max_clusters) {
  const int share = ceil_div(hw, k);
  const long long keep_bytes = (long long)share * c * sizeof(T);
  const int fixed = fixed_smem(c, threads);
  *kept = keep_bytes + fixed <= kMaxDynSmem;
  const T* xt = (const T*)x;
  const float *sc = (const float*)scale, *bi = (const float*)bias;
  if (*kept)
    return launch_cluster<gn_leaky_rowquant_kernel<T, true>>(
        b * k, threads, (int)keep_bytes + fixed, k, st, max_clusters, xt, sc, bi, (int8_t*)q,
        (float*)s, hw, c, groups, share);
  return launch_cluster<gn_leaky_rowquant_kernel<T, false>>(
      b * k, threads, fixed, k, st, max_clusters, xt, sc, bi, (int8_t*)q, (float*)s, hw, c,
      groups, share);
}

// c a multiple of 8 with c / 8 dividing 128, groups dividing c, and a whole
// number of pixels for the threads: 128, 256, .. 1024 of them.
bool valid_plan(int c, int groups, int k, int threads) {
  return c > 0 && c % 8 == 0 && 128 % (c / 8) == 0 && groups > 0 && c % groups == 0 &&
         portable_cluster(k) && threads % 128 == 0 && threads >= 128 && threads <= kMaxThreads;
}

}  // namespace

// x: [b, hw, c] bf16 (x_is_bf16 = 1) or f32, 16-byte aligned; scale, bias:
// [c] f32; q: [b, hw, c] int8; s: [b] f32. c must be a multiple of 8 with
// c / 8 dividing 128, and groups must divide c. k blocks per sample (1, 2, 4
// or 8) of `threads` threads (a multiple of 128, at most 1024); any other
// plan is refused with cudaErrorInvalidValue. On success
// *cluster_k is the cluster size launched and *kept is 1 when each block
// kept its pixels in shared memory (0: it streamed them). Returns
// cudaGetLastError() after the launch.
extern "C" int zdc_gn_leaky_rowquant(const void* x, int x_is_bf16, const void* scale,
                                     const void* bias, void* q, void* s, int b, int hw, int c,
                                     int groups, int k, int threads, int* cluster_k, int* kept,
                                     void* stream) {
  *cluster_k = 0;
  *kept = 0;
  if (!valid_plan(c, groups, k, threads)) return (int)cudaErrorInvalidValue;
  if (b <= 0 || hw <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int err = x_is_bf16 ? dispatch<__nv_bfloat16>(x, scale, bias, q, s, b, hw, c, groups, k,
                                                      threads, kept, st, nullptr)
                            : dispatch<float>(x, scale, bias, q, s, b, hw, c, groups, k,
                                              threads, kept, st, nullptr);
  if (err == 0) *cluster_k = k;
  return err;
}

// How many clusters of this plan the card holds at once
// (cudaOccupancyMaxActiveClusters).
extern "C" int zdc_gn_leaky_rowquant_max_clusters(int x_is_bf16, int hw, int c, int k,
                                                  int threads, int* max_clusters) {
  *max_clusters = 0;
  if (!valid_plan(c, 1, k, threads) || hw <= 0) return (int)cudaErrorInvalidValue;
  int kept = 0;
  return x_is_bf16 ? dispatch<__nv_bfloat16>(nullptr, nullptr, nullptr, nullptr, nullptr, 1, hw,
                                             c, 1, k, threads, &kept, nullptr, max_clusters)
                   : dispatch<float>(nullptr, nullptr, nullptr, nullptr, nullptr, 1, hw, c, 1, k,
                                     threads, &kept, nullptr, max_clusters);
}
