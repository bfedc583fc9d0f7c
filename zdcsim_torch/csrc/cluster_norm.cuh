// Thread-block-cluster plumbing shared by kernels A (ln_leaky_rowquant.cu)
// and C (gn_leaky_rowquant.cu): a cluster of k blocks on neighbouring SMs
// serves one sample, each block a contiguous share of it, and the blocks
// exchange their partial sums through distributed shared memory.
//
// Every reduction runs in a fixed order: a block reduces its threads' values
// with warp shuffles and one shared-memory step, writes its partial into a
// word of its own shared memory that no later exchange reuses, and after
// cluster.sync() every block reads the k partials in rank order. So every
// block of a cluster holds the same sum, bit for bit, and a rerun gives the
// same bits. A block calls cluster.sync() once more before it exits, so no
// block leaves while a peer may still read its shared memory.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

namespace cg = cooperative_groups;

constexpr int kSmemPerBlock = 232448;              // 227 KB, the most one block may use
constexpr int kMaxDynSmem = kSmemPerBlock - 1024;  // room for the kernels' static shared memory
constexpr int kMaxNormDevices = 16;
constexpr int kMaxCluster = 8;  // the largest portable cluster size

inline bool portable_cluster(int k) { return k == 1 || k == 2 || k == 4 || k == 8; }
inline int ceil_div(int a, int b) { return (a + b - 1) / b; }
inline int round_up(int a, int m) { return ceil_div(a, m) * m; }
inline bool aligned(const void* p, int bytes) { return (uintptr_t)p % bytes == 0; }
inline bool aligned16(const void* p) { return aligned(p, 16); }

// LeakyReLU(0.1) as max(z, 0.1 z): for z >= 0 (and -0) that is z, for z < 0
// it is 0.1 z, bit for bit as z >= 0 ? z : 0.1 z, in one instruction fewer.
__device__ __forceinline__ float leaky(float z) { return fmaxf(z, __fmul_rn(0.1f, z)); }

// The divisor sc of a sample's quantisation, with rsc = 1 / sc (IEEE, once
// a sample). z / sc is then q0 = z rsc and one correction by the residual
// z - sc q0, which an FMA forms exactly: while 1 / sc is a normal float,
// that is the correctly rounded quotient, bit for bit what IEEE division
// gives (Markstein's theorem for division by a correctly rounded
// reciprocal), in three instructions in place of the division's reciprocal,
// refinement and range check. sc = max(amax / 127, 1e-12) lies in [1e-12,
// FLT_MAX / 127] for a finite amax, so 1 / sc is normal; an infinite sc
// (an infinite z) divides.
struct Divisor {
  float sc, rsc;
  bool fast;
};

__device__ __forceinline__ Divisor divisor(float sc) { return {sc, 1.0f / sc, sc < INFINITY}; }

__device__ __forceinline__ float divide(float z, const Divisor& d) {
  if (!d.fast) return z / d.sc;
  const float q0 = __fmul_rn(z, d.rsc);
  return __fmaf_rn(__fmaf_rn(-d.sc, q0, z), d.rsc, q0);
}

// The int8 byte of clip(rint(z / sc), -127, 127): the IEEE quotient, clipped
// first (rint commutes with a clip at integers), then rounded half to even
// by adding 1.5 * 2^23, whose float has unit ulp, so the integer is in the
// low mantissa bits: full-rate adds in place of the quarter-rate rint and
// float-to-int conversion.
__device__ __forceinline__ uint32_t quant(float z, const Divisor& d) {
  const float r = fminf(fmaxf(divide(z, d), -127.0f), 127.0f);
  return (uint32_t)(__float_as_int(__fadd_rn(r, 12582912.0f)) - 0x4B400000) & 0xffu;
}

// Sum (is_max = false) or max over the block; every thread gets the result.
// red holds 33 floats.
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

// block_reduce, then over the cluster in rank order: lane r of warp 0 reads
// rank r's partial (the k reads in flight at once) and lane 0 adds them in
// rank order. slot is this exchange's own word of shared memory: no later
// exchange writes it.
__device__ float cluster_reduce(float v, bool is_max, float* red, float* slot) {
  v = block_reduce(v, is_max, red);
  if (threadIdx.x == 0) *slot = v;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // also: every thread has read red[32] of block_reduce
  if (threadIdx.x < 32) {
    const unsigned k = cluster.num_blocks(), lane = threadIdx.x;
    const float u = lane < k ? *cluster.map_shared_rank(slot, lane) : 0.0f;
    float t = __shfl_sync(0xffffffffu, u, 0);
    for (unsigned r = 1; r < k; ++r) {
      const float w = __shfl_sync(0xffffffffu, u, r);
      t = is_max ? fmaxf(t, w) : t + w;
    }
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  return red[32];
}

// Launches kKernel as `grid` blocks of `threads` in clusters of k (grid a
// multiple of k), or, when max_clusters is given, only asks how many such
// clusters the card holds at once (cudaOccupancyMaxActiveClusters). The
// first call for a kernel and device allows it kMaxDynSmem bytes of dynamic
// shared memory (a host-side CUDA call, not one per launch). Returns the
// CUDA error of either.
template <auto kKernel, typename... Args>
int launch_cluster(int grid, int threads, int smem, int k, cudaStream_t st, int* max_clusters,
                   Args... args) {
  static std::atomic<bool> smem_allowed[kMaxNormDevices];
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev >= kMaxNormDevices || !smem_allowed[dev].load(std::memory_order_acquire)) {
    err = (int)cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    kMaxDynSmem);
    if (err) return err;
    if (dev < kMaxNormDevices) smem_allowed[dev].store(true, std::memory_order_release);
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = k;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (max_clusters) return (int)cudaOccupancyMaxActiveClusters(max_clusters, kKernel, &cfg);
  err = (int)cudaLaunchKernelEx(&cfg, kKernel, args...);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace
