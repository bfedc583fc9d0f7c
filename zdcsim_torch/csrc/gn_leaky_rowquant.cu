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
// version. The body and its launcher live in norm_quant.cuh (with the
// writer SameGrid), which G's and H's three GroupNorm stages
// (fused_decode.cu) instantiate with their own writers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "norm_quant.cuh"

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
  return gn_leaky_rowquant_run(x, x_is_bf16, scale, bias, SameGrid{(int8_t*)q, (float*)s}, b, hw,
                               c, groups, k, threads, cluster_k, kept, (cudaStream_t)stream);
}

// How many clusters of this plan the card holds at once
// (cudaOccupancyMaxActiveClusters).
extern "C" int zdc_gn_leaky_rowquant_max_clusters(int x_is_bf16, int hw, int c, int k,
                                                  int threads, int* max_clusters) {
  *max_clusters = 0;
  if (!gn_valid_plan(c, 1, k, threads) || hw <= 0) return (int)cudaErrorInvalidValue;
  int kept = 0;
  const SameGrid none{nullptr, nullptr};
  return x_is_bf16 ? gn_dispatch<__nv_bfloat16>(nullptr, nullptr, nullptr, none, 1, hw, c, 1, k,
                                                threads, &kept, nullptr, max_clusters)
                   : gn_dispatch<float>(nullptr, nullptr, nullptr, none, 1, hw, c, 1, k, threads,
                                        &kept, nullptr, max_clusters);
}
