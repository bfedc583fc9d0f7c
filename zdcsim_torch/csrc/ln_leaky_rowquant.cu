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
// does. The body and its launcher live in norm_quant.cuh, which G's and H's
// first stage (fused_decode.cu) instantiates too.

#include <cuda_runtime.h>

#include "norm_quant.cuh"

// y: [b, f] bf16 (y_is_bf16 = 1) or f32; scale, bias: [f] f32; q: [b, f]
// int8; s: [b] f32. k blocks per row (1, 2, 4 or 8) of `threads` threads (a
// multiple of 32, at most 1024): any other plan is refused with
// cudaErrorInvalidValue. On success *cluster_k is the cluster size launched
// and *kept is 1 when each block kept its share in shared memory (0: it
// streamed it). Returns cudaGetLastError() after the launch.
extern "C" int zdc_ln_leaky_rowquant(const void* y, int y_is_bf16, const void* scale,
                                     const void* bias, void* q, void* s, int b, int f, int k,
                                     int threads, int* cluster_k, int* kept, void* stream) {
  return ln_leaky_rowquant_run(y, y_is_bf16, scale, bias, q, s, b, f, k, threads, cluster_k, kept,
                               (cudaStream_t)stream);
}

// How many clusters of this plan the card holds at once
// (cudaOccupancyMaxActiveClusters), for rows of f aligned elements.
extern "C" int zdc_ln_leaky_rowquant_max_clusters(int y_is_bf16, int f, int k, int threads,
                                                  int* max_clusters) {
  *max_clusters = 0;
  if (!ln_valid_plan(k, threads) || f <= 0) return (int)cudaErrorInvalidValue;
  int kept = 0;
  const bool vec = f % kVec == 0;
  return y_is_bf16 ? ln_dispatch<__nv_bfloat16>(nullptr, nullptr, nullptr, nullptr, nullptr, 1, f,
                                                k, threads, vec, &kept, nullptr, max_clusters)
                   : ln_dispatch<float>(nullptr, nullptr, nullptr, nullptr, nullptr, 1, f, k,
                                        threads, vec, &kept, nullptr, max_clusters);
}
