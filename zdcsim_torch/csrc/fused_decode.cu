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
//  - the convs: one implicit GEMM per phase, M = output positions, N = Cout,
//    K = taps x Cin in tap-major order, so a K step of 128 bytes is 128
//    channels of ONE shifted source pixel (NHWC) and 128 contiguous bytes of
//    the weights, which the wrappers pack once as [Cout, taps x Cin]. A block
//    of two warpgroups owns a 128 x 128 tile (128 x 64 for Conv_2's 64
//    channels), two blocks an SM. All 256 threads stage a 3-stage ring in
//    dynamic shared memory with 16-byte cp.async copies (a copy of 0 source
//    bytes zero-fills a tap off the grid, so the halo costs no branch) into
//    the 128-byte-swizzled K-major layout that wgmma reads; each warpgroup
//    then runs wgmma m64nNk32 s8 x s8 -> s32 from shared memory, four per K
//    step. The sums are exact in any order (no .satfinite; |sum| < 2^31), so
//    with the f32 epilogue rounded op for op every output is bit-identical
//    to the plain versions. The epilogue writes two channels as one float2,
//    through the plan's (i * sr + pr, j * sc + pc) map for Conv_0's phases;
//  - the GroupNorms: one block of 512 threads per sample, per-channel then
//    per-group sums in a fixed order (no atomics: a rerun is bit-identical);
//    the quantise pass walks the OUTPUT grid, so the nearest resize costs
//    nothing beyond reading a source pixel once per output pixel;
//  - GroupNorm_2 + Conv_3: one block per sample; after the statistics, one
//    warp per output pixel normalises its 4 x 64 inputs on the fly and sums
//    them with a fixed shuffle tree.
// Left for later: TMA loads and warp-specialised producer/consumer
// warpgroups (the copies here are issued by the same threads that wait on
// wgmma, and keeping a wgmma group in flight across K steps measured slower
// with that structure), a persistent grid, and a cluster that keeps a sample
// on chip between the stages.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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
// 2, 4, 6. int8 convs as implicit GEMMs on the int8 tensor cores, f32 epilogue
// ---------------------------------------------------------------------------

// Tile: 128 output positions (two warpgroups of 64) x BN output channels a
// block (BN = 128, or 64 for Conv_2's 64 channels), K steps of 128 bytes, a
// ring of kConvStages K steps in dynamic shared memory, registers capped for
// kConvMinBlocks blocks an SM. Both were chosen by a sweep on the H100
// (PERF.md, section 6).
constexpr int kConvStages = 3;
constexpr int kConvMinBlocks = 2;  // blocks per SM that __launch_bounds__ asks registers for
constexpr int kConvThreads = 256;  // two warpgroups
constexpr int kConvBM = 128, kConvBK = 128;
constexpr int kMaxDevices = 64;  // devices whose shared-memory attribute is remembered

// One GEMM of a conv: output position (i, j) in [0, mh) x [0, mw) of a sample
// sums taps (a, t) in [0, kr) x [0, kc), each reading source pixel
// (i + dr0 + a, j + dc0 + t) (zero off the source grid) against the K slab of
// tap tap0 + a * kc + t of the packed weights kp [cout, taps x cin] (K-major,
// tap-major); it lands on output pixel (i * sr + pr, j * sc + pc) and is
// dropped outside the output grid.
struct ConvPhase {
  int mh, mw, kr, kc, dr0, dc0, tap0, sr, pr, sc, pc, skoff;
};
struct ConvPlan {
  ConvPhase ph[4];  // blockIdx.z selects one
  int h, w;         // source grid [nb, h, w, cin]
  int oh, ow;       // output grid [nb, oh, ow, cout]
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  // copies src_bytes (16 or 0) and zero-fills the rest of the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte offset of 16-byte chunk c of tile row r: rows of 128 bytes, the chunk
// index XORed with the row's index mod 8. This is the 128-byte swizzle that
// wgmma reads (8-row groups of 1024 bytes, from a 1024-byte-aligned base),
// and it keeps the cp.async stores free of bank conflicts.
__device__ __forceinline__ int swizzle(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// wgmma's shared-memory descriptor of a K-major tile in that layout: start
// address, leading offset (unused with a swizzle), 1024 bytes between 8-row
// groups, 128-byte swizzle.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// d += a (64 x 32 s8, K-major) * b (32 x N s8, K-major) in s32, exactly (no
// .satfinite: |sum| <= 127^2 * 4608 < 2^31, so the order never matters).
__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_m64n64k32(int (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}
template <int BN>
__device__ __forceinline__ void wgmma_tile(int (&d)[BN / 2], uint64_t a, uint64_t b) {
  if constexpr (BN == 128) wgmma_m64n128k32(d, a, b);
  else wgmma_m64n64k32(d, a, b);
}

template <int BN>
__global__ void __launch_bounds__(kConvThreads, kConvMinBlocks)
    conv_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                    const int8_t* __restrict__ kp, const float* __restrict__ sk,
                    const float* __restrict__ bias, float* __restrict__ out, int nb, int cin,
                    int cout, int ktot, ConvPlan plan) {
  constexpr int BM = kConvBM, BK = kConvBK, STAGES = kConvStages, kChunks = BK / 16;
  constexpr int kALoads = BM * kChunks / kConvThreads, kBLoads = BN * kChunks / kConvThreads;
  constexpr int kABytes = BM * BK, kStageBytes = (BM + BN) * BK;
  static_assert(BN == 64 || BN == 128, "BN is 64 or 128");
  static_assert(kStageBytes % 1024 == 0, "stages stay 1024-byte aligned");
  extern __shared__ uint8_t smem[];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to that
  const uint32_t smem0 = ((uint32_t)__cvta_generic_to_shared(smem) + 1023u) & ~1023u;

  const ConvPhase ph = plan.ph[blockIdx.z];
  const int mhw = ph.mh * ph.mw;
  const int m_total = nb * mhw;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if (m0 >= m_total) return;  // the grid is sized for the longest phase
  const int h = plan.h, w = plan.w;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;  // warpgroup: output positions 64 * wg ..

  // The A chunks (output position, 16 channels) and B chunks (output channel,
  // 16 K bytes) this thread stages at every K step.
  int a_pix[kALoads], a_i[kALoads], a_j[kALoads], a_c[kALoads];
  uint32_t a_dst[kALoads];
#pragma unroll
  for (int l = 0; l < kALoads; ++l) {
    const int idx = tid + l * kConvThreads, r = idx / kChunks, c = idx % kChunks;
    const int m = m0 + r;
    if (m < m_total) {
      const int b = m / mhw, rem = m - b * mhw;
      a_i[l] = rem / ph.mw;
      a_j[l] = rem - a_i[l] * ph.mw;
      a_pix[l] = (b * h + a_i[l]) * w + a_j[l];
    } else {
      a_i[l] = -(1 << 20);  // off every grid: always zero-filled
      a_j[l] = a_pix[l] = 0;
    }
    a_c[l] = c * 16;
    a_dst[l] = swizzle(r, c);
  }
  const int8_t* b_src[kBLoads];
  uint32_t b_dst[kBLoads];
#pragma unroll
  for (int l = 0; l < kBLoads; ++l) {
    const int idx = tid + l * kConvThreads, r = idx / kChunks, c = idx % kChunks;
    b_src[l] = kp + (size_t)(n0 + r) * ktot + (size_t)ph.tap0 * cin + c * 16;
    b_dst[l] = kABytes + swizzle(r, c);
  }

  // The next K step to stage: tap (ld_a, ld_t), channel block ld_c, at byte
  // ld_k of the phase's K slab (tap-major, so ld_k just advances by BK).
  const int csteps = cin / BK, nk = ph.kr * ph.kc * csteps;
  int ld_a = 0, ld_t = 0, ld_c = 0, ld_k = 0;
  auto stage = [&](int slot) {
    const int dr = ph.dr0 + ld_a, dc = ph.dc0 + ld_t;
    const int shift = dr * w + dc, cpos = ld_c * BK;
    const uint32_t base = smem0 + slot * kStageBytes;
#pragma unroll
    for (int l = 0; l < kALoads; ++l) {
      const int si = a_i[l] + dr, sj = a_j[l] + dc;
      const bool ok = si >= 0 && si < h && sj >= 0 && sj < w;
      const int8_t* src = ok ? xq + (size_t)(a_pix[l] + shift) * cin + cpos + a_c[l] : xq;
      cp_async16(base + a_dst[l], src, ok ? 16 : 0);
    }
#pragma unroll
    for (int l = 0; l < kBLoads; ++l) cp_async16(base + b_dst[l], b_src[l] + ld_k, 16);
    ld_k += BK;
    if (++ld_c == csteps) {
      ld_c = 0;
      if (++ld_t == ph.kc) {
        ld_t = 0;
        ++ld_a;
      }
    }
  };

  int acc[BN / 2];
#pragma unroll
  for (int e = 0; e < BN / 2; ++e) acc[e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // step kt has landed (this thread's copies)
    // order those generic-proxy writes before wgmma's async-proxy reads
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // ... everyone's; and step kt - 1's slot is read
    if (kt + STAGES - 1 < nk) stage((kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const uint32_t sa = smem0 + (kt % STAGES) * kStageBytes;
    const uint64_t da = wgmma_desc(sa + wg * 64 * BK), db = wgmma_desc(sa + kABytes);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks)  // +32 bytes = +2 in the descriptor's 16-byte units
      wgmma_tile<BN>(acc, da + 2 * ks, db + 2 * ks);
    wgmma_commit();
    wgmma_wait<0>();
  }

  // Epilogue: in each warp's 16 rows of its warpgroup's 64, acc[4 * j + 2 *
  // half + e] is row g + 8 * half, channel 8 * j + 2 * (lane % 4) + e.
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + wg * 64 + (warp & 3) * 16 + half * 8 + g;
    if (m >= m_total) continue;
    const int b = m / mhw, rem = m - b * mhw;
    const int mi = rem / ph.mw, mj = rem - mi * ph.mw;
    const int r = mi * ph.sr + ph.pr, c = mj * ph.sc + ph.pc;
    if (r >= plan.oh || c >= plan.ow) continue;  // the odd phases' last row/column
    const float sxb = sx[b];
    float* o = out + ((size_t)(b * plan.oh + r) * plan.ow + c) * cout;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + j * 8 + 2 * tig;
      const float2 s2 = *reinterpret_cast<const float2*>(sk + ph.skoff + n);
      const float2 b2 = *reinterpret_cast<const float2*>(bias + n);
      float2 v;
      v.x = __fadd_rn(__fmul_rn(__fmul_rn((float)acc[4 * j + 2 * half], s2.x), sxb), b2.x);
      v.y = __fadd_rn(__fmul_rn(__fmul_rn((float)acc[4 * j + 2 * half + 1], s2.y), sxb), b2.y);
      *reinterpret_cast<float2*>(o + n) = v;
    }
  }
}

template <int BN>
int launch_conv_tiles(const int8_t* xq, const float* sx, const int8_t* kp, const float* sk,
                      const float* bias, float* out, int nb, int cin, int cout, int ktot,
                      const ConvPlan& plan, int n_phases, cudaStream_t st) {
  constexpr int smem = kConvStages * (kConvBM + BN) * kConvBK + 1024;  // + alignment slack
  const auto kernel = conv_mma_kernel<BN>;
  // Above 48 KB a block's dynamic shared memory must be allowed per kernel
  // and device: once each, not per launch (a host-side CUDA call).
  static std::atomic<bool> smem_allowed[kMaxDevices];
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev >= kMaxDevices || !smem_allowed[dev].load(std::memory_order_acquire)) {
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
    if (dev < kMaxDevices) smem_allowed[dev].store(true, std::memory_order_release);
  }
  int max_m = 0;
  for (int p = 0; p < n_phases; ++p) {
    const int m = nb * plan.ph[p].mh * plan.ph[p].mw;
    max_m = m > max_m ? m : max_m;
  }
  dim3 grid((max_m + kConvBM - 1) / kConvBM, cout / BN, n_phases);
  kernel<<<grid, kConvThreads, smem, st>>>(xq, sx, kp, sk, bias, out, nb, cin, cout, ktot, plan);
  return (int)cudaGetLastError();
}

// The plan's convs: cin a multiple of 128, cout of 64 (every conv here).
int launch_conv(const int8_t* xq, const float* sx, const int8_t* kp, const float* sk,
                const float* bias, float* out, int nb, int cin, int cout, const ConvPlan& plan,
                int n_phases, cudaStream_t st) {
  if (cin % kConvBK != 0 || cout % 64 != 0) return (int)cudaErrorInvalidValue;
  int taps = 0;
  for (int p = 0; p < n_phases; ++p) taps += plan.ph[p].kr * plan.ph[p].kc;
  const int ktot = taps * cin;  // K of the packed weights, all phases
  if (cout % 128 == 0)
    return launch_conv_tiles<128>(xq, sx, kp, sk, bias, out, nb, cin, cout, ktot, plan, n_phases,
                                  st);
  return launch_conv_tiles<64>(xq, sx, kp, sk, bias, out, nb, cin, cout, ktot, plan, n_phases,
                               st);
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

ConvPlan conv0_plan() {
  ConvPlan plan{};
  const int tap0[4] = {0, 9, 15, 21};
  for (int p = 0; p < 4; ++p) {
    const int pr = p >> 1, pc = p & 1;
    // phase p: taps (a, t) read source offset (a - (pr == 0), t - (pc == 0))
    plan.ph[p] = ConvPhase{H0, W0, pr ? 2 : 3, pc ? 2 : 3, -(pr == 0), -(pc == 0),
                           tap0[p], 2, pr, 2, pc, p * C1};
  }
  plan.h = H0; plan.w = W0; plan.oh = H1; plan.ow = W1;
  return plan;
}

// A plain k x k pad-1 conv from an h x w grid to the 55 x 29 grid.
ConvPlan pad1_plan(int k, int h, int w) {
  ConvPlan plan{};
  plan.ph[0] = ConvPhase{HV, WV, k, k, -1, -1, 0, 1, 0, 1, 0, 0};
  plan.h = h; plan.w = w; plan.oh = HV; plan.ow = WV;
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
  err = launch_conv(ws_i8, ws_sx, f.kp0, f.sk0, f.b0, ws_f32, nb, C0, C1, conv0_plan(), 4, st);
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
    case 0: return launch_conv(x, s, w, k, b, o, nb, C0, C1, conv0_plan(), 4, st);
    case 1: return launch_conv(x, s, w, k, b, o, nb, C1, C2, pad1_plan(4, HG, WG), 1, st);
    case 2: return launch_conv(x, s, w, k, b, o, nb, C2, C3, pad1_plan(3, HV, WV), 1, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
