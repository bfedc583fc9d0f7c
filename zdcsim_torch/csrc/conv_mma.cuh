// The int8 conv core that kernels B, D, G and H share: an implicit GEMM on
// Hopper's int8 tensor cores with an f32 epilogue, driven by a plan of phases.
//
// Included by fused_decode.cu (G's Conv_0, H's Conv_0-2), up2_conv4_int8.cu
// (B: Conv_0's four parity phases on any source grid) and
// row_resize_conv4_int8.cu (D: Conv_1's eight row phases of the 35 -> 56
// resize). Everything here is in an anonymous namespace, so each translation
// unit has its own copy of the kernel instantiations it launches and of their
// shared-memory attribute flags.
//
// One GEMM per phase: M = output positions, N = Cout, K = taps x Cin in
// tap-major order, so a K step of 128 bytes is 128 channels of ONE shifted
// source pixel (NHWC) and 128 contiguous bytes of the weights, which the
// callers pack once as [Cout, taps x Cin]. A block of two warpgroups owns a
// 128 x BN tile (BN = 128, or 64 for 64 output channels), two blocks an SM.
// All 256 threads stage a 3-stage ring in dynamic shared memory with 16-byte
// cp.async copies (a copy of 0 source bytes zero-fills a tap off the grid, so
// the halo costs no branch) into the 128-byte-swizzled K-major layout that
// wgmma reads; each warpgroup then runs wgmma m64nNk32 s8 x s8 -> s32 from
// shared memory, four per K step. The sums are exact in any order (no
// .satfinite; |sum| < 2^31), so with the f32 epilogue (f32(acc) * sk) * sx +
// bias rounded op for op (__fmul_rn/__fadd_rn) every output is bit-identical
// to the plain versions. The epilogue writes two channels at once, as a
// float2 or as two bf16 rounded to nearest even from the same f32 values.
//
// Bound: operations (int8, 1979 TOP/s dense on the H100) for every conv of
// the decode at the 64-row serving tile; chip_smoke.py computes each count.
// Left for later: TMA loads and warp-specialised producer/consumer
// warpgroups (the copies here are issued by the same threads that wait on
// wgmma, and keeping a wgmma group in flight across K steps measured slower
// with that structure), and a persistent grid.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

// Tile: 128 output positions (two warpgroups of 64) x BN output channels a
// block, K steps of 128 bytes, a ring of kConvStages K steps in dynamic shared
// memory, registers capped for kConvMinBlocks blocks an SM. Both were chosen
// by a sweep on the H100 (PERF.md, section 6).
constexpr int kConvStages = 3;
constexpr int kConvMinBlocks = 2;  // blocks per SM that __launch_bounds__ asks registers for
constexpr int kConvThreads = 256;  // two warpgroups
constexpr int kConvBM = 128, kConvBK = 128;
constexpr int kConvMaxPhases = 8;
constexpr int kMaxDevices = 64;  // devices whose shared-memory attribute is remembered

// One GEMM of a conv: output position (i, j) in [0, mh) x [0, mw) of a sample
// sums taps (a, t) in [0, kr) x [0, kc), each reading source pixel
// (i * srs + dr0 + a, j + dc0 + t) (zero off the source grid) against the K
// slab of tap tap0 + a * kc + t of the packed weights kp [cout, taps x cin]
// (K-major, tap-major); it lands on output pixel (i * sr + pr, j * sc + pc),
// is dropped outside the output grid, and takes the weight scales at
// sk[skoff ..].
struct ConvPhase {
  int mh, mw, srs, kr, kc, dr0, dc0, tap0, sr, pr, sc, pc, skoff;
};
struct ConvPlan {
  ConvPhase ph[kConvMaxPhases];  // blockIdx.z selects one
  int h, w;                      // source grid [nb, h, w, cin]
  int oh, ow;                    // output grid [nb, oh, ow, cout]
  int taps;                      // taps of the packed weights (K = taps x cin)
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

// Two neighbouring output channels: a float2, or two bf16 rounded to nearest
// even from the same f32 values (as the plain versions' .to(bfloat16)).
__device__ __forceinline__ void store2(float* o, float x, float y) {
  *reinterpret_cast<float2*>(o) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* o, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(o) =
      __halves2bfloat162(__float2bfloat16_rn(x), __float2bfloat16_rn(y));
}

template <int BN, typename OutT>
__global__ void __launch_bounds__(kConvThreads, kConvMinBlocks)
    conv_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                    const int8_t* __restrict__ kp, const float* __restrict__ sk,
                    const float* __restrict__ bias, OutT* __restrict__ out, int nb, int cin,
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
  // 16 K bytes) this thread stages at every K step; a_i is the position's
  // first source row, i * srs.
  int a_pix[kALoads], a_i[kALoads], a_j[kALoads], a_c[kALoads];
  uint32_t a_dst[kALoads];
#pragma unroll
  for (int l = 0; l < kALoads; ++l) {
    const int idx = tid + l * kConvThreads, r = idx / kChunks, c = idx % kChunks;
    const int m = m0 + r;
    if (m < m_total) {
      const int b = m / mhw, rem = m - b * mhw;
      const int i = rem / ph.mw;
      a_i[l] = i * ph.srs;
      a_j[l] = rem - i * ph.mw;
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
    if (r >= plan.oh || c >= plan.ow) continue;  // e.g. the odd phases' last row/column
    const float sxb = sx[b];
    OutT* o = out + ((size_t)(b * plan.oh + r) * plan.ow + c) * cout;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + j * 8 + 2 * tig;
      const float2 s2 = *reinterpret_cast<const float2*>(sk + ph.skoff + n);
      const float2 b2 = *reinterpret_cast<const float2*>(bias + n);
      store2(o + n,
             __fadd_rn(__fmul_rn(__fmul_rn((float)acc[4 * j + 2 * half], s2.x), sxb), b2.x),
             __fadd_rn(__fmul_rn(__fmul_rn((float)acc[4 * j + 2 * half + 1], s2.y), sxb), b2.y));
    }
  }
}

template <int BN, typename OutT>
int launch_conv_tiles(const int8_t* xq, const float* sx, const int8_t* kp, const float* sk,
                      const float* bias, OutT* out, int nb, int cin, int cout, int ktot,
                      const ConvPlan& plan, int n_phases, cudaStream_t st) {
  constexpr int smem = kConvStages * (kConvBM + BN) * kConvBK + 1024;  // + alignment slack
  const auto kernel = conv_mma_kernel<BN, OutT>;
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

// True for the convs this core takes: cin a multiple of 128 (one K step),
// cout of 64 (one N tile).
inline bool conv_mma_fits(int cin, int cout) { return cin % kConvBK == 0 && cout % 64 == 0; }

// Runs the plan's first n_phases phases. The operands must be aligned: xq and
// kp to 16 bytes, sk and bias to 8, out to two channels.
template <typename OutT>
int launch_conv(const int8_t* xq, const float* sx, const int8_t* kp, const float* sk,
                const float* bias, OutT* out, int nb, int cin, int cout, const ConvPlan& plan,
                int n_phases, cudaStream_t st) {
  if (!conv_mma_fits(cin, cout) || n_phases < 1 || n_phases > kConvMaxPhases)
    return (int)cudaErrorInvalidValue;
  const int ktot = plan.taps * cin;  // K of the packed weights, all phases
  if (cout % 128 == 0)
    return launch_conv_tiles<128>(xq, sx, kp, sk, bias, out, nb, cin, cout, ktot, plan, n_phases,
                                  st);
  return launch_conv_tiles<64>(xq, sx, kp, sk, bias, out, nb, cin, cout, ktot, plan, n_phases, st);
}

// Conv_0 = nearest-2x upsample + 4x4 pad-1 conv as four parity phases on the
// h x w source grid: phase p = 2 * pr + pc covers output pixels (2i + pr,
// 2j + pc) and its taps (a, t) read source offset (a - (pr == 0), t - (pc ==
// 0)); 25 taps, phase slabs at {0, 9, 15, 21}; output [2h - 1, 2w - 1].
inline ConvPlan conv0_plan(int h, int w, int cout) {
  ConvPlan plan{};
  const int tap0[4] = {0, 9, 15, 21};
  for (int p = 0; p < 4; ++p) {
    const int pr = p >> 1, pc = p & 1;
    plan.ph[p] = ConvPhase{h, w, 1, pr ? 2 : 3, pc ? 2 : 3, -(pr == 0), -(pc == 0),
                           tap0[p], 2, pr, 2, pc, p * cout};
  }
  plan.h = h; plan.w = w; plan.oh = 2 * h - 1; plan.ow = 2 * w - 1;
  plan.taps = 25;
  return plan;
}

}  // namespace
