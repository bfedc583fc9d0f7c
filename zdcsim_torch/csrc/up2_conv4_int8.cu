// Nearest-2x upsample + 4x4 pad-1 conv on int8 data, as four parity phases.
//
// Replaces the Pallas TPU kernel `up2_conv4_int8` (zdcsim/ops/pallas_decode.py:211,
// body `_make_conv_kernel`, call `_call_up2`). Nearest upsampling repeats
// each source pixel 2x2, so output pixel (2i+pr, 2j+pc) of
// conv4x4(pad1, up2(x)) is a conv of the SOURCE grid with a merged kernel of
// phase p = 2*pr + pc (ee, eo, oe, oo): 3x3, 3x2, 2x3, 2x2 taps, 25 in all.
// Tap (a, b) of phase p reads source offset
//   dr = a - (pr == 0),  dc = b - (pc == 0)
// (`_PHASE_OFFSETS`, pallas_decode.py:122-128); taps that fall off the
// source grid read zero. Per phase:
//   acc[b, i, j, co] = sum_taps sum_ci xq[b, i+dr, j+dc, ci] * kq[tap, ci, co]  (int32)
//   out[b, 2i+pr, 2j+pc, co] = float(acc) * sk[p, co] * sx[b] + bias[co]
// written straight into the interleaved [B, 2H-1, 2W-1, Cout] output.
//
// Bound on the H100: operations. The serving shape (64 samples of
// 18x10x512 -> 256) needs 64 * 3956 tap-positions that read the source
// grid (taps on the zero halo need no work) * 512 * 256 * 2 = 66.4 G int8
// operations against ~31 MB of traffic: 33.5 us at 1979 TOP/s, 9 us of
// bytes.
//
// Design: a GEMM per phase with M = B*H*W source positions, N = Cout and
// K = taps * Cin, over the weights packed once as [Cout, 25 x Cin] (K-major,
// tap-major, phase p's taps from slab {0, 9, 15, 21}[p]). Two bodies, chosen
// by shape (the wrapper counts which one ran):
//  - Cin a multiple of 128 and Cout of 64 (the full-width teacher's 512 ->
//    256): conv_mma.cuh's implicit GEMM on the int8 tensor cores (wgmma s8,
//    exact int32 sums) with conv0_plan(h, w), the plan that kernel G's
//    Conv_0 runs;
//  - any other Cin (a multiple of 4) and Cout (the narrow students): the
//    first kernel, on `__dp4a` (4 int8 products per instruction, int32
//    accumulate). A block of 256 threads owns a 64 x 64 output tile of one
//    phase and walks K in steps of one tap x 32 input channels; each step
//    stages the shifted, masked activations (64 rows x 32 channels) and the
//    weights (32 channels x 64 couts, 4 channels per aligned 32-bit load of
//    the packed weights) in shared memory, and each thread accumulates a
//    4 x 4 sub-tile.
// Both epilogues round exactly as the plain PyTorch version does
// (__fmul_rn/__fadd_rn, no FMA contraction), so the two bodies and the plain
// version agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_mma.cuh"

namespace {

constexpr int BM = 64;       // source positions per block
constexpr int BN = 64;       // output channels per block
constexpr int KW = 8;        // 32-bit words (4 int8 channels each) per K step
constexpr int TM = 4, TN = 4;
constexpr int kThreads = 256;
constexpr int APAD = 4;      // keeps the A-tile stores free of bank conflicts
constexpr int BPAD = 4;      // and the B-tile stores

__device__ __forceinline__ void store_out(float* out, size_t i, float v) { out[i] = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* out, size_t i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    up2_conv4_int8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                          const int8_t* __restrict__ kp, const float* __restrict__ sk,
                          const float* __restrict__ bias, OutT* __restrict__ out, int nb,
                          int h, int w, int cin, int cout) {
  __shared__ __align__(16) int As[KW][BM + APAD];
  __shared__ __align__(16) int Bs[KW][BN + BPAD];

  const int p = blockIdx.z;  // 0 ee, 1 eo, 2 oe, 3 oo
  const int pr = p >> 1, pc = p & 1;
  const int lr = pr ? 2 : 3, lc = pc ? 2 : 3;
  const int tap0 = p == 0 ? 0 : p == 1 ? 9 : p == 2 ? 15 : 21;
  const int hw = h * w;
  const int m_total = nb * hw;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int cw = cin >> 2;  // 32-bit words per source pixel
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  // The two A words and two B words this thread stages at every K step.
  int a_m[2], a_kw[2], a_b[2], a_i[2], a_j[2];
  int b_n[2], b_kw[2];
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const int idx = tid + l * kThreads;
    a_m[l] = idx >> 3;
    a_kw[l] = idx & 7;
    const int m = m0 + a_m[l];
    a_b[l] = m / hw;
    a_i[l] = (m / w) % h;
    a_j[l] = m % w;
    if (m >= m_total) a_b[l] = -1;
    b_n[l] = idx >> 3;  // 8 neighbouring threads read one channel's 32 bytes
    b_kw[l] = idx & 7;
  }

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  const int* x32 = reinterpret_cast<const int*>(xq);
  const int* k32 = reinterpret_cast<const int*>(kp);  // [cout, 25 * cw] words
  for (int ta = 0; ta < lr; ++ta) {
    for (int tb = 0; tb < lc; ++tb) {
      const int dr = ta - (pr == 0), dc = tb - (pc == 0);
      const int tap = tap0 + ta * lc + tb;
      for (int w0 = 0; w0 < cw; w0 += KW) {
#pragma unroll
        for (int l = 0; l < 2; ++l) {
          const int si = a_i[l] + dr, sj = a_j[l] + dc, wd = w0 + a_kw[l];
          int v = 0;
          if (a_b[l] >= 0 && si >= 0 && si < h && sj >= 0 && sj < w && wd < cw)
            v = x32[((size_t)(a_b[l] * h + si) * w + sj) * cw + wd];
          As[a_kw[l]][a_m[l]] = v;

          // channels 4 wb .. 4 wb + 3 of tap `tap`, output n: one word
          const int n = n0 + b_n[l], wb = w0 + b_kw[l];
          Bs[b_kw[l]][b_n[l]] =
              (n < cout && wb < cw) ? k32[((size_t)n * 25 + tap) * cw + wb] : 0;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < KW; ++k) {
          const int4 a4 = *reinterpret_cast<const int4*>(&As[k][ty * TM]);
          const int4 b4 = *reinterpret_cast<const int4*>(&Bs[k][tx * TN]);
          const int a[TM] = {a4.x, a4.y, a4.z, a4.w};
          const int bv[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
  }

  const int ho = 2 * h - 1, wo = 2 * w - 1;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= m_total) continue;
    const int b = m / hw, si = (m / w) % h, sj = m % w;
    const int r = 2 * si + pr, c = 2 * sj + pc;
    if (r >= ho || c >= wo) continue;  // the odd phases' last row/column is trimmed
    const float sxb = sx[b];
    const size_t base = ((size_t)(b * ho + r) * wo + c) * cout;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n >= cout) continue;
      float v = __fmul_rn(__fmul_rn((float)acc[i][j], sk[p * cout + n]), sxb);
      store_out(out, base + n, __fadd_rn(v, bias[n]));
    }
  }
}

}  // namespace

// xq: [nb, h, w, cin] int8 (cin % 4 == 0; 16-byte aligned, as kp is); sx:
// [nb] f32; kp: [cout, 25 * cin] int8, the phase taps [25, cin, cout] packed
// K-major; sk: [4, cout] f32 and bias: [cout] f32, 8-byte aligned; out: [nb,
// 2h-1, 2w-1, cout] bf16 (out_is_bf16 = 1) or f32. Runs the tensor-core body
// where conv_mma_fits(cin, cout), the __dp4a body otherwise, and sets
// *on_mma to 1 or 0 by which one it launched. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a shape it does not take.
extern "C" int zdc_up2_conv4_int8(const void* xq, const void* sx, const void* kp,
                                  const void* sk, const void* bias, void* out,
                                  int out_is_bf16, int nb, int h, int w, int cin, int cout,
                                  int* on_mma, void* stream) {
  *on_mma = 0;
  if (nb <= 0) return (int)cudaSuccess;
  if (cin % 4 != 0 || h <= 0 || w <= 0 || cout <= 0) return (int)cudaErrorInvalidValue;
  const int8_t* x = (const int8_t*)xq;
  const int8_t* k = (const int8_t*)kp;
  const float *s = (const float*)sx, *skf = (const float*)sk, *b = (const float*)bias;
  cudaStream_t st = (cudaStream_t)stream;
  if (conv_mma_fits(cin, cout)) {
    *on_mma = 1;
    const ConvPlan plan = conv0_plan(h, w, cout);
    if (out_is_bf16)
      return launch_conv(x, s, k, skf, b, (__nv_bfloat16*)out, nb, cin, cout, plan, 4, st);
    return launch_conv(x, s, k, skf, b, (float*)out, nb, cin, cout, plan, 4, st);
  }
  const int m_total = nb * h * w;
  dim3 grid((m_total + BM - 1) / BM, (cout + BN - 1) / BN, 4);
  if (out_is_bf16)
    up2_conv4_int8_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        x, s, k, skf, b, (__nv_bfloat16*)out, nb, h, w, cin, cout);
  else
    up2_conv4_int8_kernel<float><<<grid, kThreads, 0, st>>>(x, s, k, skf, b, (float*)out, nb, h,
                                                            w, cin, cout);
  return (int)cudaGetLastError();
}
