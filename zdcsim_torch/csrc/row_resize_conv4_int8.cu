// Nearest row-resize + 4x4 pad-1 conv on int8 data, as Q row phases.
//
// Replaces the Pallas TPU kernel `row_resize_conv4_int8`
// (zdcsim/ops/pallas_decode.py:463, body `_make_rowconv_kernel`). The
// proton generator's Conv_1 runs on the 35x19 grid resized to 56x30; the
// columns are resized beforehand (an int8 gather), and the row resize
// 35 -> 56 repeats with period Q = 8 output rows per P = 5 source rows.
// Within row phase ph (output rows i = r*Q + ph) the conv's 4 row taps hit
// at most 3 distinct source rows, so the taps on one source row are merged
// into one kernel row (zdcsim_torch.models.proton_fast._row_phase_plan,
// ops/decode_kernels._quant_row_phases). Per phase:
//   acc[b, r, j, co] = sum_l sum_{t<4} sum_ci
//       xq[b, P*r + off[ph][l], j + t - 1, ci] * kq[ph, 4l + t, ci, co]   (int32)
//   out[b, r*Q + ph, j, co] = float(acc) * sk[ph, co] * sx[b] + bias[co]
// written straight into the interleaved [B, n_rows, W, Cout] output; taps
// that fall off the source grid read zero. A phase with fewer groups than
// the others (phase 7 has 2 of 3) is padded with a group of zero weights.
//
// Bound on the H100: operations. The serving shape (64 samples of 35x30x256
// -> 55x30x128) needs about 1.2 G int8 operations per sample for the taps
// that read the source grid, against ~8.6 MB of traffic: roughly 38 us at
// 1979 TOP/s (chip_smoke.py computes the exact count).
//
// Design: a GEMM per phase with M = B * rows_in_phase * W output positions,
// N = Cout and K = groups x 4 column taps x Cin, over the weights packed once
// as [Cout, Q x maxL x 4 x Cin] (K-major, tap-major: phase ph's taps from slab
// ph * maxL * 4), so no padded or resized copy of the input exists. Two
// bodies, chosen by shape (the wrapper counts which one ran):
//  - Cin a multiple of 128 and Cout of 64 (the full-width teacher's 256 ->
//    128): conv_mma.cuh's implicit GEMM on the int8 tensor cores (wgmma s8,
//    exact int32 sums), one ConvPhase per row phase. Each phase's merged row
//    groups read consecutive source rows (offsets d0, d0 + 1, ..), so output
//    row r of the phase reads source rows 5 r + d0 + a, a < the phase's real
//    group count: a source-row stride of 5 and a row tap per group; the
//    zero-padded group is skipped (its weights are 0, so this is exact).
//  - any other Cin (a multiple of 4) and Cout (the narrow students): kernel
//    B's first body on `__dp4a` (4 int8 products per instruction, int32
//    accumulate). A block of 256 threads owns a 64 x 64 output tile of one
//    phase and walks K in steps of one tap x 32 input channels; each step
//    stages the shifted, masked activations (64 rows x 32 channels) and the
//    weights (32 channels x 64 couts, one aligned 32-bit load per 4 channels
//    of the packed weights) in shared memory. It sums the zero-padded group
//    like the others.
// Both epilogues round exactly as the plain PyTorch version does
// (__fmul_rn/__fadd_rn, no FMA contraction), so the two bodies and the plain
// version agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_mma.cuh"

namespace {

constexpr int BM = 64;       // output positions per block
constexpr int BN = 64;       // output channels per block
constexpr int KW = 8;        // 32-bit words (4 int8 channels each) per K step
constexpr int TM = 4, TN = 4;
constexpr int kThreads = 256;
constexpr int APAD = 4;      // keeps the A-tile stores free of bank conflicts
constexpr int BPAD = 4;      // and the B-tile stores
constexpr int kMaxPhases = 8, kMaxGroups = 4;

struct RowPlan {
  int off[kMaxPhases][kMaxGroups];  // source row offset of each phase's merged group
};

__device__ __forceinline__ void store_out(float* out, size_t i, float v) { out[i] = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* out, size_t i, float v) {
  out[i] = __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    row_resize_conv4_int8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                                 const int8_t* __restrict__ kp, const float* __restrict__ sk,
                                 const float* __restrict__ bias, OutT* __restrict__ out, int nb,
                                 int h, int w, int cin, int cout, int nq, int p_num, int max_l,
                                 int n_rows, RowPlan plan) {
  __shared__ __align__(16) int As[KW][BM + APAD];
  __shared__ __align__(16) int Bs[KW][BN + BPAD];

  const int ph = blockIdx.z;
  const int n_phase = (n_rows - ph + nq - 1) / nq;  // output rows of this phase
  const int rw = n_phase * w;
  const int m_total = nb * rw;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if (m0 >= m_total) return;  // the grid is sized for the longest phase
  const int cw = cin >> 2;    // 32-bit words per source pixel
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;

  // The two A words and two B words this thread stages at every K step.
  int a_m[2], a_kw[2], a_b[2], a_r[2], a_j[2];
  int b_n[2], b_kw[2];
#pragma unroll
  for (int l = 0; l < 2; ++l) {
    const int idx = tid + l * kThreads;
    a_m[l] = idx >> 3;
    a_kw[l] = idx & 7;
    const int m = m0 + a_m[l];
    a_b[l] = m < m_total ? m / rw : -1;
    a_r[l] = (m / w) % n_phase;
    a_j[l] = m % w;
    b_n[l] = idx >> 3;  // 8 neighbouring threads read one channel's 32 bytes
    b_kw[l] = idx & 7;
  }

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  const int* x32 = reinterpret_cast<const int*>(xq);
  const int* k32 = reinterpret_cast<const int*>(kp);  // [cout, taps * cw] words
  const int taps = nq * max_l * 4;
  for (int g = 0; g < max_l; ++g) {
    const int off = plan.off[ph][g];
    for (int t = 0; t < 4; ++t) {
      const int tap = (ph * max_l + g) * 4 + t;
      for (int w0 = 0; w0 < cw; w0 += KW) {
#pragma unroll
        for (int l = 0; l < 2; ++l) {
          const int si = p_num * a_r[l] + off, sj = a_j[l] + t - 1, wd = w0 + a_kw[l];
          int v = 0;
          if (a_b[l] >= 0 && si >= 0 && si < h && sj >= 0 && sj < w && wd < cw)
            v = x32[((size_t)(a_b[l] * h + si) * w + sj) * cw + wd];
          As[a_kw[l]][a_m[l]] = v;

          // channels 4 wb .. 4 wb + 3 of tap `tap`, output n: one word
          const int n = n0 + b_n[l], wb = w0 + b_kw[l];
          Bs[b_kw[l]][b_n[l]] =
              (n < cout && wb < cw) ? k32[((size_t)n * taps + tap) * cw + wb] : 0;
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

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= m_total) continue;
    const int b = m / rw, r = (m / w) % n_phase, j = m % w;
    const float sxb = sx[b];
    const size_t base = ((size_t)(b * n_rows + r * nq + ph) * w + j) * cout;
#pragma unroll
    for (int jn = 0; jn < TN; ++jn) {
      const int n = n0 + tx * TN + jn;
      if (n >= cout) continue;
      float v = __fmul_rn(__fmul_rn((float)acc[i][jn], sk[ph * cout + n]), sxb);
      store_out(out, base + n, __fadd_rn(v, bias[n]));
    }
  }
}

}  // namespace

// xq: [nb, h, w, cin] int8 (cin % 4 == 0); sx: [nb] f32; kp: [cout, nq * max_l
// * 4 * cin] int8, the phase kernels [nq, max_l * 4, cin, cout] packed
// K-major; sk: [nq, cout] f32; bias: [cout] f32; out: [nb, n_rows, w, cout]
// bf16 (out_is_bf16 = 1) or f32; offsets: host array [nq][max_l] of source row
// offsets, n_groups: host array [nq] of each phase's real group count (nq <=
// 8, max_l <= 4); xq and kp 16-byte aligned, sk and bias 8-byte. Runs the
// tensor-core body where conv_mma_fits(cin, cout), the __dp4a body otherwise,
// and sets *on_mma to 1 or 0 by which one it launched. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a shape
// or table it does not take (the tensor-core body needs each phase's first
// n_groups offsets consecutive).
extern "C" int zdc_row_resize_conv4_int8(const void* xq, const void* sx, const void* kp,
                                         const void* sk, const void* bias, void* out,
                                         int out_is_bf16, int nb, int h, int w, int cin,
                                         int cout, int nq, int p_num, int max_l, int n_rows,
                                         const void* offsets, const void* n_groups, int* on_mma,
                                         void* stream) {
  *on_mma = 0;
  if (nb <= 0 || n_rows <= 0) return (int)cudaSuccess;
  if (cin % 4 != 0 || h <= 0 || w <= 0 || cout <= 0 || nq <= 0 || nq > kMaxPhases ||
      max_l <= 0 || max_l > kMaxGroups || p_num <= 0)
    return (int)cudaErrorInvalidValue;
  const int* offs = (const int*)offsets;
  const int8_t* x = (const int8_t*)xq;
  const int8_t* k = (const int8_t*)kp;
  const float *s = (const float*)sx, *skf = (const float*)sk, *b = (const float*)bias;
  cudaStream_t st = (cudaStream_t)stream;
  if (conv_mma_fits(cin, cout)) {
    ConvPlan cp{};
    const int* ng = (const int*)n_groups;
    for (int p = 0; p < nq; ++p) {
      const int kr = ng[p], d0 = offs[p * max_l];
      if (kr <= 0 || kr > max_l) return (int)cudaErrorInvalidValue;
      for (int g = 1; g < kr; ++g)
        if (offs[p * max_l + g] != d0 + g) return (int)cudaErrorInvalidValue;
      // output row r * nq + p reads source rows p_num * r + d0 + a, a < kr,
      // and columns j - 1 .. j + 2
      cp.ph[p] = ConvPhase{(n_rows - p + nq - 1) / nq, w, p_num, kr, 4, d0, -1,
                           p * max_l * 4, nq, p, 1, 0, p * cout};
    }
    cp.h = h; cp.w = w; cp.oh = n_rows; cp.ow = w;
    cp.taps = nq * max_l * 4;
    *on_mma = 1;
    if (out_is_bf16)
      return launch_conv(x, s, k, skf, b, (__nv_bfloat16*)out, nb, cin, cout, cp, nq, st);
    return launch_conv(x, s, k, skf, b, (float*)out, nb, cin, cout, cp, nq, st);
  }
  RowPlan plan = {};
  for (int p = 0; p < nq; ++p)
    for (int g = 0; g < max_l; ++g) plan.off[p][g] = offs[p * max_l + g];
  const int max_phase_rows = (n_rows + nq - 1) / nq;
  dim3 grid((nb * max_phase_rows * w + BM - 1) / BM, (cout + BN - 1) / BN, nq);
  if (out_is_bf16)
    row_resize_conv4_int8_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        x, s, k, skf, b, (__nv_bfloat16*)out, nb, h, w, cin, cout, nq, p_num, max_l, n_rows,
        plan);
  else
    row_resize_conv4_int8_kernel<float><<<grid, kThreads, 0, st>>>(
        x, s, k, skf, b, (float*)out, nb, h, w, cin, cout, nq, p_num, max_l, n_rows, plan);
  return (int)cudaGetLastError();
}
