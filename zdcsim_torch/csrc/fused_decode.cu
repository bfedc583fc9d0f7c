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
//  - the four norm stages (launches 1, 3, 5, 7) run kernels A's and C's
//    bodies (norm_quant.cuh) on thread-block clusters: k blocks on
//    neighbouring SMs share a sample, each keeps its share in shared memory
//    where it fits (else streams it in each pass; Conv_3 takes a kept share
//    only) and the cluster exchanges
//    partial sums through distributed shared memory in a fixed order (no
//    atomics: a rerun is bit-identical). The wrapper passes each stage's
//    plan (k, threads, dynamic shared memory; fused_decode_kernels.stage_plan)
//    and this file refuses a plan whose shared memory is not the layout the
//    body takes at that k; each entry point reports the k and the body each
//    stage ran. Launch 1 is A's body at [nb, 92160]; launch 5 is C's body at
//    [nb, 55, 29, 128] f32; launch 3 is C's body whose quantise pass writes
//    through the nearest 35x19 -> 56x30 resize (writer ResizeGrid: each
//    source pixel of a block's share is quantised once and stored at the one
//    or two output rows and columns that read it, so every output pixel is
//    written once and the resize costs no pass and no arithmetic of its
//    own); launch 7 is C's statistics followed by Conv_3 (writer Conv3Out:
//    a warp normalises each input pixel once and forms its four tap sums
//    over the 64 channels, written over the pixel's kept values; then a
//    thread adds the tap sums of each output pixel anchored in the share.
//    The up to W + 1 pixels before the share, in the previous rank's, are
//    read from device memory, where they lie in L2 from that rank's copy: at
//    most 30 pixels of ~800, against a second cluster exchange through
//    distributed shared memory after the tap sums);
//  - the convs: conv_mma.cuh's implicit GEMM on the int8 tensor cores
//    (wgmma s8, exact int32 sums, f32 epilogue), one plan each: Conv_0's four
//    parity phases written through the (2i + pr, 2j + pc) map, Conv_1 and
//    Conv_2 as one pad-1 phase; the wrappers pack the weights once as
//    [Cout, taps x Cin]. Kernels B and D run the same core.
// The f32 samples of GroupNorm_0 (665 KB) and GroupNorm_1 (798 KB) keep a
// share in 227 KB only at k >= 4, whose 64 clusters at the serving tile take
// three waves of the 30 the card holds at once. Timed on the card at 64 and
// 256 rows, GroupNorm_1 runs fastest kept at k = 4, GroupNorm_0 streamed at
// k = 2 in one wave (fused_decode_kernels.stage_plan; PERF.md, section 6).
// Left for later: the f32 GroupNorm stages run at 35-40% of their byte
// floor. A block loads its share, reduces it and quantises it in turn, with
// no other block on its SM to overlap those phases, and a streamed share is
// read twice. The conv epilogue that produces each GroupNorm's input could
// write fixed-order per-tile partial sums and per-channel minima and maxima,
// leaving the GroupNorm one streaming pass; or a sample could stay on chip
// between a conv and its norm stage (the conv core's own open items are in
// conv_mma.cuh).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_mma.cuh"
#include "norm_quant.cuh"

namespace {

// Geometry of the full-width generator (pallas_decode_fused.py:88-91).
constexpr int H0 = 18, W0 = 10, C0 = 512;  // MLP grid
constexpr int H1 = 35, W1 = 19, C1 = 256;  // Conv_0 output
constexpr int HG = 56, WG = 30;            // resized and final grid
constexpr int HV = HG - 1, WV = WG - 1;    // Conv_1 and Conv_2 output, 55 x 29
constexpr int C2 = 128, C3 = 64;
constexpr int kGroups = 32;

// ---------------------------------------------------------------------------
// The launch sequences
// ---------------------------------------------------------------------------

// A plain k x k pad-1 conv from an h x w grid to the 55 x 29 grid.
ConvPlan pad1_plan(int k, int h, int w) {
  ConvPlan plan{};
  plan.ph[0] = ConvPhase{HV, WV, 1, k, k, -1, -1, 0, 1, 0, 1, 0, 0};
  plan.h = h; plan.w = w; plan.oh = HV; plan.ow = WV;
  plan.taps = k * k;
  return plan;
}

// The four norm stages, by launch number: 1 LN-quant, 3 GN_0-quant through
// the resize, 5 GN_1-quant, 7 GN_2 + Conv_3. A plan is {k, threads, dynamic
// shared memory}; ran receives {cluster size launched, share kept} of each.
constexpr int kPlanInts = 3, kRanInts = 2;

// The dynamic shared memory that stage's body takes at cluster size k, or -1
// for a stage or k it does not take.
int stage_smem(int stage, int k, int threads) {
  if (!portable_cluster(k)) return -1;
  int share = 0, kept = 0;
  switch (stage) {
    case 1: return ln_layout(H0 * W0 * C0, k, &share, &kept);
    case 3: return gn_layout(H1 * W1, C1, 4, k, threads, &share, &kept);
    case 5: return gn_layout(HV * WV, C2, 4, k, threads, &share, &kept);
    case 7: return gn_layout(HV * WV, C3, 4, k, threads, &share, &kept);
    default: return -1;
  }
}

// One norm stage on nb samples: x the stage's input (launch 1: [nb, 92160]
// bf16 or f32; 3: [nb, 35, 19, 256] f32; 5: [nb, 55, 29, 128]; 7:
// [nb, 55, 29, 64]), scale and bias its norm's parameters; out int8 q
// (launch 3: [nb, 56, 30, 256]; 1 and 5 the input's shape) with s [nb], or
// for launch 7 f32 [nb, 56, 30] from k3 [2, 2, 64] and b3 [1]. A plan whose
// shared memory is not the body's layout at its k is refused with
// cudaErrorInvalidValue, before anything launches.
int run_stage(int stage, const void* x, int x_is_bf16, const float* scale, const float* bias,
              void* out, float* s, const float* k3, const float* b3, int apply_expm1, int nb,
              const int* plan, int* ran, cudaStream_t st) {
  const int k = plan[0], threads = plan[1];
  if (plan[2] != stage_smem(stage, k, threads) || (stage != 1 && x_is_bf16))
    return (int)cudaErrorInvalidValue;
  switch (stage) {
    case 1:
      return ln_leaky_rowquant_run(x, x_is_bf16, scale, bias, out, s, nb, H0 * W0 * C0, k,
                                   threads, &ran[0], &ran[1], st);
    case 3:
      return gn_leaky_rowquant_run(x, 0, scale, bias, ResizeGrid<H1, W1, HG, WG>{(int8_t*)out, s},
                                   nb, H1 * W1, C1, kGroups, k, threads, &ran[0], &ran[1], st);
    case 5:
      return gn_leaky_rowquant_run(x, 0, scale, bias, SameGrid{(int8_t*)out, s}, nb, HV * WV, C2,
                                   kGroups, k, threads, &ran[0], &ran[1], st);
    default:
      return gn_leaky_rowquant_run(x, 0, scale, bias,
                                   Conv3Out<HV, WV>{k3, b3, (float*)out, apply_expm1}, nb,
                                   HV * WV, C3, kGroups, k, threads, &ran[0], &ran[1], st);
  }
}

struct Front {
  const void* x; int x_is_bf16;
  const float *ln_scale, *ln_bias;
  const int8_t* kp0; const float *sk0, *b0, *g0s, *g0b;
};

// Launches 1-3: q [nb, 56, 30, 256] int8 and s [nb]; ws_i8 holds xq
// [nb, 92160], ws_f32 the Conv_0 output [nb, 35, 19, 256], ws_sx [nb].
// plans and ran hold stages 1 and 3.
int run_front(const Front& f, int8_t* ws_i8, float* ws_f32, float* ws_sx, int8_t* q, float* s,
              int nb, const int* plans, int* ran, cudaStream_t st) {
  int err = run_stage(1, f.x, f.x_is_bf16, f.ln_scale, f.ln_bias, ws_i8, ws_sx, nullptr, nullptr,
                      0, nb, plans, ran, st);
  if (err) return err;
  err = launch_conv(ws_i8, ws_sx, f.kp0, f.sk0, f.b0, ws_f32, nb, C0, C1,
                    conv0_plan(H0, W0, C1), 4, st);
  if (err) return err;
  return run_stage(3, ws_f32, 0, f.g0s, f.g0b, q, s, nullptr, nullptr, 0, nb, plans + kPlanInts,
                   ran + kRanInts, st);
}

}  // namespace

// G. x: [nb, 92160] bf16 (x_is_bf16 = 1) or f32; ln_scale, ln_bias: [92160]
// f32; kp0: [256, 25 * 512] int8, the parity-phase taps [25, 512, 256] packed
// K-major (phase p's slab at tap0[p] * 512), and sk0: [4, 256] f32; b0, g0s,
// g0b: [256] f32. Workspaces: ws_i8 [nb * 92160] int8,
// ws_f32 [nb * 35 * 19 * 256] f32, ws_s [nb] f32. Writes q [nb, 56, 30, 256]
// int8 and s [nb] f32. plans: the plans of launches 1 and 3 ({k, threads,
// shared memory} each); ran: {cluster size, kept} of each, zero where it did
// not launch. Returns the first CUDA error of its 3 launches.
extern "C" int zdc_fused_decode_front(const void* x, int x_is_bf16, const void* ln_scale,
                                      const void* ln_bias, const void* kp0, const void* sk0,
                                      const void* b0, const void* g0s, const void* g0b,
                                      void* ws_i8, void* ws_f32, void* ws_s, void* q, void* s,
                                      int nb, const int* plans, int* ran, void* stream) {
  for (int i = 0; i < 2 * kRanInts; ++i) ran[i] = 0;
  if (nb <= 0) return (int)cudaSuccess;
  const Front f{x, x_is_bf16, (const float*)ln_scale, (const float*)ln_bias,
                (const int8_t*)kp0, (const float*)sk0, (const float*)b0, (const float*)g0s,
                (const float*)g0b};
  return run_front(f, (int8_t*)ws_i8, (float*)ws_f32, (float*)ws_s, (int8_t*)q, (float*)s, nb,
                   plans, ran, (cudaStream_t)stream);
}

// H. The front's arguments as for G, then kp1 [128, 16 * 256] int8 (Conv_1's
// [4, 4, 256, 128] packed K-major), sk1, b1, g1s, g1b [128] f32; kp2
// [64, 9 * 128] int8 (Conv_2's [3, 3, 128, 64]), sk2, b2, g2s, g2b [64] f32;
// k3 [2, 2, 64] f32, b3 [1] f32. Workspaces: ws_i8 [nb * 56 * 30 * 256]
// int8, ws_f32 [nb * 55 * 29 * 128] f32, ws_s [3 * nb] f32. Writes out
// [nb, 56, 30] f32 (expm1 of it when apply_expm1). plans: the plans of
// launches 1, 3, 5 and 7; ran: {cluster size, kept} of each. Returns the
// first CUDA error of its 7 launches.
extern "C" int zdc_fused_decode(const void* x, int x_is_bf16, const void* ln_scale,
                                const void* ln_bias, const void* kp0, const void* sk0,
                                const void* b0, const void* g0s, const void* g0b,
                                const void* kp1, const void* sk1, const void* b1,
                                const void* g1s, const void* g1b, const void* kp2,
                                const void* sk2, const void* b2, const void* g2s,
                                const void* g2b, const void* k3, const void* b3, void* ws_i8,
                                void* ws_f32, void* ws_s, void* out, int apply_expm1, int nb,
                                const int* plans, int* ran, void* stream) {
  for (int i = 0; i < 4 * kRanInts; ++i) ran[i] = 0;
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
  int err = run_front(f, wi, wf, s, wi, s + nb, nb, plans, ran, st);
  if (err) return err;
  err = launch_conv(wi, s + nb, (const int8_t*)kp1, (const float*)sk1, (const float*)b1, wf, nb,
                    C1, C2, pad1_plan(4, HG, WG), 1, st);
  if (err) return err;
  err = run_stage(5, wf, 0, (const float*)g1s, (const float*)g1b, wi, s + 2 * nb, nullptr,
                  nullptr, 0, nb, plans + 2 * kPlanInts, ran + 2 * kRanInts, st);
  if (err) return err;
  err = launch_conv(wi, s + 2 * nb, (const int8_t*)kp2, (const float*)sk2, (const float*)b2, wf,
                    nb, C2, C3, pad1_plan(3, HV, WV), 1, st);
  if (err) return err;
  return run_stage(7, wf, 0, (const float*)g2s, (const float*)g2b, out, nullptr,
                   (const float*)k3, (const float*)b3, apply_expm1, nb, plans + 3 * kPlanInts,
                   ran + 3 * kRanInts, st);
}

// One norm stage as G and H launch it, for tests and timing: stage 1, 3, 5
// or 7 (the launch number), with run_stage's arguments; plan {k, threads,
// shared memory}; ran {cluster size, kept}. Returns the launch's CUDA error
// (cudaErrorInvalidValue for another stage or a plan the body does not take).
extern "C" int zdc_fused_norm_stage(int stage, const void* x, int x_is_bf16, const void* scale,
                                    const void* bias, const void* k3, const void* b3, void* out,
                                    void* s, int apply_expm1, int nb, const int* plan, int* ran,
                                    void* stream) {
  ran[0] = ran[1] = 0;
  if (stage != 1 && stage != 3 && stage != 5 && stage != 7) return (int)cudaErrorInvalidValue;
  if (nb <= 0) return (int)cudaSuccess;
  return run_stage(stage, x, x_is_bf16, (const float*)scale, (const float*)bias, out, (float*)s,
                   (const float*)k3, (const float*)b3, apply_expm1, nb, plan, ran,
                   (cudaStream_t)stream);
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
    case 0: return launch_conv(x, s, w, k, b, o, nb, C0, C1, conv0_plan(H0, W0, C1), 4, st);
    case 1: return launch_conv(x, s, w, k, b, o, nb, C1, C2, pad1_plan(4, HG, WG), 1, st);
    case 2: return launch_conv(x, s, w, k, b, o, nb, C2, C3, pad1_plan(3, HV, WV), 1, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
