// Fused expm1 -> 5-channel sums of log-space shower images, plain and routed.
//
// Replaces the Pallas TPU kernels `expm1_channel_sums`
// (zdcsim/ops/pallas_kernels.py:103, kernel E) and
// `routed_expm1_channel_sums` (zdcsim/ops/pallas_kernels.py:62, kernel F).
// For each shower b of x [B, H, W] (E) or of the routed row imgs[idx[b], b]
// of imgs [E, B, H, W] (F):
//   out[b, k] = sum over pixels (r, c) in channel k of expm1f(x[r, c])
// with the channel of a pixel taken from its position, never from a mask
// tensor (zdcsim/ops/channels.py:37-50):
//   (r + c) even -> channel 4 (the complementary checkerboard);
//   (r + c) odd  -> (r >= H / 2 ? 0 : 2) + (c < W / 2 ? 0 : 1).
// The TPU kernel's exp(x) - 1 was a workaround for Mosaic, which has no
// expm1; this kernel takes expm1f, as its plain version does.
//
// Bound on the H100: bytes. Two operations per pixel against 4 bytes read
// (f32). At the gate's [5120, 56, 30] the kernel must read 34.4 MB: about
// 10.3 us at 3.35 TB/s; F reads only the routed rows, so it has E's bound
// at the same B.
//
// Design: one warp per shower, 8 showers to a block of 256 threads. Lane l
// owns pixels 4l + 128j .. 4l + 128j + 3 and keeps 5 register sums (a pixel
// adds 0 to the sums of the other 4 channels, which changes no bit); the
// warp then reduces each sum with a fixed __shfl_xor_sync tree. No atomics
// and no shared memory: the result does not vary from run to run. Where
// H*W % 4 == 0 and the row is 16-byte aligned (56x30 and 44x44 both
// qualify) a lane reads its 4 pixels with one 16-byte load (8 bytes for
// bf16), else with 4 scalar loads; the order of the additions is the same
// either way, so F on a routed row and E on the same row give the same bits.
// An expert id outside [0, E) reads nothing and writes NaN sums. A first,
// simple kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kChannels = 5;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void add_pixel(float acc[kChannels], float x, int i, int h, int w) {
  const int r = i / w;
  const int c = i - r * w;
  const int ch = ((r + c) & 1) ? (r >= h / 2 ? 0 : 2) + (c < w / 2 ? 0 : 1) : 4;
  const float v = expm1f(x);
#pragma unroll
  for (int k = 0; k < kChannels; ++k) acc[k] += (ch == k) ? v : 0.0f;
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* hp = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(hp[0]);
  const float2 b = __bfloat1622float2(hp[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// One warp: the 5 channel sums of one image row `x` of h*w pixels into out[0..4].
template <typename T>
__device__ void warp_channel_sums(const T* x, int h, int w, float* out) {
  const int lane = threadIdx.x & 31;
  const int hw = h * w;
  float acc[kChannels] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  const bool vec = (hw % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % (4 * sizeof(T)) == 0);
  for (int base = 4 * lane; base < hw; base += 128) {
    if (vec) {
      float v[4];
      load4(x + base, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) add_pixel(acc, v[j], base + j, h, w);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (base + j < hw) add_pixel(acc, to_f32(x[base + j]), base + j, h, w);
    }
  }
#pragma unroll
  for (int k = 0; k < kChannels; ++k) {
    float s = acc[k];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    acc[k] = s;
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kChannels; ++k) out[k] = acc[k];
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
expm1_channel_sums_kernel(const T* __restrict__ x, float* __restrict__ out, int b, int h, int w) {
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= b) return;  // whole warps leave together
  warp_channel_sums(x + (size_t)s * h * w, h, w, out + (size_t)s * kChannels);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
routed_expm1_channel_sums_kernel(const T* __restrict__ imgs, const int64_t* __restrict__ idx,
                                 float* __restrict__ out, int e, int b, int h, int w) {
  const int s = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= b) return;
  const int64_t ex = idx[s];
  float* o = out + (size_t)s * kChannels;
  if (ex < 0 || ex >= e) {
    if ((threadIdx.x & 31) < kChannels) o[threadIdx.x & 31] = __int_as_float(0x7fc00000);
    return;
  }
  warp_channel_sums(imgs + ((size_t)ex * b + s) * h * w, h, w, o);
}

}  // namespace

// x: [b, h, w] f32 (x_is_bf16 = 0) or bf16; out: [b, 5] f32. Returns
// cudaGetLastError() after the launch.
extern "C" int zdc_expm1_channel_sums(const void* x, int x_is_bf16, void* out, int b, int h,
                                      int w, void* stream) {
  if (b <= 0) return (int)cudaSuccess;
  if (h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (b + kWarps - 1) / kWarps;
  if (x_is_bf16) {
    expm1_channel_sums_kernel<__nv_bfloat16><<<blocks, kWarps * 32, 0, st>>>(
        (const __nv_bfloat16*)x, (float*)out, b, h, w);
  } else {
    expm1_channel_sums_kernel<float><<<blocks, kWarps * 32, 0, st>>>(
        (const float*)x, (float*)out, b, h, w);
  }
  return (int)cudaGetLastError();
}

// imgs: [e, b, h, w] f32 (x_is_bf16 = 0) or bf16; idx: [b] int64 expert
// ids; out: [b, 5] f32 (NaN where idx is outside [0, e)). Returns
// cudaGetLastError() after the launch.
extern "C" int zdc_routed_expm1_channel_sums(const void* imgs, int x_is_bf16, const void* idx,
                                             void* out, int e, int b, int h, int w,
                                             void* stream) {
  if (b <= 0) return (int)cudaSuccess;
  if (e <= 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (b + kWarps - 1) / kWarps;
  if (x_is_bf16) {
    routed_expm1_channel_sums_kernel<__nv_bfloat16><<<blocks, kWarps * 32, 0, st>>>(
        (const __nv_bfloat16*)imgs, (const int64_t*)idx, (float*)out, e, b, h, w);
  } else {
    routed_expm1_channel_sums_kernel<float><<<blocks, kWarps * 32, 0, st>>>(
        (const float*)imgs, (const int64_t*)idx, (float*)out, e, b, h, w);
  }
  return (int)cudaGetLastError();
}
