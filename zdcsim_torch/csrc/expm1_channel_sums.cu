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
// Bound on the H100. f32: bytes. A pixel is 4 bytes read against about 33
// instructions (in the SASS, about 31 floating-point ones with one MUFU:
// expm1f's range reduction, polynomial and special cases, and the add; a
// shared load): at 16384 showers of 56x30 the 110 MB take 33 us at 3.35
// TB/s and the 27.5 M pixels about 30 us of the 132 SMs' full issue rate,
// so f32 is bytes- and issue-bound at once, and the kernel must overlap its
// copies with its arithmetic. bf16: the bytes halve (16 us) and the instructions do not (one
// more to widen a pixel), so bf16 is issue-bound; the design spends nothing
// per pixel beyond the load, expm1f and one add, and its half-size ring
// holds twice the blocks an SM.
//
// Design (the bulk body, for a shower of a multiple of 16 bytes, at most
// 64 KB, on a 16-byte-aligned base: 56x30 and 44x44 in f32 and bf16):
// - Persistent grid of one wave: min(B, SMs x blocks per SM) blocks (the
//   entry point takes the blocks per SM from
//   cudaOccupancyMaxActiveBlocksPerMultiprocessor, once per card and
//   instantiation) stride over the showers, so no block waits for a second
//   wave.
// - A block is one producer warp and `warps` consumer warps over a ring of
//   2 x warps one-shower slots in dynamic shared memory. One thread of the
//   producer warp fills slot i % slots with a TMA 1-D bulk copy
//   (cp.async.bulk ... mbarrier::complete_tx::bytes, no tensor map) of a
//   whole shower and arms its `full` mbarrier with the bytes it expects;
//   consumer warp i % warps waits on that phase, reads the slot and releases
//   it on its `empty` mbarrier, which the producer waits on before refilling.
//   Each consumer warp owns 2 slots: one is read while the other is in
//   flight; the entry point takes as many consumer warps as fit, up to 8. A
//   warp a shower keeps the slots small, so an SM holds 16 warps (f32) and
//   their copies and arithmetic overlap; with 2 showers a warp (a half-warp
//   each) and 8 warps an SM the two ran nearly one after the other.
// - F's producer reads idx and copies the routed row imgs + (idx[s] B + s) HW;
//   an id outside [0, E) issues no copy, arms for no bytes, never forms an
//   address, and its sums are NaN. The producer's warp loads 32 showers' ids
//   at once into shared memory, so their latency hides behind the ring; E's
//   producer is its lane 0 alone.
// - The channel choice is out of the pixel loop. Lane l of a warp reads runs
//   of one row and one quadrant column: row halves (row (l >> 1) + 16k,
//   half l & 1), 15 pixels at 56x30 and 22 at 44x44; at 56x30 the last 8
//   rows' 16 row halves become 32 quarter rows (7 or 8 pixels), so each lane
//   reads 3.5 row halves and none idles. Per pixel: one shared load, expm1f
//   and an add into one of two sums that alternate statically with the
//   column's parity; per run, one add into its quadrant's sum and one into
//   channel 4's. No division, no select per pixel. At 56x30 f32 the lanes
//   read 32 distinct banks (15 and 32 are coprime).
// - Fixed-order sums, no atomics: a lane adds its runs in order, the
//   warp reduces with a fixed __shfl_xor_sync tree, so a rerun gives the
//   same bits, and E and F (one kernel, one body) give the same bits on the
//   same shower.
// Other shapes, and an unaligned view, take the direct body below: a warp
// a shower read from device memory, 16-byte loads where aligned, 5
// select-adds a pixel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kChannels = 5;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// ---------------------------------------------------------------------------
// The bulk body: a persistent TMA bulk-copy ring.
// ---------------------------------------------------------------------------

constexpr int kMaxBulkWarps = 8;     // consumer warps a block; one producer warp besides
constexpr int kSlotsPerWarp = 2;     // each consumer warp reads one slot while one loads
constexpr int kBarrierBytes = 1024;  // the slots' mbarriers and flags, 32 ids
constexpr int kMaxBulkSmem = 232448;  // 227 KB, the most one block may take
constexpr int kMaxBulkShower = 65536;  // the largest shower the bulk body takes, in bytes
constexpr int kMaxDevices = 64;

static_assert(2 * kMaxBulkWarps * kSlotsPerWarp * 8 + 32 * 8 + kMaxBulkWarps * kSlotsPerWarp * 4
                  <= kBarrierBytes, "barriers, ids and flags overflow their header");
static_assert(kBarrierBytes + kSlotsPerWarp * kMaxBulkShower <= kMaxBulkSmem,
              "a consumer warp's slots of the largest shower overflow a block");

inline long long bulk_smem(int warps, long long shower_bytes) {
  return kBarrierBytes + warps * kSlotsPerWarp * shower_bytes;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the phase of `bar` with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One TMA 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to this block's shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One run: the expm1f sums of pixels c .. c + m - 1 (m <= m_max) of row r,
// all in one quadrant column, into lo (lower rows) or up (upper rows) for
// its (r + c) odd pixels and into c4 for its even ones.
template <typename T>
__device__ __forceinline__ void add_run(const T* row, int c, int m, int m_max, bool lower,
                                        float& lo, float& up, float& c4, int r) {
  const T* p = row + c;
  float a = 0.0f, b = 0.0f;  // the pixels c, c + 2, ... and c + 1, c + 3, ...
#pragma unroll
  for (int j = 0; j < m_max; j += 2) {
    if (j < m) a += expm1f(to_f32(p[j]));
    if (j + 1 < m) b += expm1f(to_f32(p[j + 1]));
  }
  const bool a_even = ((r + c) & 1) == 0;  // (r + c) even: channel 4
  const float q = a_even ? b : a;
  c4 += a_even ? a : b;
  if (lower) lo += q; else up += q;
}

// Lane `lane`'s share of one shower `s` in shared memory, run by run: a run
// is a row half (row (lane >> 1) + 16k, half lane & 1); where H % 16 == 8
// (56 rows) the last 8 rows' 16 row halves are cut into 32 quarter rows,
// one a lane, so no lane idles there. kH, kW: the shape when known at
// compile time, else 0.
template <typename T, int kH, int kW>
__device__ __forceinline__ void row_half_sums(const T* s, int h_rt, int w_rt, int lane, float& lo,
                                              float& up, float& c4) {
  const int h = kH ? kH : h_rt;
  const int w = kW ? kW : w_rt;
  const int half = lane & 1;
  const int c0 = half ? w / 2 : 0;
  const int n = half ? w - w / 2 : w / 2;
  const int n_max = w - w / 2;
#pragma unroll
  for (int k = 0; k < h / 16; ++k) {
    const int r = (lane >> 1) + 16 * k;
    add_run(s + r * w, c0, n, n_max, r >= h / 2, lo, up, c4, r);
  }
  const int r0 = h / 16 * 16;
  if (h % 16 == 8) {
    const int r = r0 + (lane >> 2), sub = (lane >> 1) & 1;
    add_run(s + r * w, c0 + (sub ? n / 2 : 0), sub ? n - n / 2 : n / 2, n_max - n_max / 2,
            r >= h / 2, lo, up, c4, r);
  } else if (r0 + (lane >> 1) < h) {
    const int r = r0 + (lane >> 1);
    add_run(s + r * w, c0, n, n_max, r >= h / 2, lo, up, c4, r);
  }
}

// E (idx == nullptr: shower s is x + s HW) and F (the row imgs + (idx[s] B +
// s) HW, none for an id outside [0, e)). blockDim.x = 32 (warps + 1).
template <typename T, int kH, int kW>
__global__ void __launch_bounds__((kMaxBulkWarps + 1) * 32, 2)
expm1_sums_bulk_kernel(const T* __restrict__ x, const int64_t* __restrict__ idx,
                       float* __restrict__ out, int e, int b, int h, int w) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x / 32 - 1;
  const int n_slots = warps * kSlotsPerWarp;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + n_slots;
  int64_t* ids = reinterpret_cast<int64_t*>(empty + n_slots);  // F: the next 32 showers' ids
  int* copied = reinterpret_cast<int*>(ids + 32);              // the slot's shower was copied
  T* ring = reinterpret_cast<T*>(smem + kBarrierBytes);
  const int hw = (kH && kW) ? kH * kW : h * w;
  const unsigned shower_bytes = (unsigned)(hw * sizeof(T));

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int blk = blockIdx.x, grid = gridDim.x;
  const int n_iter = blk < b ? (b - blk + grid - 1) / grid : 0;  // block blk: showers blk + i grid
  if (threadIdx.x == 0) {
    for (int i = 0; i < n_slots; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == warps) {
    // The producer warp: for F its lanes load the block's next 32 showers'
    // ids at once; lane 0 fills the slots in order.
    for (int i0 = 0; i0 < n_iter; i0 += 32) {
      if (idx != nullptr) {
        ids[lane] = i0 + lane < n_iter ? idx[blk + (long long)(i0 + lane) * grid] : 0;
        __syncwarp();
      }
      if (lane == 0) {
        for (int i = i0; i < i0 + 32 && i < n_iter; ++i) {
          const int slot = i % n_slots;
          if (i >= n_slots) mbar_wait(&empty[slot], (unsigned)((i / n_slots - 1) & 1));
          const int64_t ex = idx != nullptr ? ids[i - i0] : 0;
          const int ok = ex >= 0 && ex < e;
          copied[slot] = ok;
          mbar_arrive_expect_tx(&full[slot], ok ? shower_bytes : 0u);
          if (ok)
            bulk_copy(ring + (size_t)slot * hw, x + (ex * b + blk + (long long)i * grid) * hw,
                      shower_bytes, &full[slot]);
        }
      }
      __syncwarp();
    }
    return;
  }

  // A consumer warp: iterations warp, warp + warps, ..., a shower each.
  for (int i = warp; i < n_iter; i += warps) {
    const int slot = i % n_slots;
    mbar_wait(&full[slot], (unsigned)((i / n_slots) & 1));
    const bool ok = copied[slot];
    float lo = 0.0f, up = 0.0f, c4 = 0.0f;
    if (ok) row_half_sums<T, kH, kW>(ring + (size_t)slot * hw, h, w, lane, lo, up, c4);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
    // even lanes hold the left quadrant column, odd lanes the right one
#pragma unroll
    for (int o = 16; o >= 2; o >>= 1) {
      lo += __shfl_xor_sync(kFull, lo, o);
      up += __shfl_xor_sync(kFull, up, o);
      c4 += __shfl_xor_sync(kFull, c4, o);
    }
    const float lo_r = __shfl_xor_sync(kFull, lo, 1);
    const float up_r = __shfl_xor_sync(kFull, up, 1);
    const float c4_r = __shfl_xor_sync(kFull, c4, 1);
    if (lane == 0) {
      const float nan = __int_as_float(0x7fc00000);
      float* o = out + (blk + (long long)i * grid) * kChannels;
      o[0] = ok ? lo : nan;
      o[1] = ok ? lo_r : nan;
      o[2] = ok ? up : nan;
      o[3] = ok ? up_r : nan;
      o[4] = ok ? c4 + c4_r : nan;
    }
  }
}

// The bulk body on `warps` consumer warps, one wave of blocks; *grid_out:
// the grid it launched. Above 48 KB a block's dynamic shared memory must be
// allowed per kernel and device, and a wave is SMs x blocks per SM: both are
// host-side CUDA calls, made once per card for the serving and neutron
// shapes (the generic instantiation's blocks per SM vary with the shape).
template <typename T, int kH, int kW>
int launch_bulk_shape(const void* x, const int64_t* idx, void* out, int e, int b, int h, int w,
                      int warps, cudaStream_t st, int* grid_out) {
  const auto kernel = expm1_sums_bulk_kernel<T, kH, kW>;
  static std::atomic<int> wave[kMaxDevices];  // 0 until known
  const int threads = (warps + 1) * 32;
  const int smem = (int)bulk_smem(warps, (long long)h * w * sizeof(T));
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  const bool cache = kH && kW && dev < kMaxDevices;
  int blocks = cache ? wave[dev].load(std::memory_order_acquire) : 0;
  if (blocks == 0) {
    int sms = 0, per_sm = 0;
    err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    kMaxBulkSmem);
    if (!err) err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (!err)
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err) return err;
    blocks = sms * per_sm;
    if (blocks < 1) return (int)cudaErrorInvalidConfiguration;
    if (cache) wave[dev].store(blocks, std::memory_order_release);
  }
  const int grid = b < blocks ? b : blocks;
  kernel<<<grid, threads, smem, st>>>((const T*)x, idx, (float*)out, e, b, h, w);
  err = (int)cudaGetLastError();
  if (!err) *grid_out = grid;
  return err;
}

// The bulk body with as many consumer warps (up to kMaxBulkWarps) as a
// block's shared memory holds two slots each for. It refuses a shower that
// is not a multiple of 16 bytes, is larger than kMaxBulkShower or starts off
// a 16-byte boundary. The serving and neutron shapes have their own
// instantiations (their loops unrolled whole), every other shape the
// generic one.
template <typename T>
int launch_bulk(const void* x, const int64_t* idx, void* out, int e, int b, int h, int w,
                cudaStream_t st, int* grid_out) {
  const long long shower_bytes = (long long)h * w * sizeof(T);
  if (shower_bytes % 16 != 0 || shower_bytes > kMaxBulkShower
      || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long fit = (kMaxBulkSmem - kBarrierBytes) / (kSlotsPerWarp * shower_bytes);
  const int warps = fit < kMaxBulkWarps ? (int)fit : kMaxBulkWarps;
  if (h == 56 && w == 30)
    return launch_bulk_shape<T, 56, 30>(x, idx, out, e, b, h, w, warps, st, grid_out);
  if (h == 44 && w == 44)
    return launch_bulk_shape<T, 44, 44>(x, idx, out, e, b, h, w, warps, st, grid_out);
  return launch_bulk_shape<T, 0, 0>(x, idx, out, e, b, h, w, warps, st, grid_out);
}

int launch_bulk_any(const void* x, int x_is_bf16, const int64_t* idx, void* out, int e, int b,
                    int h, int w, cudaStream_t st, int* grid_out) {
  return x_is_bf16 ? launch_bulk<__nv_bfloat16>(x, idx, out, e, b, h, w, st, grid_out)
                   : launch_bulk<float>(x, idx, out, e, b, h, w, st, grid_out);
}

// ---------------------------------------------------------------------------
// The direct body, for every other shape and an unaligned view: one warp per
// shower, 8 showers to a block of 256 threads. Lane l owns pixels
// 4l + 128j .. 4l + 128j + 3 and keeps 5 register sums (a pixel adds 0 to
// the sums of the other 4 channels, which changes no bit); the warp then
// reduces each sum with a fixed __shfl_xor_sync tree. Where H*W % 4 == 0 and
// the row is 16-byte aligned a lane reads its 4 pixels with one 16-byte load
// (8 bytes for bf16), else with 4 scalar loads; the order of the additions
// is the same either way. An expert id outside [0, E) reads nothing and
// writes NaN sums.
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;

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
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
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

// x: [b, h, w] f32 (x_is_bf16 = 0) or bf16; out: [b, 5] f32. bulk = 1 runs
// the bulk body (it refuses a shape or base pointer it cannot take:
// cudaErrorInvalidValue), bulk = 0 the direct body. Sets *grid to the bulk
// body's grid, 0 for the direct body. Returns cudaGetLastError() after the
// launch.
extern "C" int zdc_expm1_channel_sums(const void* x, int x_is_bf16, void* out, int b, int h,
                                      int w, int bulk, int* grid, void* stream) {
  *grid = 0;
  if (b <= 0) return (int)cudaSuccess;
  if (h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bulk) return launch_bulk_any(x, x_is_bf16, nullptr, out, 1, b, h, w, st, grid);
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
// ids; out: [b, 5] f32 (NaN where idx is outside [0, e)). bulk and *grid as
// for zdc_expm1_channel_sums. Returns cudaGetLastError() after the launch.
extern "C" int zdc_routed_expm1_channel_sums(const void* imgs, int x_is_bf16, const void* idx,
                                             void* out, int e, int b, int h, int w, int bulk,
                                             int* grid, void* stream) {
  *grid = 0;
  if (b <= 0) return (int)cudaSuccess;
  if (e <= 0 || h <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bulk) return launch_bulk_any(imgs, x_is_bf16, (const int64_t*)idx, out, e, b, h, w, st, grid);
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
