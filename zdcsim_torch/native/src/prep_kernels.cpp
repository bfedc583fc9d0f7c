// zdcsim_torch host library: the data-preparation and host-batching loops.
//
// The port's own copy of the JAX package's host library, with the same
// functions and the same arithmetic: per-event photon sums (double
// accumulation), argmax coordinates (the first maximum in row-major order),
// in-place log1p, the per-group pixel standard deviation of the SDI-GAN
// diversity target (Welford in double per pixel lane, threaded over groups)
// and a threaded row gather. A C ABI, loaded through ctypes
// (zdcsim_torch/native/__init__.py), built with the host's g++ at first use
// (zdcsim_torch/native/build.py). Host code, off the card's path; numpy
// versions stand in where no compiler is found.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

namespace {

// Minimal fork-join parallel-for over [0, n) with T workers.
void parallel_for(int64_t n, const std::function<void(int64_t, int64_t)>& body) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t n_threads = std::max<int64_t>(1, std::min<int64_t>(hw ? hw : 1, n));
  if (n_threads == 1) {
    body(0, n);
    return;
  }
  std::vector<std::thread> workers;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    workers.emplace_back([&body, lo, hi] { body(lo, hi); });
  }
  for (auto& w : workers) w.join();
}

}  // namespace

extern "C" {

// Per-event photon sums: images [n, pixels] row-major -> sums [n].
void zdc_photon_sums(const float* images, int64_t n, int64_t pixels, float* out) {
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const float* row = images + i * pixels;
      double acc = 0.0;
      for (int64_t p = 0; p < pixels; ++p) acc += row[p];
      out[i] = static_cast<float>(acc);
    }
  });
}

// Argmax pixel coordinates: images [n, h*w] -> out [n, 2] of (row, col).
void zdc_max_coords(const float* images, int64_t n, int64_t h, int64_t w, float* out) {
  int64_t pixels = h * w;
  parallel_for(n, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const float* row = images + i * pixels;
      int64_t best = 0;
      float best_v = row[0];
      for (int64_t p = 1; p < pixels; ++p) {
        if (row[p] > best_v) {
          best_v = row[p];
          best = p;
        }
      }
      out[i * 2] = static_cast<float>(best / w);
      out[i * 2 + 1] = static_cast<float>(best % w);
    }
  });
}

// Log1p transform in place: images [n*pixels].
void zdc_log1p(float* images, int64_t count) {
  parallel_for(count, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) images[i] = std::log1p(images[i]);
  });
}

// SDI-GAN diversity target: per same-condition group, the per-pixel stddev
// across group members summed over pixels; each member gets the group value.
//
// Inputs: images [n, pixels]; order [n] = event indices sorted by group id;
// group_start [n_groups+1] = segment boundaries into `order`.
// Output: out [n] (unnormalized; caller max-normalizes). Population std
// matching numpy's default ddof=0 (the reference notebook uses np.std).
void zdc_group_pixel_std(const float* images, int64_t pixels,
                         const int64_t* order, const int64_t* group_start,
                         int64_t n_groups, float* out) {
  parallel_for(n_groups, [&](int64_t glo, int64_t ghi) {
    std::vector<double> mean(pixels), m2(pixels);
    for (int64_t g = glo; g < ghi; ++g) {
      int64_t s = group_start[g], e = group_start[g + 1];
      int64_t m = e - s;
      if (m <= 1) {
        for (int64_t j = s; j < e; ++j) out[order[j]] = 0.0f;
        continue;
      }
      std::fill(mean.begin(), mean.end(), 0.0);
      std::fill(m2.begin(), m2.end(), 0.0);
      // Welford over group members, vector-lane per pixel.
      for (int64_t j = s; j < e; ++j) {
        const float* row = images + order[j] * pixels;
        double k = static_cast<double>(j - s + 1);
        for (int64_t p = 0; p < pixels; ++p) {
          double delta = row[p] - mean[p];
          mean[p] += delta / k;
          m2[p] += delta * (row[p] - mean[p]);
        }
      }
      double total = 0.0;
      for (int64_t p = 0; p < pixels; ++p) total += std::sqrt(m2[p] / m);
      float v = static_cast<float>(total);
      for (int64_t j = s; j < e; ++j) out[order[j]] = v;
    }
  });
}

// Multithreaded batch gather: rows `idx` of src [n, row_floats] into
// dst [batch, row_floats] (a host-side batcher; the training loader
// gathers on the device, zdcsim_torch/data/loader.py).
void zdc_gather_rows(const float* src, int64_t row_floats, const int64_t* idx,
                     int64_t batch, float* dst) {
  parallel_for(batch, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(dst + i * row_floats, src + idx[i] * row_floats,
                  sizeof(float) * row_floats);
    }
  });
}

int zdc_native_abi_version() { return 1; }

}  // extern "C"
