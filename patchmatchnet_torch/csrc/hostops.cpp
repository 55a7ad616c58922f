// Host library of patchmatchnet_torch: the image path's bilinear resize
// (half-pixel centres, no antialiasing: f64 source coordinates, f32 lerps),
// its threaded batch form, the u8 -> f32 conversion of 8-bit levels and a
// vertical flip, with the C interface and arithmetic of the JAX package's
// host library, so the two packages' images agree to the bit.
//
// Plain C interface, built by g++ at first use and loaded with ctypes
// (patchmatchnet_torch/native.py, which keeps a numpy twin of each function).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Bilinear resize, half-pixel centers, zero antialiasing.
// src: [h, w, c] float32 row-major; dst: [oh, ow, c].
void resize_bilinear_f32(const float* src, int64_t h, int64_t w, int64_t c,
                         float* dst, int64_t oh, int64_t ow) {
  const double scale_y = static_cast<double>(h) / oh;
  const double scale_x = static_cast<double>(w) / ow;

  std::vector<int64_t> x0(ow), x1(ow);
  std::vector<float> wx(ow);
  for (int64_t j = 0; j < ow; ++j) {
    double sx = (j + 0.5) * scale_x - 0.5;
    sx = std::min(std::max(sx, 0.0), static_cast<double>(w - 1));
    int64_t xf = static_cast<int64_t>(sx);
    x0[j] = xf;
    x1[j] = std::min(xf + 1, w - 1);
    wx[j] = static_cast<float>(sx - xf);
  }

  for (int64_t i = 0; i < oh; ++i) {
    double sy = (i + 0.5) * scale_y - 0.5;
    sy = std::min(std::max(sy, 0.0), static_cast<double>(h - 1));
    int64_t y0 = static_cast<int64_t>(sy);
    int64_t y1 = std::min(y0 + 1, h - 1);
    float wy = static_cast<float>(sy - y0);

    const float* row0 = src + y0 * w * c;
    const float* row1 = src + y1 * w * c;
    float* out = dst + i * ow * c;

    for (int64_t j = 0; j < ow; ++j) {
      const float* p00 = row0 + x0[j] * c;
      const float* p01 = row0 + x1[j] * c;
      const float* p10 = row1 + x0[j] * c;
      const float* p11 = row1 + x1[j] * c;
      const float fx = wx[j];
      for (int64_t k = 0; k < c; ++k) {
        float top = p00[k] + (p01[k] - p00[k]) * fx;
        float bot = p10[k] + (p11[k] - p10[k]) * fx;
        out[j * c + k] = top + (bot - top) * wy;
      }
    }
  }
}

// Multithreaded batch resize: n images of identical geometry.
void resize_bilinear_batch_f32(const float* src, int64_t n, int64_t h,
                               int64_t w, int64_t c, float* dst, int64_t oh,
                               int64_t ow, int num_threads) {
  if (num_threads <= 1 || n <= 1) {
    for (int64_t i = 0; i < n; ++i) {
      resize_bilinear_f32(src + i * h * w * c, h, w, c, dst + i * oh * ow * c,
                          oh, ow);
    }
    return;
  }
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      resize_bilinear_f32(src + i * h * w * c, h, w, c, dst + i * oh * ow * c,
                          oh, ow);
    }
  };
  int nt = std::min<int64_t>(num_threads, n);
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

// uint8 HWC image -> float32 in [0, 1] (the PIL->float conversion hot loop).
void u8_to_f32_scale(const uint8_t* src, int64_t count, float* dst) {
  constexpr float kInv = 1.0f / 255.0f;
  for (int64_t i = 0; i < count; ++i) dst[i] = src[i] * kInv;
}

// Vertical flip of an [h, w*c] float32 buffer (PFM row order).
void flip_vertical_f32(const float* src, int64_t h, int64_t row_elems,
                       float* dst) {
  for (int64_t i = 0; i < h; ++i) {
    std::memcpy(dst + i * row_elems, src + (h - 1 - i) * row_elems,
                sizeof(float) * row_elems);
  }
}

int hostops_version() { return 1; }

}  // extern "C"
