// Host-side radar clip decode and resize for the PyTorch port
// (adnm_tpu_torch/data/native.py binds it; the same source as the JAX
// package's native/radar_io.cpp, kept here so the port builds its own).
//
// The reference's per-item pipeline (datasets/Shanghai.py:52-59: uint8 h5
// read -> /255 -> torchvision Resize) as multithreaded C++: uint8 -> f32
// and an antialiased bilinear resize of (T, H, W) clips, one frame per
// thread.
//
// Resize semantics: separable triangle (bilinear) filter with the
// support widened by the downscale factor (antialias=True), matching
// torchvision/PIL and F.interpolate(..., antialias=True):
//   center_i = (i + 0.5) * in/out - 0.5
//   w(j) = max(0, 1 - |j - center_i| * min(1, out/in)), normalized.
//
// Build (data/native.py does it at first use):
//   g++ -O3 -shared -fPIC -o libradar_io.so radar_io.cpp -lpthread

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Weights {
  std::vector<int> start;       // first source index per output index
  std::vector<int> count;       // taps per output index
  std::vector<float> w;         // flattened taps [out * max_taps]
  int max_taps = 0;
};

Weights make_weights(int in_size, int out_size) {
  Weights ws;
  const double scale = static_cast<double>(in_size) / out_size;  // >1 when downscaling
  const double support = std::max(1.0, scale);                   // triangle radius
  const double inv = 1.0 / std::max(1.0, scale);
  ws.max_taps = static_cast<int>(std::ceil(support)) * 2 + 2;
  ws.start.resize(out_size);
  ws.count.resize(out_size);
  ws.w.assign(static_cast<size_t>(out_size) * ws.max_taps, 0.0f);
  for (int i = 0; i < out_size; ++i) {
    const double center = (i + 0.5) * scale - 0.5;
    int lo = static_cast<int>(std::floor(center - support)) + 1;
    int hi = static_cast<int>(std::ceil(center + support));
    lo = std::max(lo, 0);
    hi = std::min(hi, in_size - 1);
    double total = 0.0;
    int n = 0;
    for (int j = lo; j <= hi && n < ws.max_taps; ++j, ++n) {
      const double d = std::abs(j - center) * inv;
      const double t = std::max(0.0, 1.0 - d);
      ws.w[static_cast<size_t>(i) * ws.max_taps + n] = static_cast<float>(t);
      total += t;
    }
    ws.start[i] = lo;
    ws.count[i] = n;
    if (total > 0.0) {
      for (int k = 0; k < n; ++k)
        ws.w[static_cast<size_t>(i) * ws.max_taps + k] /= static_cast<float>(total);
    }
  }
  return ws;
}

void resize_frame(const uint8_t* src, int h, int w, const Weights& wh,
                  const Weights& ww, int oh, int ow, float* tmp, float* dst,
                  float scale255) {
  // pass 1: horizontal (w -> ow), rows stay h
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * w;
    float* trow = tmp + static_cast<size_t>(y) * ow;
    for (int x = 0; x < ow; ++x) {
      const float* taps = &ww.w[static_cast<size_t>(x) * ww.max_taps];
      const int s = ww.start[x];
      float acc = 0.0f;
      for (int k = 0; k < ww.count[x]; ++k) acc += taps[k] * row[s + k];
      trow[x] = acc;
    }
  }
  // pass 2: vertical (h -> oh)
  for (int y = 0; y < oh; ++y) {
    const float* taps = &wh.w[static_cast<size_t>(y) * wh.max_taps];
    const int s = wh.start[y];
    float* drow = dst + static_cast<size_t>(y) * ow;
    for (int x = 0; x < ow; ++x) {
      float acc = 0.0f;
      for (int k = 0; k < wh.count[y]; ++k)
        acc += taps[k] * tmp[static_cast<size_t>(s + k) * ow + x];
      drow[x] = acc * scale255;
    }
  }
}

}  // namespace

extern "C" {

// src: (T, H, W) uint8; dst: (T, S, S) float32 in [0, 1].
void decode_resize_clip(const uint8_t* src, int t, int h, int w, float* dst,
                        int s, int n_threads) {
  const Weights wh = make_weights(h, s);
  const Weights ww = make_weights(w, s);
  const int threads = std::max(1, std::min(n_threads, t));
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int ti = 0; ti < threads; ++ti) {
    pool.emplace_back([&, ti]() {
      std::vector<float> tmp(static_cast<size_t>(h) * s);
      for (int f = ti; f < t; f += threads) {
        resize_frame(src + static_cast<size_t>(f) * h * w, h, w, wh, ww, s, s,
                     tmp.data(), dst + static_cast<size_t>(f) * s * s,
                     1.0f / 255.0f);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
