// Native frame preprocessing for the dataset pipeline (a copy of the JAX
// package's native/frameops.cpp).
//
// NeRF-SLAM keeps its hot host-side paths in C++/CUDA (its sRGB
// conversion is called out as "extremely slow" in Python,
// fusion/nerf_fusion.py:210-215).  The device handles tensor math, but
// per-frame image ingestion (decode -> resize -> normalize) runs on the
// CPU at camera rate; this library provides those ops with OpenMP so the
// data module never stalls the tracking loop.
//
// Build: g++ -O3 -fopenmp -shared -fPIC frameops.cpp -o libframeops.so
//        (nerf_slam_tpu_torch/native/__init__.py does it at first use)

#include <cstdint>
#include <cmath>
#include <algorithm>

extern "C" {

// Bilinear resize, uint8 HWC -> uint8 hwc.
void resize_bilinear_u8(const uint8_t* src, int H, int W, int C,
                        uint8_t* dst, int h, int w) {
  const float sy = (float)H / h;
  const float sx = (float)W / w;
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; y++) {
    const float fy = (y + 0.5f) * sy - 0.5f;
    const int y0 = std::max(0, std::min(H - 1, (int)std::floor(fy)));
    const int y1 = std::min(H - 1, y0 + 1);
    const float wy = fy - std::floor(fy);
    for (int x = 0; x < w; x++) {
      const float fx = (x + 0.5f) * sx - 0.5f;
      const int x0 = std::max(0, std::min(W - 1, (int)std::floor(fx)));
      const int x1 = std::min(W - 1, x0 + 1);
      const float wx = fx - std::floor(fx);
      for (int c = 0; c < C; c++) {
        const float v00 = src[(y0 * W + x0) * C + c];
        const float v01 = src[(y0 * W + x1) * C + c];
        const float v10 = src[(y1 * W + x0) * C + c];
        const float v11 = src[(y1 * W + x1) * C + c];
        const float v = (1 - wy) * ((1 - wx) * v00 + wx * v01)
                        + wy * ((1 - wx) * v10 + wx * v11);
        dst[(y * w + x) * C + c] = (uint8_t)(v + 0.5f);
      }
    }
  }
}

// uint8 HWC -> float32 HWC normalized: (x/255 - mean[c]) / std[c].
void normalize_image_u8(const uint8_t* src, int N, int C,
                        const float* mean, const float* stdv,
                        float* dst) {
#pragma omp parallel for schedule(static)
  for (int i = 0; i < N; i++) {
    for (int c = 0; c < C; c++) {
      dst[i * C + c] = (src[i * C + c] / 255.0f - mean[c]) / stdv[c];
    }
  }
}

// sRGB (u8) -> linear float via a 256-entry LUT per call.
void srgb_u8_to_linear_f32(const uint8_t* src, int64_t N, float* dst) {
  float lut[256];
  for (int i = 0; i < 256; i++) {
    const float x = i / 255.0f;
    lut[i] = (x <= 0.04045f) ? x / 12.92f
                             : std::pow((x + 0.055f) / 1.055f, 2.4f);
  }
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < N; i++) dst[i] = lut[src[i]];
}

// uint16 depth -> float metres with scale; zeros stay invalid (0).
void depth_u16_to_f32(const uint16_t* src, int64_t N, float scale,
                      float* dst) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < N; i++) {
    dst[i] = src[i] * scale;
  }
}

// Nearest-neighbor resize for depth (preserves invalid zeros).
void resize_nearest_f32(const float* src, int H, int W, float* dst,
                        int h, int w) {
  const float sy = (float)H / h;
  const float sx = (float)W / w;
#pragma omp parallel for schedule(static)
  for (int y = 0; y < h; y++) {
    const int yy = std::min(H - 1, (int)(y * sy));
    for (int x = 0; x < w; x++) {
      const int xx = std::min(W - 1, (int)(x * sx));
      dst[y * w + x] = src[yy * W + xx];
    }
  }
}

}  // extern "C"
