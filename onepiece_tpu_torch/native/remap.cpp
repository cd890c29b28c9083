// Bilinear resampling of an 8-bit RGB image at float32 source coordinates, as
// cv2.remap(src, map_x, map_y, INTER_LINEAR, BORDER_CONSTANT, 0) computes
// it in OpenCV 5 (host C++ of onepiece_tpu_torch, built by _native.py).
//
// OpenCV 5's remap interpolates in float32 with fused multiply-adds:
//   ix = floor(sx), a = sx - ix (likewise iy, b for sy);
//   f0 = fma(a, p01 - p00, p00), f1 = fma(a, p11 - p10, p10);
//   f = fma(b, f1 - f0, f0), rounded to nearest even and saturated to 0..255,
// where a tap outside the source image reads the border value 0.
// std::fma rounds once on every machine, with or without FMA hardware, so
// the result is the same on any host.

#include <cmath>
#include <cstdint>

extern "C" {

// src (sh, sw, 3) uint8; map_x, map_y (dh, dw) float32; out (dh, dw, 3).
int remap_linear_rgb(const uint8_t* src, int sh, int sw, const float* map_x, const float* map_y, int dh, int dw,
                     uint8_t* out) {
  constexpr int cn = 3;
  for (int64_t i = 0; i < static_cast<int64_t>(dh) * dw; i++) {
    float sx = map_x[i], sy = map_y[i];
    float fx = std::floor(sx), fy = std::floor(sy);
    float a = sx - fx, b = sy - fy;
    int64_t x0 = static_cast<int64_t>(fx), y0 = static_cast<int64_t>(fy);
    const uint8_t* taps[4];
    for (int k = 0; k < 4; k++) {
      int64_t x = x0 + (k & 1), y = y0 + (k >> 1);
      taps[k] = (x >= 0 && x < sw && y >= 0 && y < sh) ? src + (y * sw + x) * cn : nullptr;
    }
    uint8_t* o = out + i * cn;
    for (int c = 0; c < cn; c++) {
      float p00 = taps[0] ? taps[0][c] : 0.0f, p01 = taps[1] ? taps[1][c] : 0.0f;
      float p10 = taps[2] ? taps[2][c] : 0.0f, p11 = taps[3] ? taps[3][c] : 0.0f;
      float f0 = std::fma(a, p01 - p00, p00);
      float f1 = std::fma(a, p11 - p10, p10);
      float f = std::nearbyint(std::fma(b, f1 - f0, f0));
      o[c] = static_cast<uint8_t>(f < 0.0f ? 0.0f : f > 255.0f ? 255.0f : f);
    }
  }
  return 0;
}
}
