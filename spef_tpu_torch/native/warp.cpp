// Host yaw-rotation warp of the spef_tpu_torch data pipeline: OpenCV 5.0's
// warpPerspective (INTER_LINEAR, BORDER_CONSTANT 0) on x86, rewritten in
// plain C++ so that the loader gives its bytes without OpenCV.
//
// The arithmetic is spef_tpu_torch/data/augment_host.py::warp_perspective_plain,
// operation for operation, in float32 with explicit fused multiply-adds
// (std::fma rounds once; build with -ffp-contract=off so that the compiler
// fuses nothing else):
//   * inverse map (the caller passes M^-1 in float32): for the columns below
//     the last multiple of 16, X = fma(x, M0, y*M1 + M2), the same for Y and
//     W, then X * (1 / W); for the remaining columns (OpenCV's scalar tail)
//     X = fma(x, M0, y*M1) + M2, then X / W;
//   * taps at floor(X), floor(Y); each tap outside the image is 0;
//   * v0 = fma(a, p01 - p00, p00), v1 = fma(a, p11 - p10, p10),
//     v = fma(b, v1 - v0, v0), then round half to even and a clip to
//     [0, 255].
//
// Build: spef_tpu_torch/native/__init__.py::build_warp (g++ -O3 -shared
// -fPIC -ffp-contract=off; no library).

#include <cmath>
#include <cstdint>

namespace {

constexpr int kVectorColumns = 16;

// floor(v) clipped to [-2, hi] (a NaN to -2), as an int.
inline int clipped(float v, int hi) {
  if (!(v >= -2.0f)) return -2;
  return v > float(hi) ? hi : int(v);
}

inline float tap(const uint8_t* src, int h, int w, int c, int yy, int xx, int ch) {
  if (xx < 0 || xx >= w || yy < 0 || yy >= h) return 0.0f;
  return float(src[(size_t(yy) * w + xx) * c + ch]);
}

}  // namespace

extern "C" {

// src: h*w*c uint8 (HWC); dst: oh*ow*c uint8; minv: the 3x3 inverse map,
// row-major float32.
void spef_warp_perspective(const uint8_t* src, int h, int w, int c, uint8_t* dst, int oh,
                           int ow, const float* minv) {
  const int split = (ow / kVectorColumns) * kVectorColumns;
  for (int y = 0; y < oh; ++y) {
    const float fy = float(y);
    float row[3], row_tail[3];
    for (int r = 0; r < 3; ++r) {
      const float ym = fy * minv[3 * r + 1];
      row[r] = ym + minv[3 * r + 2];
      row_tail[r] = ym;
    }
    for (int x = 0; x < ow; ++x) {
      const float fx = float(x);
      float sx, sy;
      if (x < split) {
        const float inv_w = 1.0f / std::fma(fx, minv[6], row[2]);
        sx = std::fma(fx, minv[0], row[0]) * inv_w;
        sy = std::fma(fx, minv[3], row[1]) * inv_w;
      } else {
        const float ww = std::fma(fx, minv[6], row_tail[2]) + minv[8];
        sx = (std::fma(fx, minv[0], row_tail[0]) + minv[2]) / ww;
        sy = (std::fma(fx, minv[3], row_tail[1]) + minv[5]) / ww;
      }
      const float flx = std::floor(sx), fly = std::floor(sy);
      const float a = sx - flx, b = sy - fly;
      // Far outside the image every tap is 0: clip before the conversion.
      const int ix = clipped(flx, w + 1);
      const int iy = clipped(fly, h + 1);
      uint8_t* out = dst + (size_t(y) * ow + x) * c;
      const bool inside = ix >= 0 && iy >= 0 && ix + 1 < w && iy + 1 < h;
      const uint8_t* p = src + (size_t(iy) * w + ix) * c;
      const size_t down = size_t(w) * c;
      for (int ch = 0; ch < c; ++ch) {
        float p00, p01, p10, p11;
        if (inside) {
          p00 = p[ch];
          p01 = p[c + ch];
          p10 = p[down + ch];
          p11 = p[down + c + ch];
        } else {
          p00 = tap(src, h, w, c, iy, ix, ch);
          p01 = tap(src, h, w, c, iy, ix + 1, ch);
          p10 = tap(src, h, w, c, iy + 1, ix, ch);
          p11 = tap(src, h, w, c, iy + 1, ix + 1, ch);
        }
        const float v0 = std::fma(a, p01 - p00, p00);
        const float v1 = std::fma(a, p11 - p10, p10);
        const float v = std::nearbyint(std::fma(b, v1 - v0, v0));
        out[ch] = uint8_t(v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v));
      }
    }
  }
}

}  // extern "C"
