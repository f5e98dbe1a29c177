// Host-side image kernels of the port's data pipeline (CPU, C++17).
//
// The port's own copy of the JAX package's native/image_ops.cpp: the same
// C API (function names and signatures, pinned by
// tests/test_torch_port_native.py), built at first use by
// distributedpytorch_tpu_torch/ops/_build.py with the host C++ compiler and
// loaded through ctypes (distributedpytorch_tpu_torch/native_ops.py).  An
// edit under native/ does not change it.  Each function is held against the
// port's numpy form of the same op (imaging.py, utils/helpers.py,
// data/guidance.py), which follows OpenCV's conventions.  Two departures
// from native/image_ops.cpp make it follow those forms:
//
// * the interpolation taps take their source coordinate in double and round
//   it to float, as cv2's resize does (nearest: floor(i * (1 / (dst / src)))
//   in double), so nearest resizes pick the same pixels as cv2 and the numpy
//   form, and the weights are the numpy form's;
// * warp_affine_f32 follows OpenCV 5's float-coordinate warp (the source
//   coordinate of each output pixel rounded to float, cubic weights at the
//   exact fractional offset), not OpenCV 4's 1/32-pixel fixed point.
//
// Conventions: float32, row-major, HW or HWC with a channel stride of 1;
// coordinates are (x, y) with the cv2 pixel-center convention
// (dst pixel i samples src at (i + 0.5) * scale - 0.5).
// Bicubic uses the Catmull-Rom-style kernel with a = -0.75, cv2's choice.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

namespace {

inline float clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// cv2-compatible bicubic weight (a = -0.75).
inline float cubic_w(float x) {
  constexpr float a = -0.75f;
  x = std::fabs(x);
  if (x <= 1.0f) return ((a + 2.0f) * x - (a + 3.0f)) * x * x + 1.0f;
  if (x < 2.0f) return (((x - 5.0f) * x + 8.0f) * x - 4.0f) * a;
  return 0.0f;
}

// The same weight in double (the resize taps).
inline double cubic_wd(double x) {
  constexpr double a = -0.75;
  x = std::fabs(x);
  if (x <= 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

// The 4 cubic weights at fractional offset x in [0, 1), in float, in the
// order of operations of the numpy form (imaging._cubic_taps, after cv2's
// interpolateCubic).
inline void cubic_taps(float x, float w[4]) {
  constexpr float a = -0.75f;
  const float x1 = x + 1.0f, y = 1.0f - x;
  w[0] = ((a * x1 - 5.0f * a) * x1 + 8.0f * a) * x1 - 4.0f * a;
  w[1] = ((a + 2.0f) * x - (a + 3.0f)) * x * x + 1.0f;
  w[2] = ((a + 2.0f) * y - (a + 3.0f)) * y * y + 1.0f;
  w[3] = 1.0f - w[0] - w[1] - w[2];
}

// Precomputed 1-D interpolation taps for one output axis: for output
// coordinate i, `idx[i*n .. i*n+n-1]` are source indices (already clamped)
// and `w[...]` their weights.  Separable resize = a horizontal pass with the
// x-taps then a vertical pass with the y-taps — O(taps) work per output with
// tight branch-free inner loops, instead of re-deriving coordinates and
// clamping per (pixel, tap).
struct Taps1D {
  std::vector<int> idx;
  std::vector<float> w;
  int n = 0;  // taps per output coordinate (1, 2, or 4)
};

// `lo`/`hi`: inclusive source-index clamp range (the window in window
// coordinates for the fused crop path; [0, src_len-1] for plain resize).
Taps1D build_taps(int dst_len, int src_len, int mode, int lo, int hi) {
  Taps1D t;
  const double scale = static_cast<double>(src_len) / dst_len;
  t.n = (mode == 0) ? 1 : (mode == 1 ? 2 : 4);
  t.idx.resize(static_cast<size_t>(dst_len) * t.n);
  t.w.resize(static_cast<size_t>(dst_len) * t.n);
  for (int i = 0; i < dst_len; ++i) {
    if (mode == 0) {
      // cv2 INTER_NEAREST: floor(i * (1 / (dst / src))) in double, no
      // half-pixel shift.
      const double inv = 1.0 / (static_cast<double>(dst_len) / src_len);
      t.idx[i] = clampi(static_cast<int>(std::floor(i * inv)), lo, hi);
      t.w[i] = 1.0f;
      continue;
    }
    // the coordinate in double, rounded to float; weights from the float
    // coordinate in double, rounded to float
    const float f = static_cast<float>((i + 0.5) * scale - 0.5);
    const int base = static_cast<int>(std::floor(f));
    if (mode == 1) {
      const float a = static_cast<float>(static_cast<double>(f) - base);
      t.idx[i * 2] = clampi(base, lo, hi);
      t.idx[i * 2 + 1] = clampi(base + 1, lo, hi);
      t.w[i * 2] = 1.0f - a;
      t.w[i * 2 + 1] = a;
    } else {
      for (int k = 0; k < 4; ++k) {
        t.idx[i * 4 + k] = clampi(base - 1 + k, lo, hi);
        t.w[i * 4 + k] = static_cast<float>(
            cubic_wd(static_cast<double>(f) - (base - 1 + k)));
      }
    }
  }
  return t;
}

// Shared separable core: horizontal pass over the rows listed in
// `row_src` (an entry of -1 is a zero row — the fused crop's out-of-image
// padding), then vertical pass combining buffered rows.  `xt` indices are
// already absolute source-x offsets (or -1 for zero columns).  Only rows
// some vertical tap actually references are filtered and buffered — under
// heavy downscale (or nearest, 1 tap/row) most source rows are never read,
// so the buffer and the horizontal work stay O(referenced rows), not
// O(window rows).
void separable_resize(const float* src, int sw, int c,
                      const std::vector<int>& row_src,
                      const Taps1D& xt, Taps1D yt,
                      float* dst, int dh, int dw) {
  const int rows = static_cast<int>(row_src.size());
  // Compact the buffer to referenced rows; remap yt.idx into buffer slots.
  std::vector<int> slot(rows, -1);
  int used = 0;
  for (auto& r : yt.idx) {
    if (slot[r] < 0) slot[r] = used++;
    r = slot[r];
  }
  const size_t row_elems = static_cast<size_t>(dw) * c;
  std::vector<float> buf(static_cast<size_t>(used) * row_elems, 0.0f);
  for (int r = 0; r < rows; ++r) {
    if (slot[r] < 0) continue;  // no vertical tap reads this row
    const int sy = row_src[r];
    if (sy < 0) continue;  // zero padding row: buffer already zeroed
    const float* in = src + static_cast<int64_t>(sy) * sw * c;
    float* out = buf.data() + static_cast<size_t>(slot[r]) * row_elems;
    for (int x = 0; x < dw; ++x) {
      for (int t = 0; t < xt.n; ++t) {
        const int xi = xt.idx[x * xt.n + t];
        if (xi < 0) continue;  // zero padding column
        const float wgt = xt.w[x * xt.n + t];
        const float* px = in + static_cast<int64_t>(xi) * c;
        float* o = out + static_cast<int64_t>(x) * c;
        for (int k = 0; k < c; ++k) o[k] += wgt * px[k];
      }
    }
  }
  for (int y = 0; y < dh; ++y) {
    float* out = dst + static_cast<int64_t>(y) * dw * c;
    std::memset(out, 0, sizeof(float) * row_elems);
    for (int t = 0; t < yt.n; ++t) {
      const int r = yt.idx[y * yt.n + t];
      const float wgt = yt.w[y * yt.n + t];
      const float* in = buf.data() + static_cast<size_t>(r) * row_elems;
      for (size_t e = 0; e < row_elems; ++e) out[e] += wgt * in[e];
    }
  }
}

}  // namespace

// mode: 0 = nearest, 1 = bilinear, 2 = bicubic.  Separable two-pass with
// precomputed taps.  Tap weights/indices and clamp rule match the direct
// per-pixel formulation; accumulation order matches it bit-for-bit for
// nearest and bicubic (those already grouped sum-over-x then sum-over-y).
// Bilinear previously summed the four weight products in one expression
// (v00*(1-ax)*(1-ay) + ...); the two-pass lerp is a different FP
// association and can differ in the last ulp — the tolerance-based tests
// are the stated contract there.
void resize_f32(const float* src, int sh, int sw, int c,
                float* dst, int dh, int dw, int mode) {
  const Taps1D xt = build_taps(dw, sw, mode, 0, sw - 1);
  const Taps1D yt = build_taps(dh, sh, mode, 0, sh - 1);
  std::vector<int> rows(sh);
  for (int r = 0; r < sh; ++r) rows[r] = r;
  separable_resize(src, sw, c, rows, xt, yt, dst, dh, dw);
}

// Inverse-map affine warp: for each dst pixel, sample src at M^-1 * (x, y).
// M is the 2x3 forward matrix (cv2.warpAffine convention); border is constant.
// mode: 0 = nearest, otherwise bicubic.
//
// OpenCV 5's float-coordinate arithmetic, as the port's numpy form
// (imaging.warp_affine): M inverted in double (a singular M maps every
// pixel to the origin), each source coordinate computed in double and
// rounded to float; nearest takes the pixel at the coordinate rounded half
// to even, cubic the 4 x 4 taps from floor - 1 with float weights at the
// exact fractional offset, each tap's product rounded to float and summed
// in double, rows outer, in the numpy form's order.  Taps outside the
// image read `border`.
void warp_affine_f32(const float* src, int sh, int sw, int c,
                     float* dst, int dh, int dw,
                     const double* m, int mode, float border) {
  const double det = m[0] * m[4] - m[1] * m[3];
  const double dinv = det != 0.0 ? 1.0 / det : 0.0;
  const double ia = m[4] * dinv, ib = -m[1] * dinv;
  const double id = -m[3] * dinv, ie = m[0] * dinv;
  const double itx = -ia * m[2] - ib * m[5];
  const double ity = -id * m[2] - ie * m[5];
  // a tap further than this outside the image reads the border whatever
  // its exact position: clamping the corner there keeps the integer
  // conversion defined
  const float lo_x = -8.0f, hi_x = static_cast<float>(sw) + 8.0f;
  const float lo_y = -8.0f, hi_y = static_cast<float>(sh) + 8.0f;
  for (int y = 0; y < dh; ++y) {
    for (int x = 0; x < dw; ++x) {
      const float sx = static_cast<float>(ia * x + ib * y + itx);
      const float sy = static_cast<float>(id * x + ie * y + ity);
      float* out = dst + (static_cast<int64_t>(y) * dw + x) * c;
      if (mode == 0) {
        const float rx = std::rint(sx), ry = std::rint(sy);
        if (!(rx >= 0.0f && rx < static_cast<float>(sw) && ry >= 0.0f &&
              ry < static_cast<float>(sh))) {
          for (int k = 0; k < c; ++k) out[k] = border;
        } else {
          const float* in = src + (static_cast<int64_t>(ry) * sw +
                                   static_cast<int64_t>(rx)) * c;
          std::memcpy(out, in, sizeof(float) * c);
        }
        continue;
      }
      const float fx0 = std::floor(sx), fy0 = std::floor(sy);
      float wx[4], wy[4];
      cubic_taps(sx - fx0, wx);
      cubic_taps(sy - fy0, wy);
      const int x0 = static_cast<int>(clampf(fx0, lo_x, hi_x)) - 1;
      const int y0 = static_cast<int>(clampf(fy0, lo_y, hi_y)) - 1;
      for (int k = 0; k < c; ++k) {
        double acc = 0.0;
        for (int i = 0; i < 4; ++i) {
          const int yy = y0 + i;
          for (int j = 0; j < 4; ++j) {
            const int xx = x0 + j;
            const float v = (xx < 0 || xx >= sw || yy < 0 || yy >= sh)
                                ? border
                                : src[(static_cast<int64_t>(yy) * sw + xx) * c + k];
            acc += static_cast<double>(v * (wy[i] * wx[j]));
          }
        }
        out[k] = static_cast<float>(acc);
      }
    }
  }
}

// Fused zero-pad crop + resize: resize the inclusive window
// [x0..x1] x [y0..y1] of src (which may extend beyond the image; the
// out-of-image part reads 0) straight to dst, without materializing the
// crop.  Sampling semantics are identical to crop_from_bbox followed by
// resize_f32: interpolation taps clamp to the WINDOW (edge replicate at the
// crop borders, what resizing the materialized crop does), and a tap whose
// window pixel lies outside the source image reads the zero padding.
// mode: 0 = nearest, 1 = bilinear, 2 = bicubic.
void crop_resize_f32(const float* src, int sh, int sw, int c,
                     int x0, int y0, int x1, int y1,
                     float* dst, int dh, int dw, int mode) {
  const int cw = x1 - x0 + 1;
  const int ch = y1 - y0 + 1;
  if (cw <= 0 || ch <= 0) {
    std::memset(dst, 0, sizeof(float) * static_cast<int64_t>(dh) * dw * c);
    return;
  }
  // Taps in window coordinates (clamped to the window: edge replicate at
  // the crop borders), then mapped to absolute source coordinates; window
  // pixels outside the image become -1 = read the zero padding.
  Taps1D xt = build_taps(dw, cw, mode, 0, cw - 1);
  for (auto& xi : xt.idx) {
    const int abs_x = x0 + xi;
    xi = (abs_x < 0 || abs_x >= sw) ? -1 : abs_x;
  }
  const Taps1D yt = build_taps(dh, ch, mode, 0, ch - 1);
  std::vector<int> rows(ch);
  for (int r = 0; r < ch; ++r) {
    const int abs_y = y0 + r;
    rows[r] = (abs_y < 0 || abs_y >= sh) ? -1 : abs_y;
  }
  separable_resize(src, sw, c, rows, xt, yt, dst, dh, dw);
}

void hflip_f32(const float* src, int h, int w, int c, float* dst) {
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      const float* in = src + (static_cast<int64_t>(y) * w + (w - 1 - x)) * c;
      float* out = dst + (static_cast<int64_t>(y) * w + x) * c;
      std::memcpy(out, in, sizeof(float) * c);
    }
  }
}

// Max-combined Gaussian heatmap over n points — helpers.make_gt semantics:
// each bump is exp(-4 ln2 * d^2 / sigma^2) (sigma is the FWHM).
void gaussian_hm_f32(const float* pts_xy, int n, int h, int w,
                     float sigma, float* dst) {
  const float inv = 4.0f * 0.6931471805599453f / (sigma * sigma);
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      float best = 0.0f;
      for (int p = 0; p < n; ++p) {
        const float dx = x - pts_xy[2 * p];
        const float dy = y - pts_xy[2 * p + 1];
        const float v = std::exp(-(dx * dx + dy * dy) * inv);
        best = std::max(best, v);
      }
      dst[static_cast<int64_t>(y) * w + x] = best;
    }
  }
}

// Soft n-ellipse indicator — guidance.compute_nellipse semantics:
// d(x) = sum of distances to the foci; boundary constant c = the largest
// focal-point sum (so every click point is enclosed); output
// sigmoid((c - d) / (softness * c)), argument clipped to +-50.  Degenerate
// (all foci coincident): 1 exactly at the focus, 0 elsewhere.
void nellipse_f32(const float* pts_xy, int n, int h, int w,
                  float softness, float* dst) {
  double c = 0.0;
  for (int p = 0; p < n; ++p) {
    double s = 0.0;
    for (int q = 0; q < n; ++q) {
      const double dx = pts_xy[2 * p] - pts_xy[2 * q];
      const double dy = pts_xy[2 * p + 1] - pts_xy[2 * q + 1];
      s += std::sqrt(dx * dx + dy * dy);
    }
    c = std::max(c, s);
  }
  for (int y = 0; y < h; ++y) {
    for (int x = 0; x < w; ++x) {
      double d = 0.0;
      for (int p = 0; p < n; ++p) {
        const double dx = x - pts_xy[2 * p];
        const double dy = y - pts_xy[2 * p + 1];
        d += std::sqrt(dx * dx + dy * dy);
      }
      float v;
      if (c <= 0.0) {
        v = (d == 0.0) ? 1.0f : 0.0f;
      } else {
        const double t = clampf(static_cast<float>((d - c) / (softness * c)),
                                -50.0f, 50.0f);
        v = static_cast<float>(1.0 / (1.0 + std::exp(t)));
      }
      dst[static_cast<int64_t>(y) * w + x] = v;
    }
  }
}

}  // extern "C"
