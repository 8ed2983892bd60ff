// The port's native host runtime: the KVQ sample's two views, each fused
// with its normalisation, over the frames of a clip on a few threads
// (counterpart of kvq_tpu/runtime/kvq_runtime.cpp:134-295, without OpenCV).
//
//   kvq_fragment_mosaic   gather of the fragment mosaic through the index
//                         maps of data/fragments.py:fragment_index_maps,
//                         then (v - mean) * (1 / std) per channel;
//   kvq_resize            one frame at a time, the resize of
//                         data/resize.py, bit for bit: area when a side
//                         shrinks (integer scales as block sums), else
//                         bilinear in OpenCV's 11-bit fixed point;
//   kvq_resize_normalize  the same, then (v * scale - mean) * (1 / std).
//
// The normalisations are the JAX package's C++ expressions, so the mosaic
// is bit-equal to kvq_tpu.runtime's.  Build without -ffast-math and with
// -ffp-contract=off: the resize's sums must round after every product, in
// input order, as numpy's do (runtime/__init__.py builds it so).
// Frames are split over n_threads std::threads; the calls come through
// ctypes, which releases the GIL, so the Loader's threads overlap.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <utility>
#include <vector>

namespace {

void parallel_for(int n, int n_threads,
                  const std::function<void(int, int)>& fn) {
  if (n_threads <= 1 || n <= 1) {
    fn(0, n);
    return;
  }
  n_threads = std::min(n_threads, n);
  std::vector<std::thread> threads;
  int chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int lo = t * chunk;
    int hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([&fn, lo, hi] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

constexpr int kCoefBits = 11;  // OpenCV's INTER_RESIZE_COEF_BITS

// data/resize.py:_scale: 1 / (out / in), as OpenCV computes it
double scale_of(int src, int dst) { return 1.0 / ((double)dst / src); }

// (dst, k) taps of the area resize along one axis: data/resize.py:area_taps
struct AreaTaps {
  int k = 0;
  std::vector<int> index;
  std::vector<float> weight;
};

AreaTaps area_taps(int src, int dst) {
  double scale = scale_of(src, dst);
  std::vector<std::vector<std::pair<int, double>>> rows(dst);
  AreaTaps t;
  for (int d = 0; d < dst; ++d) {
    double f1 = d * scale;
    double f2 = f1 + scale;
    double cell = std::min(scale, src - f1);
    int s2 = std::min((int)std::floor(f2), src - 1);
    int s1 = std::min((int)std::ceil(f1), s2);
    auto& taps = rows[d];
    if (s1 - f1 > 1e-3) taps.emplace_back(s1 - 1, (s1 - f1) / cell);
    for (int s = s1; s < s2; ++s) taps.emplace_back(s, 1.0 / cell);
    if (f2 - s2 > 1e-3)
      taps.emplace_back(s2, std::min(std::min(f2 - s2, 1.0), cell) / cell);
    t.k = std::max(t.k, (int)taps.size());
  }
  t.index.assign((size_t)dst * t.k, 0);
  t.weight.assign((size_t)dst * t.k, 0.f);
  for (int d = 0; d < dst; ++d) {
    const auto& taps = rows[d];
    for (int j = 0; j < t.k; ++j) {  // unused taps: the last index, weight 0
      bool used = j < (int)taps.size();
      t.index[(size_t)d * t.k + j] = used ? taps[j].first : taps.back().first;
      t.weight[(size_t)d * t.k + j] = used ? (float)taps[j].second : 0.f;
    }
  }
  return t;
}

// two taps per output position, fixed-point weights:
// data/resize.py:linear_taps and its uint8 branch of _linear
struct LinearTaps {
  std::vector<int> i0, i1, w0, w1;
};

LinearTaps linear_taps(int src, int dst, bool area_mode) {
  double scale = scale_of(src, dst);
  double inv = (double)dst / src;
  LinearTaps t;
  for (int d = 0; d < dst; ++d) {
    int s;
    double f;
    if (area_mode) {
      s = (int)std::floor(d * scale);
      f = (d + 1) - (s + 1) * inv;
      f = f <= 0 ? 0.0 : f - std::floor(f);
    } else {
      f = (d + 0.5) * scale - 0.5;
      s = (int)std::floor(f);
      f -= s;
    }
    if (s < 0) s = 0, f = 0.0;
    if (s >= src - 1) s = src - 1, f = 0.0;
    float a0 = (float)(1.0 - f), a1 = (float)f;
    t.i0.push_back(s);
    t.i1.push_back(std::min(s + 1, src - 1));
    t.w0.push_back((int)std::nearbyint(a0 * (float)(1 << kCoefBits)));
    t.w1.push_back((int)std::nearbyint(a1 * (float)(1 << kCoefBits)));
  }
  return t;
}

uint8_t to_u8(float v) {  // np.clip(np.rint(v), 0, 255): half to even
  return (uint8_t)std::min(255.f, std::max(0.f, std::nearbyint(v)));
}

// How one (H, W) -> (oh, ow) resize runs, chosen as data/views.py does
// (area when a side shrinks, else linear) and then as data/resize.py does.
struct Resize {
  enum Mode { kCopy, kBlocks, kArea, kLinear } mode;
  int H, W, oh, ow;
  int by = 0, bx = 0;  // block sizes
  AreaTaps ty, tx;
  LinearTaps ly, lx;

  Resize(int H_, int W_, int oh_, int ow_) : H(H_), W(W_), oh(oh_), ow(ow_) {
    bool area = oh < H || ow < W;
    double sy = scale_of(H, oh), sx = scale_of(W, ow);
    if (H == oh && W == ow) {
      mode = kCopy;
    } else if (area && sy >= 1 && sx >= 1) {
      if (std::fabs(sy - std::round(sy)) < DBL_EPSILON &&
          std::fabs(sx - std::round(sx)) < DBL_EPSILON) {
        mode = kBlocks;
        by = H / oh;
        bx = W / ow;
      } else {
        mode = kArea;
        ty = area_taps(H, oh);
        tx = area_taps(W, ow);
      }
    } else {
      mode = kLinear;
      ly = linear_taps(H, oh, area);
      lx = linear_taps(W, ow, area);
    }
  }

  // scratch floats (area) or ints (linear) one thread needs for a frame
  size_t scratch() const {
    return mode == kArea || mode == kLinear ? (size_t)H * ow * 3 : 0;
  }

  void frame(const uint8_t* src, uint8_t* dst, float* fbuf, int* ibuf) const {
    switch (mode) {
      case kCopy:
        std::memcpy(dst, src, (size_t)H * W * 3);
        return;
      case kBlocks:
        blocks(src, dst);
        return;
      case kArea:
        area(src, dst, fbuf);
        return;
      case kLinear:
        linear(src, dst, ibuf);
        return;
    }
  }

  void blocks(const uint8_t* src, uint8_t* dst) const {
    float inv = (float)(1.0 / (by * bx));
    for (int oy = 0; oy < oh; ++oy)
      for (int ox = 0; ox < ow; ++ox)
        for (int c = 0; c < 3; ++c) {
          int total = 0;
          for (int i = 0; i < by; ++i)
            for (int j = 0; j < bx; ++j)
              total += src[((size_t)(oy * by + i) * W + ox * bx + j) * 3 + c];
          dst[((size_t)oy * ow + ox) * 3 + c] =
              by == 2 && bx == 2 ? (uint8_t)((total + 2) >> 2)
                                 : to_u8((float)total * inv);
        }
  }

  // along each row, then down the columns; float32 sums in tap order
  void area(const uint8_t* src, uint8_t* dst, float* rows) const {
    const int kx = tx.k, ky = ty.k;
    for (int y = 0; y < H; ++y) {
      const uint8_t* in = src + (size_t)y * W * 3;
      float* r = rows + (size_t)y * ow * 3;
      for (int ox = 0; ox < ow; ++ox) {
        const int* ix = &tx.index[(size_t)ox * kx];
        const float* wx = &tx.weight[(size_t)ox * kx];
        for (int c = 0; c < 3; ++c) {
          float acc = (float)in[ix[0] * 3 + c] * wx[0];
          for (int k = 1; k < kx; ++k) acc += (float)in[ix[k] * 3 + c] * wx[k];
          r[ox * 3 + c] = acc;
        }
      }
    }
    const int n = ow * 3;
    for (int oy = 0; oy < oh; ++oy) {
      const int* iy = &ty.index[(size_t)oy * ky];
      const float* wy = &ty.weight[(size_t)oy * ky];
      uint8_t* out = dst + (size_t)oy * n;
      for (int j = 0; j < n; ++j) {
        float acc = rows[(size_t)iy[0] * n + j] * wy[0];
        for (int k = 1; k < ky; ++k) acc += rows[(size_t)iy[k] * n + j] * wy[k];
        out[j] = to_u8(acc);
      }
    }
  }

  void linear(const uint8_t* src, uint8_t* dst, int* rows) const {
    const int n = ow * 3;
    for (int y = 0; y < H; ++y) {
      const uint8_t* in = src + (size_t)y * W * 3;
      int* r = rows + (size_t)y * n;
      for (int ox = 0; ox < ow; ++ox)
        for (int c = 0; c < 3; ++c)
          r[ox * 3 + c] = in[lx.i0[ox] * 3 + c] * lx.w0[ox] +
                          in[lx.i1[ox] * 3 + c] * lx.w1[ox];
    }
    for (int oy = 0; oy < oh; ++oy) {
      const int* r0 = rows + (size_t)ly.i0[oy] * n;
      const int* r1 = rows + (size_t)ly.i1[oy] * n;
      uint8_t* out = dst + (size_t)oy * n;
      for (int j = 0; j < n; ++j) {
        int v = (((ly.w0[oy] * (r0[j] >> 4)) >> 16) +
                 ((ly.w1[oy] * (r1[j] >> 4)) >> 16) + 2) >> 2;
        out[j] = (uint8_t)std::min(255, std::max(0, v));
      }
    }
  }
};

// the resize of frames [lo, hi) of video into out (uint8) or, normalised,
// into fout (float32), with one thread's scratch
void resize_frames(const Resize& rs, const uint8_t* video, int lo, int hi,
                   uint8_t* out, float* fout, const float* mean,
                   const float* stdv, float scale) {
  std::vector<float> fbuf(rs.mode == Resize::kArea ? rs.scratch() : 0);
  std::vector<int> ibuf(rs.mode == Resize::kLinear ? rs.scratch() : 0);
  const size_t in_px = (size_t)rs.H * rs.W, out_px = (size_t)rs.oh * rs.ow;
  std::vector<uint8_t> frame(fout ? out_px * 3 : 0);
  float inv_std[3] = {1.f / stdv[0], 1.f / stdv[1], 1.f / stdv[2]};
  for (int t = lo; t < hi; ++t) {
    uint8_t* dst = fout ? frame.data() : out + (size_t)t * out_px * 3;
    rs.frame(video + (size_t)t * in_px * 3, dst, fbuf.data(), ibuf.data());
    if (!fout) continue;
    float* f = fout + (size_t)t * out_px * 3;
    for (size_t o = 0; o < out_px * 3; o += 3) {
      f[o + 0] = ((float)dst[o + 0] * scale - mean[0]) * inv_std[0];
      f[o + 1] = ((float)dst[o + 1] * scale - mean[1]) * inv_std[1];
      f[o + 2] = ((float)dst[o + 2] * scale - mean[2]) * inv_std[2];
    }
  }
}

}  // namespace

extern "C" {

// Fused fragment mosaic + normalisation.
//   video: (T, H, W, 3) uint8; ymap/xmap: (tgroups, out_h, out_w) int32
//   out:   (T, out_h, out_w, 3) float32, (v - mean[c]) * (1 / std[c])
void kvq_fragment_mosaic(const uint8_t* video, int T, int H, int W,
                         const int32_t* ymap, const int32_t* xmap,
                         int tgroups, int aligned, int out_h, int out_w,
                         const float* mean, const float* stdv, float* out,
                         int n_threads) {
  float inv_std[3] = {1.f / stdv[0], 1.f / stdv[1], 1.f / stdv[2]};
  parallel_for(T, n_threads, [&](int lo, int hi) {
    for (int t = lo; t < hi; ++t) {
      int tg = std::min(t / aligned, tgroups - 1);
      const int32_t* ym = ymap + (size_t)tg * out_h * out_w;
      const int32_t* xm = xmap + (size_t)tg * out_h * out_w;
      const uint8_t* src = video + (size_t)t * H * W * 3;
      float* dst = out + (size_t)t * out_h * out_w * 3;
      for (size_t o = 0; o < (size_t)out_h * out_w; ++o) {
        const uint8_t* px = src + ((size_t)ym[o] * W + xm[o]) * 3;
        float* dp = dst + o * 3;
        dp[0] = ((float)px[0] - mean[0]) * inv_std[0];
        dp[1] = ((float)px[1] - mean[1]) * inv_std[1];
        dp[2] = ((float)px[2] - mean[2]) * inv_std[2];
      }
    }
  });
}

// Resize of each frame: (T, H, W, 3) uint8 -> (T, oh, ow, 3) uint8.
void kvq_resize(const uint8_t* video, int T, int H, int W, int oh, int ow,
                uint8_t* out, int n_threads) {
  Resize rs(H, W, oh, ow);
  parallel_for(T, n_threads, [&](int lo, int hi) {
    float unit[3] = {1.f, 1.f, 1.f};
    resize_frames(rs, video, lo, hi, out, nullptr, unit, unit, 1.f);
  });
}

// Resize + normalisation: (T, oh, ow, 3) float32,
// (v * scale - mean[c]) * (1 / std[c]) with scale 1/255 when div255.
void kvq_resize_normalize(const uint8_t* video, int T, int H, int W, int oh,
                          int ow, const float* mean, const float* stdv,
                          int div255, float* out, int n_threads) {
  Resize rs(H, W, oh, ow);
  float scale = div255 ? 1.f / 255.f : 1.f;
  parallel_for(T, n_threads, [&](int lo, int hi) {
    resize_frames(rs, video, lo, hi, nullptr, out, mean, stdv, scale);
  });
}

}  // extern "C"
