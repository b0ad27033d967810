// Native host-side data-path kernels for blindshadowremoval_tpu.
//
// The reference delegates its CPU data path to OpenCV's C++ kernels
// (imread/resize/flip, SURVEY.md §2b); this library provides the equivalent
// first-party kernels for the loader's hot loop — zero-pad crop + bilinear
// resize (half-pixel centers, matching cv2.INTER_LINEAR and the TF resize
// convention used on device), horizontal flip, and a batched entry point
// that fans work across a thread pool.
//
// Built as a plain C ABI shared object, bound from Python via ctypes
// (no pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Bilinear sample of img[H,W,C] at (y, x) with zero outside bounds.
static inline void sample_bilinear(const float* img, int h, int w, int c,
                                   float y, float x, float* out) {
  // zero-pad semantics: anything sampled fully outside is 0
  const int y0 = static_cast<int>(std::floor(y));
  const int x0 = static_cast<int>(std::floor(x));
  const float fy = y - y0;
  const float fx = x - x0;
  for (int k = 0; k < c; ++k) out[k] = 0.f;
  for (int dy = 0; dy < 2; ++dy) {
    const int yy = y0 + dy;
    if (yy < 0 || yy >= h) continue;
    const float wy = dy ? fy : 1.f - fy;
    for (int dx = 0; dx < 2; ++dx) {
      const int xx = x0 + dx;
      if (xx < 0 || xx >= w) continue;
      const float wxy = wy * (dx ? fx : 1.f - fx);
      const float* p = img + (static_cast<int64_t>(yy) * w + xx) * c;
      for (int k = 0; k < c; ++k) out[k] += wxy * p[k];
    }
  }
}

// Crop box [x0, y0, x1, y1) from img[H,W,C] (zero-padded outside) and
// bilinearly resize to out[S,S,C].
void crop_resize_bilinear(const float* img, int h, int w, int c,
                          const int* box, float* out, int s) {
  const int bx0 = box[0], by0 = box[1], bx1 = box[2], by1 = box[3];
  const float bh = static_cast<float>(by1 - by0);
  const float bw = static_cast<float>(bx1 - bx0);
  for (int r = 0; r < s; ++r) {
    const float sy = by0 + (r + 0.5f) * bh / s - 0.5f;
    float* row = out + static_cast<int64_t>(r) * s * c;
    for (int q = 0; q < s; ++q) {
      const float sx = bx0 + (q + 0.5f) * bw / s - 0.5f;
      sample_bilinear(img, h, w, c, sy, sx, row + static_cast<int64_t>(q) * c);
    }
  }
}

// Horizontal flip of img[H,W,C] into out.
void hflip(const float* img, int h, int w, int c, float* out) {
  for (int r = 0; r < h; ++r) {
    const float* src = img + static_cast<int64_t>(r) * w * c;
    float* dst = out + static_cast<int64_t>(r) * w * c;
    for (int q = 0; q < w; ++q) {
      std::memcpy(dst + static_cast<int64_t>(q) * c,
                  src + static_cast<int64_t>(w - 1 - q) * c,
                  sizeof(float) * c);
    }
  }
}

// Batched crop+resize: n images (each h*w*c, contiguous), n boxes, n outputs,
// fanned over a thread pool.
void batch_crop_resize(const float* imgs, int n, int h, int w, int c,
                       const int* boxes, float* outs, int s, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> pool;
  std::int64_t in_stride = static_cast<int64_t>(h) * w * c;
  std::int64_t out_stride = static_cast<int64_t>(s) * s * c;
  auto work = [&](int tid) {
    for (int i = tid; i < n; i += n_threads) {
      crop_resize_bilinear(imgs + i * in_stride, h, w, c, boxes + i * 4,
                           outs + i * out_stride, s);
    }
  };
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(work, t);
  for (auto& th : pool) th.join();
}

}  // extern "C"
