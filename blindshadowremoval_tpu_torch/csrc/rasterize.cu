// The four geometry maps of `device_geometry_maps` in one launch: the UV
// map, the offset maps into and out of the canonical face (reg_in, reg_out)
// and the soft face region, for every view of a batch.
//
// Replaces no TPU kernel: the JAX package rasterizes in plain jnp
// (blindshadowremoval_tpu/geometry/triangulation.py:rasterize_linear), and
// the port's plain version (geometry/triangulation.py:rasterize_linear) tests
// every one of 192 padded triangles against every pixel, 16 triangles at a
// time, in some 1,700 ATen launches over [B, 16, S*S] temporaries a call.
//
// What bounds it on the card: the outputs, 10 f32 channels a pixel (uv 3,
// reg 6, face 1), 335 MB at B=128 and S=256, ~0.1 ms at 3.35 TB/s.  Once each
// pixel tests only the triangles near it, the arithmetic is a few GFLOP on
// the CUDA cores, below the bytes.
//
// What the design does about it:
//  * One block per (16x16 pixel tile, map, view), one thread a pixel.  The
//    block loads its view's points for the map, computes each triangle's
//    corners and `den` in shared memory, and keeps, in topology order, the
//    triangles whose bounding box, padded by one pixel, meets the tile (a
//    warp ballot and a prefix count).  Each pixel then walks that short
//    list and takes the first triangle whose three weights are >= -1e-7,
//    the plain path's rule, and writes its channels straight into the
//    channels-last outputs: reg_in to channels 0-2 and reg_out to 3-5 of
//    one [B,S,S,6] tensor.
//  * The face map needs only coverage (`> 0`).  Its block computes coverage
//    over the tile and a 2-pixel halo, clamped at the image's edge (the
//    plain path's replicate padding), and applies the 5x5 separable
//    Gaussian in shared memory with the taps the plain path builds.
//  * reg_in's points and topology (LM_REF and the anchors) are the same for
//    every view; they come once, not expanded per view, with the anchors,
//    the UV values, the taps and the grid coordinates, all uploaded once
//    per device by the caller.
//
// Numerics: every weight, value and coverage equals the plain path's on the
// card, bit for bit.  The arithmetic is the plain path's, operation for
// operation and in its order, each rounded on its own (__fsub_rn, __fmul_rn,
// __fadd_rn, __fdiv_rn: nothing is contracted into an FMA); the grid
// coordinates are the plain path's own tensor.  Culling keeps a superset of
// the triangles that can hold a pixel of the tile:
//  * A pixel a pixel or more outside a triangle's bounding box has a weight
//    of at most -d/(3L) (d its distance, L the triangle's size), and the
//    computed weight is off by at most ~18u(1 + L/d)/q of that, where u is
//    2^-24 and q = |den| / (longest edge)^2, the triangle's shape.  The
//    proof needs that share below 1.  At q >= 1/64 it is at most ~0.2 up
//    to S = 2048 (a triangle spanning the image, L ~ 1.4, at d one pixel),
//    so the computed weight stays at most -(1 - 0.2) d/(3L), ~-1e-4 there,
//    far below -1e-7: no such pixel can pass the test.
//  * Slimmer triangles (q < 1/64), and the near-degenerate ones whose den the
//    plain path replaces by 1e-12, are never culled: every pixel tests them.
//
// C interface (loaded with ctypes): bsr_geometry_maps returns a cudaError_t
// value, 0 on success; the launch runs on `stream`.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;                  // pixels a side of a block's tile
constexpr int kThreads = kTile * kTile;    // one thread a pixel
constexpr int kMaxPoints = 128;
constexpr int kMaxTriangles = kThreads;    // one thread a triangle
constexpr int kHalo = 2;                   // the 5x5 Gaussian's reach
constexpr int kHaloTile = kTile + 2 * kHalo;
constexpr int kMaxSize = 2048;             // see the culling bound above
constexpr float kEps = 1e-7f;              // the plain path's eps
constexpr float kDenGuard = 1e-12f;        // ... and its guard on den
constexpr float kSliver = 64.0f;           // cull only at q >= 1 / kSliver

enum Map { kUV = 0, kRegIn = 1, kRegOut = 2, kFace = 3, kMaps = 4 };

struct Args {
  const float* lm;          // [B, n_lm, 2] (x, y)
  const float* face_pts;    // [B, n_face, 2]
  const int* uv_tris;       // [B, t_uv, 3], -1 padded
  const int* face_tris;     // [B, t_face, 3]
  const int* reg_tris;      // [B, t_reg, 3], over lm + anchors
  const float* ref_pts;     // [n_lm + n_anchor, 2]: LM_REF + anchors
  const int* ref_tris;      // [t_ref, 3]: their Delaunay topology
  const float* anchors;     // [n_anchor, 2]
  const float* uv_vals;     // [n_lm, 3]
  const float* lin;         // [size]: grid coordinate of row or column i
  const float* taps;        // [5]: the Gaussian's taps
  float* uv;                // [B, S, S, 3]
  float* reg;               // [B, S, S, 6]
  float* face;              // [B, S, S, 1]
  int size, n_lm, n_anchor, n_face, t_uv, t_face, t_reg, t_ref;
};

// One kept triangle: the terms of its weights, w0 = (a0 (x - cx) +
// b0 (y - cy)) / den and w1 = (a1 (x - cx) + b1 (y - cy)) / den, and its
// vertices.
struct Tri {
  float a0, b0, a1, b1, cx, cy, den;
  int v0, v1, v2;
};

struct Shared {
  float pts[kMaxPoints][2];
  float vals[kMaxPoints][3];
  Tri tris[kMaxTriangles];
  int warp_kept[kThreads / 32];
  float cover[kHaloTile][kHaloTile];
  float rows[kTile][kHaloTile];
};

// The first kept triangle that holds (x, y), -1 if none; its weights in w.
__device__ __forceinline__ int first_hit(const Shared& sh, int kept, float x,
                                         float y, float w[3]) {
  for (int k = 0; k < kept; ++k) {
    const Tri& t = sh.tris[k];
    const float dx = __fsub_rn(x, t.cx), dy = __fsub_rn(y, t.cy);
    const float w0 = __fdiv_rn(
        __fadd_rn(__fmul_rn(t.a0, dx), __fmul_rn(t.b0, dy)), t.den);
    if (!(w0 >= -kEps)) continue;
    const float w1 = __fdiv_rn(
        __fadd_rn(__fmul_rn(t.a1, dx), __fmul_rn(t.b1, dy)), t.den);
    if (!(w1 >= -kEps)) continue;
    const float w2 = __fsub_rn(__fsub_rn(1.0f, w0), w1);
    if (w2 >= -kEps) {
      w[0] = w0;
      w[1] = w1;
      w[2] = w2;
      return k;
    }
  }
  return -1;
}

// Coverage of the face map at pixel (row r, column c): a hit whose
// interpolated 1 is > 0, as the plain path's `face > 0` reads it.
__device__ __forceinline__ float covered(const Shared& sh, int kept,
                                         const float* lin, int r, int c) {
  float w[3];
  if (first_hit(sh, kept, lin[c], lin[r], w) < 0) return 0.0f;
  return __fadd_rn(__fadd_rn(w[0], w[1]), w[2]) > 0.0f ? 1.0f : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
geometry_maps(const Args a) {
  __shared__ Shared sh;
  const int map = blockIdx.y, view = blockIdx.z, tid = threadIdx.x;
  const int s = a.size;
  const int tiles_x = (s + kTile - 1) / kTile;
  const int r0 = (blockIdx.x / tiles_x) * kTile;
  const int c0 = (blockIdx.x % tiles_x) * kTile;
  const int n_reg = a.n_lm + a.n_anchor;

  // ---- the map's points (and vertex values)
  const int n_pts = map == kUV ? a.n_lm : map == kFace ? a.n_face : n_reg;
  for (int p = tid; p < n_pts; p += kThreads) {
    if (map == kUV || map == kFace) {
      const float* src = map == kUV
          ? a.lm + ((size_t)view * a.n_lm + p) * 2
          : a.face_pts + ((size_t)view * a.n_face + p) * 2;
      sh.pts[p][0] = src[0];
      sh.pts[p][1] = src[1];
      if (map == kUV) {
        for (int k = 0; k < 3; ++k) sh.vals[p][k] = a.uv_vals[p * 3 + k];
      }
    } else {
      // the view's landmarks and the anchors (lm_anch) against the
      // canonical points: reg_in sits on the canonical points with values
      // lm_anch - ref, reg_out on lm_anch with ref - lm_anch; channels are
      // (row delta, column delta, 0)
      const float* own = p < a.n_lm
          ? a.lm + ((size_t)view * a.n_lm + p) * 2
          : a.anchors + (p - a.n_lm) * 2;
      const float* ref = a.ref_pts + p * 2;
      const bool in = map == kRegIn;
      sh.pts[p][0] = in ? ref[0] : own[0];
      sh.pts[p][1] = in ? ref[1] : own[1];
      sh.vals[p][0] = in ? __fsub_rn(own[1], ref[1])
                         : __fsub_rn(ref[1], own[1]);
      sh.vals[p][1] = in ? __fsub_rn(own[0], ref[0])
                         : __fsub_rn(ref[0], own[0]);
      sh.vals[p][2] = 0.0f;
    }
  }
  __syncthreads();

  // ---- the triangles near the tile (the face map's with its halo), in
  // topology order
  const int* tris;
  int n_tris;
  switch (map) {
    case kUV:
      tris = a.uv_tris + (size_t)view * a.t_uv * 3;
      n_tris = a.t_uv;
      break;
    case kRegIn:
      tris = a.ref_tris;
      n_tris = a.t_ref;
      break;
    case kRegOut:
      tris = a.reg_tris + (size_t)view * a.t_reg * 3;
      n_tris = a.t_reg;
      break;
    default:
      tris = a.face_tris + (size_t)view * a.t_face * 3;
      n_tris = a.t_face;
  }
  const int reach = map == kFace ? kHalo : 0;
  const float pad = 1.0f / (float)(s - 1);   // one pixel
  const float x_lo = a.lin[max(c0 - reach, 0)] - pad;
  const float x_hi = a.lin[min(c0 + kTile - 1 + reach, s - 1)] + pad;
  const float y_lo = a.lin[max(r0 - reach, 0)] - pad;
  const float y_hi = a.lin[min(r0 + kTile - 1 + reach, s - 1)] + pad;

  bool keep = false;
  Tri t;
  if (tid < n_tris) {
    int v[3];
    for (int j = 0; j < 3; ++j) v[j] = tris[tid * 3 + j];
    keep = v[0] >= 0;                    // the plain path's `valid`
    for (int j = 0; j < 3; ++j) v[j] = min(max(v[j], 0), n_pts - 1);
    const float ax = sh.pts[v[0]][0], ay = sh.pts[v[0]][1];
    const float bx = sh.pts[v[1]][0], by = sh.pts[v[1]][1];
    const float cx = sh.pts[v[2]][0], cy = sh.pts[v[2]][1];
    t.a0 = __fsub_rn(by, cy);
    t.b0 = __fsub_rn(cx, bx);
    t.a1 = __fsub_rn(cy, ay);
    t.b1 = __fsub_rn(ax, cx);
    t.cx = cx;
    t.cy = cy;
    // den = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
    float den = __fadd_rn(__fmul_rn(t.a0, __fsub_rn(ax, cx)),
                          __fmul_rn(t.b0, __fsub_rn(ay, cy)));
    const bool guarded = fabsf(den) < kDenGuard;
    t.den = guarded ? kDenGuard : den;
    t.v0 = v[0];
    t.v1 = v[1];
    t.v2 = v[2];
    const float e0 = (bx - ax) * (bx - ax) + (by - ay) * (by - ay);
    const float e1 = (cx - bx) * (cx - bx) + (cy - by) * (cy - by);
    const float e2 = (ax - cx) * (ax - cx) + (ay - cy) * (ay - cy);
    // false for a NaN: such a triangle is tested, and fails, everywhere
    const bool cullable =
        !guarded && fabsf(den) * kSliver >= fmaxf(e0, fmaxf(e1, e2));
    const bool meets = fmaxf(ax, fmaxf(bx, cx)) >= x_lo &&
                       fminf(ax, fminf(bx, cx)) <= x_hi &&
                       fmaxf(ay, fmaxf(by, cy)) >= y_lo &&
                       fminf(ay, fminf(by, cy)) <= y_hi;
    keep = keep && (meets || !cullable);
  }
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) sh.warp_kept[warp] = __popc(ballot);
  __syncthreads();
  int slot = __popc(ballot & ((1u << lane) - 1u)), kept = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    if (w < warp) slot += sh.warp_kept[w];
    kept += sh.warp_kept[w];
  }
  if (keep) sh.tris[slot] = t;
  __syncthreads();

  const int ty = tid / kTile, tx = tid % kTile;
  const int r = r0 + ty, c = c0 + tx;
  const size_t pixel = ((size_t)view * s + r) * s + c;

  if (map != kFace) {
    if (r >= s || c >= s) return;
    float w[3];
    const int k = first_hit(sh, kept, a.lin[c], a.lin[r], w);
    float out[3] = {0.0f, 0.0f, 0.0f};
    if (k >= 0) {
      const Tri& h = sh.tris[k];
      for (int j = 0; j < 3; ++j) {
        out[j] = __fadd_rn(__fadd_rn(__fmul_rn(w[0], sh.vals[h.v0][j]),
                                     __fmul_rn(w[1], sh.vals[h.v1][j])),
                           __fmul_rn(w[2], sh.vals[h.v2][j]));
      }
    }
    float* dst = map == kUV ? a.uv + pixel * 3
                            : a.reg + pixel * 6 + (map == kRegOut ? 3 : 0);
    for (int j = 0; j < 3; ++j) dst[j] = out[j];
    return;
  }

  // ---- face: coverage over the tile and its halo, edges replicated, then
  // the Gaussian along the rows and along the columns
  for (int i = tid; i < kHaloTile * kHaloTile; i += kThreads) {
    const int hr = i / kHaloTile, hc = i % kHaloTile;
    const int rr = min(max(r0 - kHalo + hr, 0), s - 1);
    const int cc = min(max(c0 - kHalo + hc, 0), s - 1);
    sh.cover[hr][hc] = covered(sh, kept, a.lin, rr, cc);
  }
  float k5[5];
  for (int j = 0; j < 5; ++j) k5[j] = a.taps[j];
  __syncthreads();
  for (int i = tid; i < kTile * kHaloTile; i += kThreads) {
    const int tr = i / kHaloTile, hc = i % kHaloTile;
    float acc = 0.0f;
    for (int j = 0; j < 5; ++j) acc = fmaf(k5[j], sh.cover[tr + j][hc], acc);
    sh.rows[tr][hc] = acc;
  }
  __syncthreads();
  if (r >= s || c >= s) return;
  float acc = 0.0f;
  for (int j = 0; j < 5; ++j) acc = fmaf(k5[j], sh.rows[ty][tx + j], acc);
  a.face[pixel] = acc;
}

}  // namespace

extern "C" {

// Returns a cudaError_t value: cudaErrorInvalidValue for sizes the kernel
// does not take (batch 1-65535, size 2-2048, at most 128 points and 256
// triangles a map), else the launch's.  Topology indices must lie in
// [-1, points); the kernel clamps any other into range.
int bsr_geometry_maps(const void* lm, const void* face_pts,
                      const void* uv_tris, const void* face_tris,
                      const void* reg_tris, const void* ref_pts,
                      const void* ref_tris, const void* anchors,
                      const void* uv_vals, const void* lin, const void* taps,
                      void* uv, void* reg, void* face, int batch, int size,
                      int n_lm, int n_anchor, int n_face, int t_uv,
                      int t_face, int t_reg, int t_ref, void* stream) {
  if (batch < 1 || batch > 65535 || size < 2 || size > kMaxSize ||
      n_lm < 1 || n_anchor < 0 || n_lm + n_anchor > kMaxPoints ||
      n_face < 1 || n_face > kMaxPoints || t_uv < 0 || t_face < 0 ||
      t_reg < 0 || t_ref < 0 || t_uv > kMaxTriangles ||
      t_face > kMaxTriangles || t_reg > kMaxTriangles ||
      t_ref > kMaxTriangles) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.lm = static_cast<const float*>(lm);
  a.face_pts = static_cast<const float*>(face_pts);
  a.uv_tris = static_cast<const int*>(uv_tris);
  a.face_tris = static_cast<const int*>(face_tris);
  a.reg_tris = static_cast<const int*>(reg_tris);
  a.ref_pts = static_cast<const float*>(ref_pts);
  a.ref_tris = static_cast<const int*>(ref_tris);
  a.anchors = static_cast<const float*>(anchors);
  a.uv_vals = static_cast<const float*>(uv_vals);
  a.lin = static_cast<const float*>(lin);
  a.taps = static_cast<const float*>(taps);
  a.uv = static_cast<float*>(uv);
  a.reg = static_cast<float*>(reg);
  a.face = static_cast<float*>(face);
  a.size = size;
  a.n_lm = n_lm;
  a.n_anchor = n_anchor;
  a.n_face = n_face;
  a.t_uv = t_uv;
  a.t_face = t_face;
  a.t_reg = t_reg;
  a.t_ref = t_ref;
  const int tiles = (size + kTile - 1) / kTile;
  const dim3 grid(tiles * tiles, kMaps, batch);
  geometry_maps<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* bsr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
