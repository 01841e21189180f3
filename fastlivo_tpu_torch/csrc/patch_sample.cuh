// Patch sampling shared by csrc/patches_and_grads.cu and
// csrc/photometric_err_H.cu, so that the two kernels cannot drift apart:
// the anchor and bilinear weights of ops/image.py::_anchor_weights, the
// (P+3)x(P+3) clamped tap grid of `_tap_grid`, and the bilinear samples
// and centred differences of `patches_and_grads`, each evaluated in the
// plain version's order of operations (built with -fmad=false, every
// product rounds as there). The taps are read through a view: the grid
// staged in shared memory (StagedTaps), or, where (P+3)^2 floats would
// not fit there, read in place from the image with the same clamping
// (ImageTaps); both give the same values.
#pragma once

#include <stdint.h>

struct PatchAnchor {
  int32_t u_i, v_i;              // integer anchor floor(px / s) * s
  float sf;                      // the scale s as float
  float w_tl, w_tr, w_bl, w_br;  // bilinear weights of the remainder
};

__device__ __forceinline__ PatchAnchor patch_anchor(float u, float v, int s) {
  PatchAnchor a;
  a.sf = (float)s;
  // int32 arithmetic wraps as the plain version's does
  a.u_i = (int32_t)((uint32_t)(int32_t)floorf(u / a.sf) * (uint32_t)s);
  a.v_i = (int32_t)((uint32_t)(int32_t)floorf(v / a.sf) * (uint32_t)s);
  const float su = (u - (float)a.u_i) / a.sf;
  const float sv = (v - (float)a.v_i) / a.sf;
  a.w_tl = (1.0f - su) * (1.0f - sv);
  a.w_tr = su * (1.0f - sv);
  a.w_bl = (1.0f - su) * sv;
  a.w_br = su * sv;
  return a;
}

// Tap (e, f) of the n x n grid (n = P + 3): img[v_i + (e - origin) * s,
// u_i + (f - origin) * s], origin = P/2 + 1, each index clamped to the
// image.
__device__ __forceinline__ float image_tap(const float* __restrict__ img, int H, int W,
                                           const PatchAnchor& a, int s, int origin, int e,
                                           int f) {
  int r = (int32_t)((uint32_t)a.v_i + (uint32_t)(e - origin) * (uint32_t)s);
  int c = (int32_t)((uint32_t)a.u_i + (uint32_t)(f - origin) * (uint32_t)s);
  r = min(max(r, 0), H - 1);
  c = min(max(c, 0), W - 1);
  return __ldg(img + (size_t)r * W + c);
}

// Threads t0, t0 + nt, ... load the n x n taps into taps[e * n + f].
__device__ __forceinline__ void load_taps(const float* __restrict__ img, int H,
                                          int W, const PatchAnchor& a, int s,
                                          int P, float* taps, int t0, int nt) {
  const int n = P + 3;
  const int origin = P / 2 + 1;
  for (int t = t0; t < n * n; t += nt) {
    const int e = t / n;
    taps[t] = image_tap(img, H, W, a, s, origin, e, t - e * n);
  }
}

// The taps staged by load_taps (shared memory).
struct StagedTaps {
  const float* taps;
  int n;
  __device__ __forceinline__ float at(int e, int f) const { return taps[e * n + f]; }
};

// The taps read in place from the image.
struct ImageTaps {
  const float* img;
  int H, W, s, origin;
  PatchAnchor a;
  __device__ __forceinline__ float at(int e, int f) const {
    return image_tap(img, H, W, a, s, origin, e, f);
  }
};

// The bilinear sample of patch pixel (x, y) (row x over v, column y over
// u) at stride offsets (da, db) in {-1, 0, 1}; the grid's origin is at 1.
template <class Taps>
__device__ __forceinline__ float patch_sample(const Taps& q, const PatchAnchor& a, int x,
                                              int y, int da, int db) {
  const int e = 1 + da + x, f = 1 + db + y;
  float acc = a.w_tl * q.at(e, f);
  acc = acc + a.w_tr * q.at(e, f + 1);
  acc = acc + a.w_bl * q.at(e + 1, f);
  acc = acc + a.w_br * q.at(e + 1, f + 1);
  return acc;
}

// val, du = 0.5 * (I(+s) - I(-s)) / s along u, and dv along v, at patch
// pixel (x, y).
template <class Taps>
__device__ __forceinline__ void patch_val_grad(const Taps& q, const PatchAnchor& a, int x,
                                               int y, float& val, float& du, float& dv) {
  val = patch_sample(q, a, x, y, 0, 0);
  du = 0.5f * (patch_sample(q, a, x, y, 0, 1) - patch_sample(q, a, x, y, 0, -1)) / a.sf;
  dv = 0.5f * (patch_sample(q, a, x, y, 1, 0) - patch_sample(q, a, x, y, -1, 0)) / a.sf;
}

// Whether a block stages the (P+3)^2 taps in shared memory (at most 32
// KB of floats, P <= 87) or reads them in place from the image.
__host__ __device__ constexpr bool taps_staged(int P) { return (P + 3) * (P + 3) <= 8192; }
