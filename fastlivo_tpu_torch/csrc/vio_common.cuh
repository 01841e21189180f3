// Device code shared by csrc/vio_select.cu and csrc/vio_observations.cu
// (the camera frame's selection and its visual-map upkeep), so that the
// two cannot drift apart: the pinhole camera with radial-tangential
// distortion (camera.py's world2cam, cam2world), the 3x3 products and
// norms in the order of ops/linalg.py (norm3, matvec3, mat3) and
// ops/photometric.py::_rows_times, vio._cam_pose, the Shi-Tomasi score of
// ops/image.py::shi_tomasi (its 8x8 box sums in `halving_sum`'s order, by
// a half-warp) and the warp's halving sum over a patch at vio._patch_sum's
// width. Each expression
// follows its plain version's order of operations (built with
// -fmad=false, every product rounds alone). Include after hash_mix.cuh
// (the voxel hash).
#pragma once

#include <math.h>
#include <stdint.h>

namespace vio {

constexpr unsigned FULL = 0xffffffffu;
constexpr int32_t EMPTY = -2147483647 - 1;  // a free voxel-hash slot (visual_map.EMPTY)

struct Cam {
  float fx, fy, cx, cy, k1, k2, p1, p2;
};

// camera.py's Camera from its 0-d device tensors fx, fy, cx, cy and d (4,)
__device__ __forceinline__ Cam load_cam(const float* fx, const float* fy, const float* cx,
                                        const float* cy, const float* d) {
  return Cam{__ldg(fx), __ldg(fy), __ldg(cx), __ldg(cy),
             __ldg(d),  __ldg(d + 1), __ldg(d + 2), __ldg(d + 3)};
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) { return min(max(x, lo), hi); }

// int32 a + b wrapping as torch's int32 tensors do
__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// y = p @ Rᵀ + t for one row p (3,) and R (3, 3) row-major:
// y_i = ((p0 R_i0 + p1 R_i1) + p2 R_i2) + t_i (_rows_times(p, R) + t)
__device__ __forceinline__ void rows_times_add(const float* p, const float* R, const float* t,
                                               float* y) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    y[i] = ((p[0] * R[3 * i] + p[1] * R[3 * i + 1]) + p[2] * R[3 * i + 2]) + t[i];
}

// vio._cam_pose: the state's rot and pos rounded to f32 (.to(f32)), then
// rcw = Rci @ rot32ᵀ and pcw = -(pos32 @ rcwᵀ) + Pci, each sum left to
// right (_rows_times); one thread
__device__ __forceinline__ void cam_pose(const double* rot, const double* pos, const float* Rci,
                                         const float* Pci, float* rcw, float* pcw) {
  float r[9], ci[9], p[3], y[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    r[k] = (float)__ldg(rot + k);
    ci[k] = __ldg(Rci + k);
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = (float)__ldg(pos + k);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      y[3 * i + j] =
          (ci[3 * i] * r[3 * j] + ci[3 * i + 1] * r[3 * j + 1]) + ci[3 * i + 2] * r[3 * j + 2];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pcw[i] = -((p[0] * y[3 * i] + p[1] * y[3 * i + 1]) + p[2] * y[3 * i + 2]) + __ldg(Pci + i);
#pragma unroll
    for (int j = 0; j < 3; ++j) rcw[3 * i + j] = y[3 * i + j];
  }
}

// the camera centre -(pcw @ rcw): c_j = -((p0 R_0j + p1 R_1j) + p2 R_2j)
__device__ __forceinline__ void campos_of(const float* R, const float* p, float* c) {
#pragma unroll
  for (int j = 0; j < 3; ++j) c[j] = -((p[0] * R[j] + p[1] * R[3 + j]) + p[2] * R[6 + j]);
}

__device__ __forceinline__ float norm3(float x, float y, float z) {
  return sqrtf((x * x + y * y) + z * z);
}

// camera.distort on normalized coordinates
__device__ __forceinline__ void distort(const Cam& c, float x, float y, float& xd, float& yd) {
  const float r2 = x * x + y * y;
  const float radial = (1.0f + c.k1 * r2) + (c.k2 * r2) * r2;
  xd = (x * radial + ((2.0f * c.p1) * x) * y) + c.p2 * (r2 + (2.0f * x) * x);
  yd = (y * radial + c.p1 * (r2 + (2.0f * y) * y)) + ((2.0f * c.p2) * x) * y;
}

// camera.world2cam: camera-frame point -> distorted pixel (no z check)
__device__ __forceinline__ void world2cam(const Cam& c, const float* p, float& u, float& v) {
  const float xn = p[0] / p[2];
  const float yn = p[1] / p[2];
  float xd, yd;
  distort(c, xn, yn, xd, yd);
  u = c.fx * xd + c.cx;
  v = c.fy * yd + c.cy;
}

// camera.cam2world: pixel -> unit bearing (the 8-step undistortion)
__device__ __forceinline__ void cam2world(const Cam& c, float pu, float pv, float* f) {
  const float xd = (pu - c.cx) / c.fx;
  const float yd = (pv - c.cy) / c.fy;
  float xn = xd, yn = yd;
  for (int k = 0; k < 8; ++k) {
    float dx, dy;
    distort(c, xn, yn, dx, dy);
    const float nx = xd - (dx - xn);
    const float ny = yd - (dy - yn);
    xn = nx;
    yn = ny;
  }
  const float nrm = sqrtf((xn * xn + yn * yn) + 1.0f);
  f[0] = xn / nrm;
  f[1] = yn / nrm;
  f[2] = 1.0f / nrm;
}

// camera.is_in_frame with the truncation to int
__device__ __forceinline__ bool in_frame(float u, float v, int W, int H, int border) {
  const int ui = (int)u, vi = (int)v;
  return ui >= border && ui < W - border && vi >= border && vi < H - border;
}

// vio._cells: int(u * (1/grid)) * gh + int(v * (1/grid)), clamped to the
// grid (the products in int32, wrapping)
__device__ __forceinline__ int cell_of(float u, float v, float inv_grid, int gh, int G) {
  const int32_t cu = (int32_t)(u * inv_grid), cv = (int32_t)(v * inv_grid);
  return clampi((int32_t)((uint32_t)cu * (uint32_t)gh + (uint32_t)cv), 0, G - 1);
}

// image.halving_sum at width NW (64, 128 or 256: vio._patch_sum's width)
// over NW values held NW / 32 a lane (x[h] = value lane + 32 h, zeros
// past the patch), summed in the tree's order: the levels above 32 in the
// lane (x[h] + x[h + n / 2] while n > 1: at 64 x0 + x1, at 128 (x0 + x2) +
// (x1 + x3), at 256 ((x0 + x4) + (x2 + x6)) + ((x1 + x5) + (x3 + x7))),
// then the warp's shuffle tree; every lane gets the sum
template <int NW>
__device__ __forceinline__ float warp_tree(const float (&x)[NW / 32]) {
  static_assert(NW == 64 || NW == 128 || NW == 256, "a tree of 64, 128 or 256 values");
  float y[NW / 32];
#pragma unroll
  for (int h = 0; h < NW / 32; ++h) y[h] = x[h];
#pragma unroll
  for (int n = NW / 32; n > 1; n >>= 1)
#pragma unroll
    for (int h = 0; h < n / 2; ++h) y[h] = y[h] + y[h + n / 2];
  float s = y[0];
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) s = s + __shfl_down_sync(FULL, s, off);
  return __shfl_sync(FULL, s, 0);
}

// image.halving_sum over 64 values held four a lane of a half-warp
// (x[hl + 16 h], h = 0..3; hmask its lanes), summed in the tree's order
// (the first two levels in the lane: (x[i] + x[i + 32]) + (x[i + 16] +
// x[i + 48])); every lane of the half gets the sum
__device__ __forceinline__ float half_tree64(float a0, float a1, float a2, float a3,
                                             unsigned hmask) {
  float s = (a0 + a2) + (a1 + a3);
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1) s = s + __shfl_down_sync(hmask, s, off, 16);
  return __shfl_sync(hmask, s, 0, 16);
}

// image.shi_tomasi at floor(pu, pv), by the 16 lanes of a half-warp: lane
// hl takes the taps hl + 16 h, h = 0..3, of the 8x8 window rooted at
// (v - 4, u - 4) (row-major, every index clamped); every lane of the half
// gets the score
__device__ __forceinline__ float shi_tomasi_half(const float* __restrict__ img, int H, int W,
                                                 float pu, float pv, int hl, unsigned hmask) {
  const int u = clampi((int)floorf(pu), 0, W - 1);
  const int v = clampi((int)floorf(pv), 0, H - 1);
  float gx[4], gy[4];
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int t = hl + 16 * h;
    const int r = clampi(v - 4 + (t >> 3), 0, H - 1);
    const int c = clampi(u - 4 + (t & 7), 0, W - 1);
    const float* row = img + (size_t)r * W;
    gx[h] = 0.5f * (__ldg(row + min(c + 1, W - 1)) - __ldg(row + max(c - 1, 0)));
    gy[h] = 0.5f * (__ldg(img + (size_t)min(r + 1, H - 1) * W + c) -
                    __ldg(img + (size_t)max(r - 1, 0) * W + c));
  }
  const float xx = half_tree64(gx[0] * gx[0], gx[1] * gx[1], gx[2] * gx[2], gx[3] * gx[3],
                               hmask) * 0.03125f;
  const float yy = half_tree64(gy[0] * gy[0], gy[1] * gy[1], gy[2] * gy[2], gy[3] * gy[3],
                               hmask) * 0.03125f;
  const float xy = half_tree64(gx[0] * gy[0], gx[1] * gy[1], gx[2] * gy[2], gx[3] * gy[3],
                               hmask) * 0.03125f;
  const float tr = xx + yy;
  const float det = xx * yy - xy * xy;
  const float disc = sqrtf(clamp_min(tr * tr - 4.0f * det, 0.0f));
  return 0.5f * (tr - disc);
}

// torch.argmax's order over (value, index): NaN above everything, then
// the larger value, then the lower index
__device__ __forceinline__ bool beats(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na || nb) return na && nb ? ia < ib : na;
  return a > b || (a == b && ia < ib);
}

// the warp's argmax over one (value, index) a lane; every lane gets it
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, v, off);
    const int oi = __shfl_xor_sync(FULL, i, off);
    if (beats(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// voxel_map._slot_check: the probe slot and the 31-bit verification hash
__device__ __forceinline__ void slot_check(int32_t x, int32_t y, int32_t z, int tmask,
                                           int& slot, int32_t& check) {
  const uint32_t h = mix3(x, y, z);
  slot = (int32_t)(h >> 13) & tmask;
  check = (int32_t)(h & 0x7FFFFFFFu);
}

}  // namespace vio
