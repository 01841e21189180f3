// The plane through five picked neighbours and its gate, shared by every
// kernel that fits the LIO search's planes (knn5_plane.cu,
// knn5_plane_tiled.cu, knn5_plane_hashed.cu, lio_cascade.cu) so that they
// cannot drift apart. Two fits, as `plane_fit` selects them:
//   plane5_fit (`tls`, the default): the centred TLS plane, a
//   transcription of ops/knn_plane.py::knn5_plane_plain (itself
//   plane.sym3x3_min_eigvec): missing picks are zeros and still count as
//   points; the plane is the smallest eigenvector of the 3x3 scatter, from
//   the real acosf/cosf/sqrtf;
//   plane5_fit_ref (`ref`): the reference's A·n = -1 least-squares plane
//   in f64, a transcription of ops/plane.py::fit_plane_ref with every pick
//   counted (its `valid=None`).
// Build without --use_fast_math, and with -fmad=false so that every
// product rounds as in the plain versions, which sum in the same orders.
#pragma once

enum PlaneFit { FIT_TLS = 0, FIT_REF = 1 };

// Returns the gate "normal found and all five picks within `threshold`
// of the plane" and writes the plane (ux, uy, uz, d), +z for a
// degenerate scatter.
__device__ __forceinline__ bool plane5_fit(const float* nx, const float* ny,
                                           const float* nz, float threshold,
                                           float& ux, float& uy, float& uz,
                                           float& d) {
  const float cxm = (nx[0] + nx[1] + nx[2] + nx[3] + nx[4]) * 0.2f;
  const float cym = (ny[0] + ny[1] + ny[2] + ny[3] + ny[4]) * 0.2f;
  const float czm = (nz[0] + nz[1] + nz[2] + nz[3] + nz[4]) * 0.2f;
  float s00 = 0.f, s01 = 0.f, s02 = 0.f, s11 = 0.f, s12 = 0.f, s22 = 0.f;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const float ex = nx[k] - cxm, ey = ny[k] - cym, ez = nz[k] - czm;
    s00 += ex * ex;
    s01 += ex * ey;
    s02 += ex * ez;
    s11 += ey * ey;
    s12 += ey * ez;
    s22 += ez * ez;
  }

  // smallest eigenvector of the symmetric 3x3 scatter
  const float q = (s00 + s11 + s22) * (1.0f / 3.0f);
  const float b00 = s00 - q, b11 = s11 - q, b22 = s22 - q;
  const float p2 = b00 * b00 + b11 * b11 + b22 * b22 +
                   2.0f * (s01 * s01 + s02 * s02 + s12 * s12);
  const float p = sqrtf(fmaxf(p2 * (1.0f / 6.0f), 1e-30f));
  const float detB = (b00 * (b11 * b22 - s12 * s12) -
                      s01 * (s01 * b22 - s12 * s02) +
                      s02 * (s01 * s12 - b11 * s02)) /
                     (p * p * p);
  const float r = fminf(fmaxf(detB * 0.5f, -1.0f), 1.0f);
  const float phi = acosf(r) * (1.0f / 3.0f);
  const float lam = q + 2.0f * p * cosf(phi + 2.0943951f);  // 2*pi/3

  const float r0x = s00 - lam, r0y = s01, r0z = s02;
  const float r1x = s01, r1y = s11 - lam, r1z = s12;
  const float r2x = s02, r2y = s12, r2z = s22 - lam;
  const float c01x = r0y * r1z - r0z * r1y, c01y = r0z * r1x - r0x * r1z,
              c01z = r0x * r1y - r0y * r1x;
  const float c02x = r0y * r2z - r0z * r2y, c02y = r0z * r2x - r0x * r2z,
              c02z = r0x * r2y - r0y * r2x;
  const float c12x = r1y * r2z - r1z * r2y, c12y = r1z * r2x - r1x * r2z,
              c12z = r1x * r2y - r1y * r2x;
  const float n01 = c01x * c01x + c01y * c01y + c01z * c01z;
  const float n02 = c02x * c02x + c02y * c02y + c02z * c02z;
  const float n12 = c12x * c12x + c12y * c12y + c12z * c12z;
  const bool use01 = (n01 >= n02) && (n01 >= n12);
  const bool use02 = !use01 && (n02 >= n12);
  const float bx = use01 ? c01x : (use02 ? c02x : c12x);
  const float by = use01 ? c01y : (use02 ? c02y : c12y);
  const float bz = use01 ? c01z : (use02 ? c02z : c12z);
  const float bn = sqrtf(bx * bx + by * by + bz * bz);
  const bool okn = bn > 1e-20f;
  const float inv = 1.0f / (okn ? bn : 1.0f);
  ux = okn ? bx * inv : 0.0f;
  uy = okn ? by * inv : 0.0f;
  uz = okn ? bz * inv : 1.0f;  // degenerate fallback +z
  d = -(ux * cxm + uy * cym + uz * czm);

  bool ok = okn;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const float dist = fabsf(nx[k] * ux + ny[k] * uy + nz[k] * uz + d);
    ok = ok && (dist <= threshold);
  }
  return ok;
}

// The reference's plane through the five picks (esti_plane,
// common_lib.h:449-493), all five counted, missing ones as zeros: in f64,
// AᵀA and Aᵀb (b = -1) as sums over the picks 0..4 left to right, the
// adjugate solve of plane.py::_solve3x3 (|det| < 1e-20 taken as 1e-20),
// |n| = sqrt((x x + y y) + z z), d = 1 / max(|n|, 1e-30), the unit normal n
// d. The gate: |n| > 1e-30, a finite plane, and every pick within
// `threshold` (f64, as the plain version compares) of it, each distance
// ((x nx + y ny) + z nz) + d. Writes the plane cast down to f32.
__device__ __forceinline__ bool plane5_fit_ref(const float* px, const float* py,
                                               const float* pz, double threshold,
                                               float& ux, float& uy, float& uz,
                                               float& d) {
  double x = px[0], y = py[0], z = pz[0];
  double sxx = x * x, sxy = x * y, sxz = x * z, syy = y * y, syz = y * z, szz = z * z;
  double sx = x, sy = y, sz = z;
#pragma unroll
  for (int k = 1; k < 5; ++k) {
    x = px[k];
    y = py[k];
    z = pz[k];
    sxx = sxx + x * x;
    sxy = sxy + x * y;
    sxz = sxz + x * z;
    syy = syy + y * y;
    syz = syz + y * z;
    szz = szz + z * z;
    sx = sx + x;
    sy = sy + y;
    sz = sz + z;
  }
  const double b0 = -sx, b1 = -sy, b2 = -sz;
  // A = [[sxx, sxy, sxz], [sxy, syy, syz], [sxz, syz, szz]]: _solve3x3
  const double c00 = syy * szz - syz * syz, c01 = sxz * syz - sxy * szz,
               c02 = sxy * syz - sxz * syy;
  const double c10 = syz * sxz - sxy * szz, c11 = sxx * szz - sxz * sxz,
               c12 = sxz * sxy - sxx * syz;
  const double c20 = sxy * syz - syy * sxz, c21 = sxy * sxz - sxx * syz,
               c22 = sxx * syy - sxy * sxy;
  const double det = (sxx * c00 + sxy * c10) + sxz * c20;
  const double inv_det = 1.0 / (fabs(det) < 1e-20 ? 1e-20 : det);
  const double n0 = ((c00 * b0 + c01 * b1) + c02 * b2) * inv_det;
  const double n1 = ((c10 * b0 + c11 * b1) + c12 * b2) * inv_det;
  const double n2 = ((c20 * b0 + c21 * b1) + c22 * b2) * inv_det;
  const double norm = sqrt((n0 * n0 + n1 * n1) + n2 * n2);
  const double inv = 1.0 / (norm < 1e-30 ? 1e-30 : norm);  // a NaN stays NaN
  const double e0 = n0 * inv, e1 = n1 * inv, e2 = n2 * inv;
  bool ok = norm > 1e-30 && isfinite(e0) && isfinite(e1) && isfinite(e2) && isfinite(inv);
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const double dist =
        fabs((((double)px[k] * e0 + (double)py[k] * e1) + (double)pz[k] * e2) + inv);
    ok = ok && (dist <= threshold);
  }
  ux = (float)e0;
  uy = (float)e1;
  uz = (float)e2;
  d = (float)inv;
  return ok;
}

// The fit F (FIT_TLS: plane5_fit at the threshold cast down to f32, as
// the plain version compares its f32 distances; FIT_REF: plane5_fit_ref)
// of the picks into pl = (nx, ny, nz, d).
template <int F>
__device__ __forceinline__ bool plane5_fit_as(const float* nx, const float* ny,
                                              const float* nz, double threshold,
                                              float (&pl)[4]) {
  if constexpr (F == FIT_REF) {
    return plane5_fit_ref(nx, ny, nz, threshold, pl[0], pl[1], pl[2], pl[3]);
  } else {
    return plane5_fit(nx, ny, nz, (float)threshold, pl[0], pl[1], pl[2], pl[3]);
  }
}
