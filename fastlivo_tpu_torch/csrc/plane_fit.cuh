// The centred TLS plane through five picked neighbours and its gate,
// shared by csrc/knn5_plane.cu and csrc/knn5_plane_tiled.cu so that the
// two kernels cannot drift apart. A transcription of
// ops/knn_plane.py::knn5_plane_plain (itself plane.sym3x3_min_eigvec):
// missing picks are zeros and still count as points; the plane is the
// smallest eigenvector of the 3x3 scatter, from the real acosf/cosf/sqrtf
// (build without --use_fast_math, and with -fmad=false so that every
// product rounds as in the plain version, which sums in the same order).
#pragma once

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
