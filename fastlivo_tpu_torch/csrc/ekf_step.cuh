// The prior-anchored f64 step of the iterated EKFs, in one warp, shared by
// csrc/photometric_cascade.cu (the photometric cascade and the step alone)
// and csrc/lio_cascade.cu (the LIO cascade), so that the kernels cannot
// drift apart. The step is the photometric form (lidar_selection.cpp:
// 861-878): K = P'[:, :6] (HᵀH₆ P'[:6, :6] + I₆)⁻¹ by a 6x6 Gauss-Jordan
// with partial pivoting, vec = [Log(rotᵀ prior.rot), prior_x - x],
// sol = vec - K (Hᵀz + HᵀH₆ vec[:6]), rot' = rot Exp(sol[:3]),
// x' = x + sol[3:], G = K HᵀH₆ and the two convergence norms, all f64. The
// LIO step (laserMapping.cpp:1663-1683, sol = vec + K (Hᵀz - HᵀH₆
// vec[:6])) is this one fed -Hᵀz: a negation is exact, so it gives the
// LIO step's bits. Include after so3.cuh (so3_log, so3_exp, mat3).
#pragma once

namespace {

constexpr int DS = 18;      // DIM_STATE
constexpr int NX = 15;      // x = [pos, vel, bg, ba, grav]
constexpr int EKF_NH = 42;  // [HᵀH₆ | Hᵀz], 6 x 7 row-major

// The step's working set, in shared memory.
struct Step {
  double H[36];      // HᵀH₆, f64
  double z[6];       // Hᵀz, f64
  double aug[6][24];  // [Aᵀ | P'[:, :6]ᵀ], eliminated to [I | Kᵀ]
  double fac[6];
  double vec[DS];
  double t[6];
  double sol[DS];
  double nrot[9];
  double nx[NX];
  double G[DS][6];   // K HᵀH₆
  int piv;
  int conv;
};

// P' (18, 18), the prior's rot (3, 3) and x (15,), in shared memory.
struct Prior {
  double P[DS * DS];
  double rot[9];
  double x[NX];
};

// Threads t0, t0 + nt, ... copy the prior into shared memory (one pass of
// independent loads), then a block barrier.
__device__ __forceinline__ void load_prior(const double* __restrict__ Pp,
                                           const double* __restrict__ prior_rot,
                                           const double* __restrict__ prior_x, Prior& pr,
                                           int t0, int nt) {
  for (int e = t0; e < DS * DS + 9 + NX; e += nt) {
    if (e < DS * DS) pr.P[e] = Pp[e];
    else if (e < DS * DS + 9) pr.rot[e - DS * DS] = prior_rot[e - DS * DS];
    else pr.x[e - DS * DS - 9] = prior_x[e - DS * DS - 9];
  }
  __syncthreads();
}

// One warp (every lane calls): the prior-anchored step from the pose
// (rot, x) with HT = [HᵀH₆ | Hᵀz] (42 f32, row-major (6, 7)) and the prior
// `pr`, converged when |sol[:3]|·57.3 < conv_rot_deg and |sol[3:6]|·100 <
// conv_pos_cm. Leaves rot', x', conv and G in s.
__device__ void step_warp(const Prior& pr, const double* rot, const double* x,
                          const float* HT, Step& s, int lane, double conv_rot_deg,
                          double conv_pos_cm) {
  const double* Pp = pr.P;
  const double* prior_rot = pr.rot;
  const double* prior_x = pr.x;
  for (int e = lane; e < EKF_NH; e += 32) {
    const int r = e / 7, c = e - (e / 7) * 7;
    const double v = (double)HT[e];
    if (c < 6) s.H[6 * r + c] = v;
    else s.z[r] = v;
  }
  __syncwarp();
  // A = HᵀH₆ P'[:6, :6] + I₆; the system Aᵀ Kᵀ = P'[:, :6]ᵀ
  for (int e = lane; e < 6 * 24; e += 32) {
    const int r = e / 24, c = e - (e / 24) * 24;
    double v;
    if (c < 6) {  // aug[r][c] = A[c][r]
      v = s.H[6 * c] * Pp[r];
      for (int k = 1; k < 6; ++k) v = v + s.H[6 * c + k] * Pp[DS * k + r];
      if (c == r) v = v + 1.0;
    } else {
      v = Pp[DS * (c - 6) + r];
    }
    s.aug[r][c] = v;
  }
  __syncwarp();
  // Gauss-Jordan with partial pivoting (gj_solve): the first row of the
  // largest |entry| at or below the diagonal, the row divided by its
  // pivot, then every other row less its factor times that row
  for (int k = 0; k < 6; ++k) {
    if (lane == 0) {
      double best = -2.0;
      int p = 0;
      for (int r = 0; r < 6; ++r) {
        const double v = r >= k ? fabs(s.aug[r][k]) : -1.0;
        if (v > best) {
          best = v;
          p = r;
        }
      }
      s.piv = p;
    }
    __syncwarp();
    const int p = s.piv;
    if (p != k && lane < 24) {
      const double tk = s.aug[k][lane];
      s.aug[k][lane] = s.aug[p][lane];
      s.aug[p][lane] = tk;
    }
    __syncwarp();
    const double piv = s.aug[k][k];
    __syncwarp();
    if (lane < 24) s.aug[k][lane] = s.aug[k][lane] / piv;
    if (lane < 6) s.fac[lane] = lane == k ? 0.0 : s.aug[lane][k];
    __syncwarp();
    for (int e = lane; e < 6 * 24; e += 32) {
      const int r = e / 24, c = e - (e / 24) * 24;
      if (r != k) s.aug[r][c] = s.aug[r][c] - s.fac[r] * s.aug[k][c];
    }
    __syncwarp();
  }
  // K[c][i] = aug[i][6 + c]
  if (lane == 0) {  // Log(rotᵀ prior.rot)
    double R[9];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        R[3 * i + j] = rot[i] * prior_rot[j] + rot[3 + i] * prior_rot[3 + j]
                       + rot[6 + i] * prior_rot[6 + j];
    }
    so3_log(R, s.vec);
  }
  if (lane < NX) s.vec[3 + lane] = prior_x[lane] - x[lane];
  __syncwarp();
  if (lane < 6) {  // Hᵀz + HᵀH₆ vec[:6]
    double v = s.H[6 * lane] * s.vec[0];
    for (int k = 1; k < 6; ++k) v = v + s.H[6 * lane + k] * s.vec[k];
    s.t[lane] = s.z[lane] + v;
  }
  __syncwarp();
  if (lane < DS) {  // sol = vec - K t
    double v = s.aug[0][6 + lane] * s.t[0];
    for (int i = 1; i < 6; ++i) v = v + s.aug[i][6 + lane] * s.t[i];
    s.sol[lane] = s.vec[lane] - v;
  }
  for (int e = lane; e < DS * 6; e += 32) {  // G = K HᵀH₆
    const int c = e / 6, j = e - (e / 6) * 6;
    double v = s.aug[0][6 + c] * s.H[j];
    for (int i = 1; i < 6; ++i) v = v + s.aug[i][6 + c] * s.H[6 * i + j];
    s.G[c][j] = v;
  }
  __syncwarp();
  if (lane == 0) {
    double E[9];
    so3_exp(s.sol, E);
    mat3(rot, E, s.nrot);
    const double nr = sqrt(s.sol[0] * s.sol[0] + s.sol[1] * s.sol[1] + s.sol[2] * s.sol[2]);
    const double np = sqrt(s.sol[3] * s.sol[3] + s.sol[4] * s.sol[4] + s.sol[5] * s.sol[5]);
    s.conv = (nr * 57.3 < conv_rot_deg) && (np * 100.0 < conv_pos_cm);
  }
  if (lane < NX) s.nx[lane] = x[lane] + s.sol[3 + lane];
  __syncwarp();
}

}  // namespace
