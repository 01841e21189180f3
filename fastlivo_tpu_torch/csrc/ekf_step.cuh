// The prior-anchored f64 step of the iterated EKFs, in one warp's
// registers, shared by csrc/photometric_cascade.cu (the photometric
// cascade and the step alone) and csrc/lio_cascade.cu (the LIO cascade),
// so that the kernels cannot drift apart. The step is the photometric form
// (lidar_selection.cpp:861-878): K = P'[:, :6] (HᵀH₆ P'[:6, :6] + I₆)⁻¹
// by a 6x6 Gauss-Jordan with partial pivoting, vec = [Log(rotᵀ
// prior.rot), prior_x - x], sol = vec - K (Hᵀz + HᵀH₆ vec[:6]), rot' = rot
// Exp(sol[:3]), x' = x + sol[3:], G = K HᵀH₆ and the two convergence
// norms, all f64. The LIO step (laserMapping.cpp:1663-1683, sol = vec + K
// (Hᵀz - HᵀH₆ vec[:6])) is this one fed -Hᵀz: a negation is exact, so it
// gives the LIO step's bits. Include after so3.cuh (so3_log, so3_exp,
// mat3).
//
// Who computes what: vec reads only the pose and the prior, so step_vec
// runs in a warp of its own while the grid measures; step_warp keeps
// column c of [Aᵀ | P'[:, :6]ᵀ] in lane c's registers (c < 24), each pivot
// is found by the lane that owns its column and broadcast with a shuffle
// (the row swap a register select), and every lane divides and eliminates
// its own column, with no shared memory and no warp barrier inside the
// elimination; the lanes that end holding K's rows form sol, and G = K
// HᵀH₆, needed for the output only, is formed by step_gain from the gain
// the step left in its slot. Every expression is evaluated in the order
// of the plain version (ops/photometric.py::photometric_step_plain, whose
// elimination is ops/linalg.py::gj_solve6), built with -fmad=false.
#pragma once

namespace {

constexpr int DS = 18;      // DIM_STATE
constexpr int NX = 15;      // x = [pos, vel, bg, ba, grav]
constexpr int EKF_NH = 42;  // [HᵀH₆ | Hᵀz], 6 x 7 row-major
constexpr unsigned STEP_LANES = 0xffffffffu;

// The step's results in shared memory.
struct Step {
  double vec[DS];       // [Log(rotᵀ prior.rot), prior_x - x] (step_vec)
  double nrot[9];       // rot'
  double nx[NX];        // x'
  double K[2][DS][6];   // the gain of a step, by slot (step_gain)
  double H[2][36];      // its HᵀH₆
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

// One warp (every lane calls): vec for the pose (rot, x) into `vec`, Log
// on lane 0. The caller makes it visible (a barrier) before step_warp.
__device__ __forceinline__ void step_vec(const Prior& pr, const double* rot, const double* x,
                                         double* vec, int lane) {
  if (lane == 0) {  // Log(rotᵀ prior.rot)
    double R[9];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        R[3 * i + j] = rot[i] * pr.rot[j] + rot[3 + i] * pr.rot[3 + j]
                       + rot[6 + i] * pr.rot[6 + j];
    }
    so3_log(R, vec);
  }
  if (lane < NX) vec[3 + lane] = pr.x[lane] - x[lane];
}

// One warp (every lane calls): the prior-anchored step from the pose
// (rot, x) with HT = [HᵀH₆ | Hᵀz] (42 f32, row-major (6, 7)), the prior
// `pr` and s.vec of step_vec for the same pose, converged when
// |sol[:3]|·57.3 < conv_rot_deg and |sol[3:6]|·100 < conv_pos_cm. Leaves
// rot', x' and conv in s, and the gain K and HᵀH₆ in slot `slot` for
// step_gain. Ends with a warp barrier.
__device__ void step_warp(const Prior& pr, const double* rot, const double* x,
                          const float* HT, Step& s, int lane, double conv_rot_deg,
                          double conv_pos_cm, int slot) {
  const double* Pp = pr.P;
  // t = Hᵀz + HᵀH₆ vec[:6], in every lane: no dependence on the elimination
  double t[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    double v = (double)HT[7 * i] * s.vec[0];
#pragma unroll
    for (int k = 1; k < 6; ++k) v = v + (double)HT[7 * i + k] * s.vec[k];
    t[i] = (double)HT[7 * i + 6] + v;
  }
  // lane c's column of aug = [Aᵀ | P'[:, :6]ᵀ], A = HᵀH₆ P'[:6, :6] + I₆
  // (lanes 24-31 repeat column 23 and their results are never read)
  const int c = lane < 24 ? lane : 23;
  double a[6];
  if (c < 6) {  // a[r] = aug[r][c] = A[c][r]
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      double v = (double)HT[7 * c] * Pp[r];
#pragma unroll
      for (int k = 1; k < 6; ++k) v = v + (double)HT[7 * c + k] * Pp[DS * k + r];
      if (c == r) v = v + 1.0;
      a[r] = v;
    }
  } else {
#pragma unroll
    for (int r = 0; r < 6; ++r) a[r] = Pp[DS * (c - 6) + r];
  }
  // Gauss-Jordan with partial pivoting (gj_solve): the first row of the
  // largest |entry| at or below the diagonal, the row divided by its
  // pivot, then every other row less its factor times that row
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    double best = -2.0;
    int p = 0;
#pragma unroll
    for (int r = 0; r < 6; ++r) {
      const double v = r >= k ? fabs(a[r]) : -1.0;
      if (v > best) {
        best = v;
        p = r;
      }
    }
    p = __shfl_sync(STEP_LANES, p, k);  // column k's lane found it
    double ap = a[0];
#pragma unroll
    for (int r = 1; r < 6; ++r) ap = r == p ? a[r] : ap;
    const double ak = a[k];
#pragma unroll
    for (int r = 0; r < 6; ++r)
      if (r != k && r == p) a[r] = ak;
    a[k] = ap;
    double fac[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) fac[r] = __shfl_sync(STEP_LANES, a[r], k);  // fac[k]: the pivot
    a[k] = a[k] / fac[k];
#pragma unroll
    for (int r = 0; r < 6; ++r)
      if (r != k) a[r] = a[r] - fac[r] * a[k];
  }
  // lane 6 + j now holds K[j][:] (K[j][i] = aug[i][6 + j]): sol[j] = vec[j]
  // - K[j] t
  const int j = c < 6 ? 0 : c - 6;
  double v = a[0] * t[0];
#pragma unroll
  for (int i = 1; i < 6; ++i) v = v + a[i] * t[i];
  const double sol = s.vec[j] - v;
  if (lane >= 6 && lane < 24) {
#pragma unroll
    for (int i = 0; i < 6; ++i) s.K[slot][j][i] = a[i];
  }
  for (int e = lane; e < 36; e += 32) s.H[slot][e] = (double)HT[7 * (e / 6) + e % 6];
  double sv[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) sv[i] = __shfl_sync(STEP_LANES, sol, 6 + i);
  if (lane >= 9 && lane < 24) s.nx[lane - 9] = x[lane - 9] + sol;
  if (lane == 0) {  // rot' = rot Exp(sol[:3])
    double E[9];
    so3_exp(sv, E);
    mat3(rot, E, s.nrot);
    const double nr = sqrt(sv[0] * sv[0] + sv[1] * sv[1] + sv[2] * sv[2]);
    const double np = sqrt(sv[3] * sv[3] + sv[4] * sv[4] + sv[5] * sv[5]);
    s.conv = (nr * 57.3 < conv_rot_deg) && (np * 100.0 < conv_pos_cm);
  }
  __syncwarp();
}

// G = K HᵀH₆ (18, 6) of the step that left its gain in `slot`, by threads
// t0, t0 + nt, ... into G (row-major).
__device__ __forceinline__ void step_gain(const Step& s, int slot, double* G, int t0, int nt) {
  for (int e = t0; e < DS * 6; e += nt) {
    const int c = e / 6, jj = e - (e / 6) * 6;
    double v = s.K[slot][c][0] * s.H[slot][jj];
    for (int i = 1; i < 6; ++i) v = v + s.K[slot][c][i] * s.H[slot][6 * i + jj];
    G[e] = v;
  }
}

}  // namespace
