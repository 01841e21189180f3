// IMU propagation over one measurement group in one launch, for Hopper.
//
// Replaces the `jax.lax.scan` of fastlivo_tpu/imu.py:314 (`propagate`,
// which XLA compiles into one device program; it is not a Pallas kernel).
// For each IMU pair i of the group, in order (IMU_Processing.cpp:657-755):
//   w = gyr_i - b_g, a = acc_i * acc_scale - b_a;
//   the transition F and the process noise Q (IMU_Processing.cpp:701-717)
//   from w, a, dt and the carried rot;
//   cov <- F cov F^T + Q;
//   rot <- rot Exp(w dt), acc_w = rot a + g, then pos and vel;
//   the pose row [offs, rot9, pos3, vel3, acc_w3, w3, 0, 0].
// An invalid pair carries the state; its row holds the carried state and
// the segment-start acc / gyr. After the pairs: the world acc and body
// gyro of the last valid pair (the segment-start ones if none is valid)
// and the signed tail extrapolation to the segment end (:739-755). Outputs
// the (B+2, 24) pose pack of imu._pack_pose (row B+1 is the end state's
// pack24), the end state's rot, pos, vel and cov, and the carried acc and
// gyro, all f64.
//
// Bound: the chain of B dependent steps, not bytes or operations. A group
// of B = 32 pairs moves ~13 KB and does ~2900 f64 operations per valid
// pair (~4 ns and ~2 ns on an H100), while each pair's step needs the
// state and covariance of the one before. Design: one thread block for the
// whole chain, so no step goes through device memory. The pair inputs, the
// covariance, F's nonzero blocks and Q's stay in shared memory; thread 0
// does each pair's 3-vector and 3x3 work (two Exp, the F and Q blocks, the
// state update, the pose row) and keeps rot, pos and vel in registers; 324
// threads, one per covariance entry, form T = F cov and then T F^T + Q.
// F is the identity outside rows 0-8, with at most four nonzero 3x3 blocks
// in a row band (imu.py:240-246): only those terms are summed, in
// ascending column order, as the dense product orders them (its other
// terms are exact zeros). No atomics: the result is the same on every run
// and every rank of a mesh.
//
// Rounding follows the plain loop (imu.py::propagate_plain) operation by
// operation; built with -fmad=false, no product is contracted into an
// add. Where torch promotes there, so does this: dt^2 and the diagonal
// noise blocks are float products widened to double; a_raw * acc_scale is
// a float product widened at the bias subtraction; w dt, -I dt, the F
// blocks, 0.5 acc_w dt^2 and the accelerometer noise block are double.

#include <cuda_runtime.h>

namespace {

constexpr int D = 18;          // DIM_STATE
constexpr int NT = D * D;      // one thread per covariance entry
constexpr int MAX_PAIRS = 256;
constexpr int WC = 9;          // wire columns: acc3 gyr3 dt offs valid
constexpr int PC = 24;         // pose pack columns

// so3.exp (ops/so3.py): I + a K + b K^2 with the Taylor forms below
// t^2 = 1e-12 and t^2 clamped at 1e-14 under the root.
__device__ __forceinline__ void so3_exp(const double phi[3], double R[9]) {
  const double t2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const double t = sqrt(t2 < 9.999999999999998e-15 ? 9.999999999999998e-15 : t2);
  const bool small = t2 < 1e-12;
  const double a = small ? 1.0 - t2 / 6.0 : sin(t) / t;
  const double b = small ? 0.5 - t2 / 24.0 : (1.0 - cos(t)) / (t * t);
  const double K[9] = {0.0, -phi[2], phi[1], phi[2], 0.0, -phi[0], -phi[1], phi[0], 0.0};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const double kk = K[3 * i] * K[j] + K[3 * i + 1] * K[3 + j] + K[3 * i + 2] * K[6 + j];
      R[3 * i + j] = ((i == j ? 1.0 : 0.0) + a * K[3 * i + j]) + b * kk;
    }
  }
}

// C = A B for row-major 3x3 matrices.
__device__ __forceinline__ void mat3(const double A[9], const double B[9], double C[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
  }
}

__device__ __forceinline__ void put_row(double* row, double off, const double rot[9],
                                        const double pos[3], const double vel[3],
                                        const double acc[3], const double gyr[3]) {
  row[0] = off;
#pragma unroll
  for (int k = 0; k < 9; ++k) row[1 + k] = rot[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    row[10 + k] = pos[k];
    row[13 + k] = vel[k];
    row[16 + k] = acc[k];
    row[19 + k] = gyr[k];
  }
  row[22] = 0.0;
  row[23] = 0.0;
}

__global__ void __launch_bounds__(NT) imu_propagate_kernel(
    const float* __restrict__ wire, int B, const double* __restrict__ rot_in,
    const double* __restrict__ pos_in, const double* __restrict__ vel_in,
    const double* __restrict__ bg, const double* __restrict__ ba,
    const double* __restrict__ grav, const double* __restrict__ cov_in,
    const double* __restrict__ acc0, const double* __restrict__ gyr0,
    const float* __restrict__ acc_scale, const float* __restrict__ cov_acc,
    const float* __restrict__ cov_gyr, const float* __restrict__ cov_bias_acc,
    const float* __restrict__ cov_bias_gyr, double* __restrict__ rot_out,
    double* __restrict__ pos_out, double* __restrict__ vel_out,
    double* __restrict__ cov_out, double* __restrict__ pack,
    double* __restrict__ acc_last_out, double* __restrict__ gyr_last_out) {
  __shared__ float in_s[(MAX_PAIRS + 1) * WC];
  __shared__ double cov[NT];
  __shared__ double T[NT];
  __shared__ double Fe[9];  // F[0:3, 0:3] = Exp(-w dt)
  __shared__ double Fa[9];  // F[6:9, 0:3] = -(rot skew(a)) dt
  __shared__ double Fr[9];  // F[6:9, 12:15] = -rot dt
  __shared__ double Qa[9];  // Q[6:9, 6:9] = (rot diag(cov_acc)) rot^T dt^2
  __shared__ double Qd[9];  // diagonals of Q[0:3], Q[9:12], Q[12:15]
  __shared__ double dt_s;
  __shared__ int valid_s;

  const int tid = threadIdx.x;
  for (int k = tid; k < (B + 1) * WC; k += NT) in_s[k] = wire[k];
  cov[tid] = cov_in[tid];

  // thread 0's carried state
  double rot[9], pos[3], vel[3], acc_l[3], gyr_l[3];
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) rot[k] = rot_in[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      pos[k] = pos_in[k];
      vel[k] = vel_in[k];
      acc_l[k] = acc0[k];
      gyr_l[k] = gyr0[k];
    }
  }
  __syncthreads();
  if (tid == 0) put_row(pack, (double)in_s[B * WC + 1], rot, pos, vel, acc_l, gyr_l);

  const int i = tid / D, j = tid - (tid / D) * D;
  for (int p = 0; p < B; ++p) {
    if (tid == 0) {
      const float* in = in_s + p * WC;
      const bool valid = in[8] > 0.5f;
      double acc_w[3], w[3];
      if (valid) {
        const float dtf = in[6];
        const float dt2f = dtf * dtf;
        const double dt = (double)dtf, dt2 = (double)dt2f;
        const float scale = acc_scale[0];
        double a[3], phi[3], nphi[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          w[k] = (double)in[3 + k] - bg[k];
          a[k] = (double)(in[k] * scale) - ba[k];
          phi[k] = w[k] * dt;
          nphi[k] = -w[k] * dt;
        }
        double ef[9];
        so3_exp(phi, ef);
        so3_exp(nphi, Fe);
        const double ask[9] = {0.0, -a[2], a[1], a[2], 0.0, -a[0], -a[1], a[0], 0.0};
        double ra[9];
        mat3(rot, ask, ra);
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          Fa[k] = -ra[k] * dt;
          Fr[k] = -rot[k] * dt;
        }
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const double x0 = rot[3 * r] * (double)cov_acc[0];
          const double x1 = rot[3 * r + 1] * (double)cov_acc[1];
          const double x2 = rot[3 * r + 2] * (double)cov_acc[2];
#pragma unroll
          for (int c = 0; c < 3; ++c)
            Qa[3 * r + c] = (x0 * rot[3 * c] + x1 * rot[3 * c + 1] + x2 * rot[3 * c + 2]) * dt2;
          Qd[r] = (double)(cov_gyr[r] * dt2f);
          Qd[3 + r] = (double)(cov_bias_gyr[r] * dt2f);
          Qd[6 + r] = (double)(cov_bias_acc[r] * dt2f);
        }
        dt_s = dt;

        double rn[9];
        mat3(rot, ef, rn);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          acc_w[k] = (rn[3 * k] * a[0] + rn[3 * k + 1] * a[1] + rn[3 * k + 2] * a[2]) + grav[k];
          pos[k] = (pos[k] + vel[k] * dt) + (0.5 * acc_w[k]) * dt2;
          vel[k] = vel[k] + acc_w[k] * dt;
          acc_l[k] = acc_w[k];
          gyr_l[k] = w[k];
        }
#pragma unroll
        for (int k = 0; k < 9; ++k) rot[k] = rn[k];
      } else {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          acc_w[k] = acc0[k];
          w[k] = gyr0[k];
        }
      }
      valid_s = valid;
      put_row(pack + (size_t)(p + 1) * PC, (double)in[7], rot, pos, vel, acc_w, w);
    }
    __syncthreads();
    if (valid_s) {
      const double dt = dt_s;
      // T = F cov: row i of F against column j of cov
      const double* c = cov + j;
      double t;
      if (i < 3) {
        t = Fe[3 * i] * c[0] + Fe[3 * i + 1] * c[D] + Fe[3 * i + 2] * c[2 * D]
            + (-dt) * c[(9 + i) * D];
      } else if (i < 6) {
        t = c[i * D] + dt * c[(i + 3) * D];
      } else if (i < 9) {
        const int r = i - 6;
        t = Fa[3 * r] * c[0] + Fa[3 * r + 1] * c[D] + Fa[3 * r + 2] * c[2 * D] + c[i * D]
            + Fr[3 * r] * c[12 * D] + Fr[3 * r + 1] * c[13 * D] + Fr[3 * r + 2] * c[14 * D]
            + dt * c[(15 + r) * D];
      } else {
        t = c[i * D];
      }
      T[tid] = t;
      __syncthreads();
      // cov = T F^T + Q: row i of T against row j of F
      const double* q = T + i * D;
      double s;
      if (j < 3) {
        s = q[0] * Fe[3 * j] + q[1] * Fe[3 * j + 1] + q[2] * Fe[3 * j + 2] + q[9 + j] * (-dt);
      } else if (j < 6) {
        s = q[j] + q[j + 3] * dt;
      } else if (j < 9) {
        const int r = j - 6;
        s = q[0] * Fa[3 * r] + q[1] * Fa[3 * r + 1] + q[2] * Fa[3 * r + 2] + q[j]
            + q[12] * Fr[3 * r] + q[13] * Fr[3 * r + 1] + q[14] * Fr[3 * r + 2]
            + q[15 + r] * dt;
      } else {
        s = q[j];
      }
      if (i == j && i < 3) s = s + Qd[i];
      else if (i >= 6 && i < 9 && j >= 6 && j < 9) s = s + Qa[3 * (i - 6) + (j - 6)];
      else if (i == j && i >= 9 && i < 15) s = s + Qd[i - 6];
      cov[tid] = s;
    }
    __syncthreads();
  }

  cov_out[tid] = cov[tid];
  if (tid == 0) {
    // signed tail extrapolation to the segment end time
    const double sdt = (double)in_s[B * WC];
    const double adt = fabs(sdt);
    double phi[3], e[9], re[9];
#pragma unroll
    for (int k = 0; k < 3; ++k) phi[k] = gyr_l[k] * sdt;
    so3_exp(phi, e);
    mat3(rot, e, re);
    double* last = pack + (size_t)(B + 1) * PC;  // pack24 of the end state
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      rot_out[k] = re[k];
      last[k] = re[k];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const double pe = (pos[k] + vel[k] * sdt) + ((0.5 * acc_l[k]) * sdt) * adt;
      const double ve = vel[k] + acc_l[k] * sdt;
      pos_out[k] = pe;
      vel_out[k] = ve;
      acc_last_out[k] = acc_l[k];
      gyr_last_out[k] = gyr_l[k];
      last[9 + k] = pe;
      last[12 + k] = ve;
      last[15 + k] = bg[k];
      last[18 + k] = ba[k];
      last[21 + k] = grav[k];
    }
  }
}

}  // namespace

// wire (B+1, 9) f32 (imu.pack_pairs_wire; the last row holds tail_dt and
// row0_off); the state's rot (3, 3), pos, vel, bg, ba, grav (3,) and cov
// (18, 18), the segment-start acc and gyro (3,), all f64; the calibration's
// acc_scale () and noise vectors (3,), f32. Writes rot, pos, vel, cov, the
// (B+2, 24) pose pack and the carried acc and gyro, f64. All contiguous on
// the device; 1 <= B <= 256. Launches on `stream`; returns the launch's
// cudaError_t (0 on success).
extern "C" int imu_propagate_launch(
    const float* wire, const double* rot, const double* pos, const double* vel,
    const double* bg, const double* ba, const double* grav, const double* cov,
    const double* acc0, const double* gyr0, const float* acc_scale, const float* cov_acc,
    const float* cov_gyr, const float* cov_bias_acc, const float* cov_bias_gyr,
    double* rot_out, double* pos_out, double* vel_out, double* cov_out, double* pack,
    double* acc_last, double* gyr_last, int B, void* stream) {
  if (B < 1 || B > MAX_PAIRS) return (int)cudaErrorInvalidValue;
  imu_propagate_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(
      wire, B, rot, pos, vel, bg, ba, grav, cov, acc0, gyr0, acc_scale, cov_acc, cov_gyr,
      cov_bias_acc, cov_bias_gyr, rot_out, pos_out, vel_out, cov_out, pack, acc_last,
      gyr_last);
  return (int)cudaGetLastError();
}
