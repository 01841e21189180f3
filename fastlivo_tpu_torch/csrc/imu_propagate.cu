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
// gyro, all f64. Any B >= 1: the wire is read from device memory.
//
// Bound: the chain of B dependent steps, not bytes or operations. A group
// of B = 32 pairs moves ~13 KB and does ~2900 f64 operations per valid
// pair (~4 ns and ~2 ns on an H100), while each pair's step needs the
// state and covariance of the one before. Design: one thread block for the
// whole chain, so no step goes through device memory, and as little as
// possible of each step on the chain. Most of a pair's work depends only
// on the wire and the biases: w, a, dt, dt^2, Exp(w dt), Exp(-w dt) (F's
// first block) and Q's diagonal blocks. The block walks the wire in chunks
// of C pairs, four stages each:
//   1. one thread per pair forms those terms from its 9 wire floats;
//   2. thread 0 runs the carried chain over the chunk's valid pairs:
//      rot <- rot Exp(w dt) (a 3x3 product), acc_w, pos, vel; each pair's
//      rot, pos, vel and acc_w land in shared memory;
//   3. one thread per pair forms F's rot-dependent blocks and Q's
//      accelerometer block from the rot its pair started from, and writes
//      its pose row;
//   4. 324 threads, one per covariance entry, form T = F cov and then
//      T F^T + Q for each valid pair in turn (two barriers per valid pair;
//      an invalid pair costs nothing). T is stored transposed and the
//      second product takes its entries column by column, so that each
//      product branches on F's row band once per warp, not per thread
//      (13-20% faster than the row-major second product at B = 8 to 512
//      on an NVIDIA H100 80GB HBM3, 700.00 W; scripts/torch_imu_bench.py).
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

#include "so3.cuh"

namespace {

constexpr int D = 18;   // DIM_STATE
constexpr int NT = D * D;  // one thread per covariance entry
constexpr int C = 64;   // pairs per chunk
constexpr int WC = 9;   // wire columns: acc3 gyr3 dt offs valid
constexpr int PC = 24;  // pose pack columns

// Per-pair terms of one chunk, in shared memory.
struct Chunk {
  double dt[C], dt2[C];
  double w[C][3], a[C][3];
  double ef[C][9];   // Exp(w dt)
  double Fe[C][9];   // F[0:3, 0:3] = Exp(-w dt)
  double Qd[C][9];   // diagonals of Q[0:3], Q[9:12], Q[12:15]
  double rot[C][9];  // the carried state after the pair
  double pos[C][3], vel[C][3], acc[C][3];
  double Fa[C][9];   // F[6:9, 0:3] = -(rot skew(a)) dt
  double Fr[C][9];   // F[6:9, 12:15] = -rot dt
  double Qa[C][9];   // Q[6:9, 6:9] = (rot diag(cov_acc)) rot^T dt^2
  int valid[C];
};

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
  __shared__ Chunk ch;
  __shared__ double cov[NT];
  __shared__ double T[NT];
  __shared__ double rot0[9];  // the carried rot at the chunk's start

  const int tid = threadIdx.x;
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
    put_row(pack, (double)wire[B * WC + 1], rot, pos, vel, acc_l, gyr_l);
  }

  const int i = tid / D, j = tid - (tid / D) * D;
  for (int p0 = 0; p0 < B; p0 += C) {
    const int nc = min(C, B - p0);

    // 1. the pair's state-free terms
    if (tid < nc) {
      const int p = tid;
      const float* in = wire + (size_t)(p0 + p) * WC;
      const bool valid = in[8] > 0.5f;
      ch.valid[p] = valid;
      if (valid) {
        const float dtf = in[6];
        const float dt2f = dtf * dtf;
        const double dt = (double)dtf;
        const float scale = acc_scale[0];
        double phi[3], nphi[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const double w = (double)in[3 + k] - bg[k];
          ch.w[p][k] = w;
          ch.a[p][k] = (double)(in[k] * scale) - ba[k];
          phi[k] = w * dt;
          nphi[k] = -w * dt;
        }
        so3_exp(phi, ch.ef[p]);
        so3_exp(nphi, ch.Fe[p]);
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          ch.Qd[p][r] = (double)(cov_gyr[r] * dt2f);
          ch.Qd[p][3 + r] = (double)(cov_bias_gyr[r] * dt2f);
          ch.Qd[p][6 + r] = (double)(cov_bias_acc[r] * dt2f);
        }
        ch.dt[p] = dt;
        ch.dt2[p] = (double)dt2f;
      }
    }
    __syncthreads();

    // 2. the carried chain
    if (tid == 0) {
#pragma unroll
      for (int k = 0; k < 9; ++k) rot0[k] = rot[k];
      for (int p = 0; p < nc; ++p) {
        if (ch.valid[p]) {
          const double dt = ch.dt[p], dt2 = ch.dt2[p];
          const double* a = ch.a[p];
          double rn[9];
          mat3(rot, ch.ef[p], rn);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const double acc_w =
                (rn[3 * k] * a[0] + rn[3 * k + 1] * a[1] + rn[3 * k + 2] * a[2]) + grav[k];
            pos[k] = (pos[k] + vel[k] * dt) + (0.5 * acc_w) * dt2;
            vel[k] = vel[k] + acc_w * dt;
            acc_l[k] = acc_w;
            gyr_l[k] = ch.w[p][k];
            ch.acc[p][k] = acc_w;
          }
#pragma unroll
          for (int k = 0; k < 9; ++k) rot[k] = rn[k];
        }
#pragma unroll
        for (int k = 0; k < 9; ++k) ch.rot[p][k] = rot[k];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          ch.pos[p][k] = pos[k];
          ch.vel[p][k] = vel[k];
        }
      }
    }
    __syncthreads();

    // 3. F's and Q's rot-dependent blocks from the pair's starting rot;
    // the pose row
    if (tid < nc) {
      const int p = tid;
      const double* rs = p == 0 ? rot0 : ch.rot[p - 1];
      const double off = (double)wire[(size_t)(p0 + p) * WC + 7];
      double* row = pack + (size_t)(p0 + p + 1) * PC;
      if (ch.valid[p]) {
        const double dt = ch.dt[p], dt2 = ch.dt2[p];
        const double* a = ch.a[p];
        const double ask[9] = {0.0, -a[2], a[1], a[2], 0.0, -a[0], -a[1], a[0], 0.0};
        double ra[9];
        mat3(rs, ask, ra);
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          ch.Fa[p][k] = -ra[k] * dt;
          ch.Fr[p][k] = -rs[k] * dt;
        }
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const double x0 = rs[3 * r] * (double)cov_acc[0];
          const double x1 = rs[3 * r + 1] * (double)cov_acc[1];
          const double x2 = rs[3 * r + 2] * (double)cov_acc[2];
#pragma unroll
          for (int c = 0; c < 3; ++c)
            ch.Qa[p][3 * r + c] = (x0 * rs[3 * c] + x1 * rs[3 * c + 1] + x2 * rs[3 * c + 2]) * dt2;
        }
        put_row(row, off, ch.rot[p], ch.pos[p], ch.vel[p], ch.acc[p], ch.w[p]);
      } else {
        put_row(row, off, ch.rot[p], ch.pos[p], ch.vel[p], acc0, gyr0);
      }
    }
    __syncthreads();

    // 4. the covariance chain over the chunk's valid pairs
    for (int p = 0; p < nc; ++p) {
      if (!ch.valid[p]) continue;  // uniform: every thread reads the same flag
      const double dt = ch.dt[p];
      const double* Fe = ch.Fe[p];
      const double* Fa = ch.Fa[p];
      const double* Fr = ch.Fr[p];
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
      T[j * D + i] = t;  // transposed: the second product's reads are unit-stride
      __syncthreads();
      // cov = T F^T + Q, entry (i2, j2) with j2 = tid / D: the branch on
      // j2 is uniform in most warps
      {
        const int j2 = i, i2 = j;
        const double* q = T + i2;  // q[k * D] = T[i2][k]
        double s;
        if (j2 < 3) {
          s = q[0] * Fe[3 * j2] + q[D] * Fe[3 * j2 + 1] + q[2 * D] * Fe[3 * j2 + 2]
              + q[(9 + j2) * D] * (-dt);
        } else if (j2 < 6) {
          s = q[j2 * D] + q[(j2 + 3) * D] * dt;
        } else if (j2 < 9) {
          const int r = j2 - 6;
          s = q[0] * Fa[3 * r] + q[D] * Fa[3 * r + 1] + q[2 * D] * Fa[3 * r + 2] + q[j2 * D]
              + q[12 * D] * Fr[3 * r] + q[13 * D] * Fr[3 * r + 1] + q[14 * D] * Fr[3 * r + 2]
              + q[(15 + r) * D] * dt;
        } else {
          s = q[j2 * D];
        }
        const double* Qd = ch.Qd[p];
        if (i2 == j2 && i2 < 3) s = s + Qd[i2];
        else if (i2 >= 6 && i2 < 9 && j2 >= 6 && j2 < 9) s = s + ch.Qa[p][3 * (i2 - 6) + (j2 - 6)];
        else if (i2 == j2 && i2 >= 9 && i2 < 15) s = s + Qd[i2 - 6];
        cov[i2 * D + j2] = s;
      }
      __syncthreads();
    }
    __syncthreads();  // every thread has read the chunk's flags
  }

  cov_out[tid] = cov[tid];
  if (tid == 0) {
    // signed tail extrapolation to the segment end time
    const double sdt = (double)wire[B * WC];
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
// the device; B >= 1. Launches on `stream`; returns the launch's
// cudaError_t (0 on success).
extern "C" int imu_propagate_launch(
    const float* wire, const double* rot, const double* pos, const double* vel,
    const double* bg, const double* ba, const double* grav, const double* cov,
    const double* acc0, const double* gyr0, const float* acc_scale, const float* cov_acc,
    const float* cov_gyr, const float* cov_bias_acc, const float* cov_bias_gyr,
    double* rot_out, double* pos_out, double* vel_out, double* cov_out, double* pack,
    double* acc_last, double* gyr_last, int B, void* stream) {
  if (B < 1) return (int)cudaErrorInvalidValue;
  imu_propagate_kernel<<<1, NT, 0, (cudaStream_t)stream>>>(
      wire, B, rot, pos, vel, bg, ba, grav, cov, acc0, gyr0, acc_scale, cov_acc, cov_gyr,
      cov_bias_acc, cov_bias_gyr, rot_out, pos_out, vel_out, cov_out, pack, acc_last,
      gyr_last);
  return (int)cudaGetLastError();
}
