// SO(3) helpers in f64 shared by csrc/imu_propagate.cu and
// csrc/photometric_cascade.cu, each evaluated in the order of operations
// of ops/so3.py (built with -fmad=false, every product rounds as there).
#pragma once

// so3.exp: I + a K + b K^2 with the Taylor forms below t^2 = 1e-12 and
// t^2 clamped at 1e-14 under the root.
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

// so3.log: theta from the trace (0 above trace 3 - 1e-6), the axis from
// the antisymmetric part, scale 0.5 below theta = 1e-3.
__device__ __forceinline__ void so3_log(const double R[9], double w[3]) {
  const double tr = (R[0] + R[4]) + R[8];
  const double c = 0.5 * (tr - 1.0);
  const double theta = tr > 3.0 - 1e-6 ? 0.0 : acos(c < -1.0 ? -1.0 : (c > 1.0 ? 1.0 : c));
  const bool tiny = fabs(theta) < 1e-3;
  const double scale = tiny ? 0.5 : 0.5 * theta / sin(theta);
  w[0] = scale * (R[7] - R[5]);
  w[1] = scale * (R[2] - R[6]);
  w[2] = scale * (R[3] - R[1]);
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
