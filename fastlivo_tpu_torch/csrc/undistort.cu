// The scan's backward undistortion, for Hopper: one thread a point.
//
// Replaces no TPU kernel: it is the port of the jitted XLA code of
// fastlivo_tpu/imu.py::undistort (:354-398, the reference's backward pass,
// IMU_Processing.cpp:774-808), whose torch version imu.undistort_plain is
// some 150 small torch ops. For each point with pmask set:
//
//   k   = searchsorted(offs, t, left) - 1, clamped to [0, M - 1]: the
//         lower bound of torch's searchsorted (`!(offs[mid] >= t)`, mid =
//         lo + ((hi - lo) >> 1)) on the f32 offsets, which hold duplicates
//         and BIG_T padding;
//   dt  = t - offs[k];
//   R_i = R_k Exp(gyr_k dt): the HEAD row's rotation and gyro (row k holds
//         the previous pair's averages; the reference's convention, kept);
//         Exp is Rodrigues in f32, I + a K + b K K with its 3x3 products
//         written out, a = sin(t)/t and b = (1 - cos(t))/t^2, or the Taylor
//         forms 1 - t^2/6 and 1/2 - t^2/24 below t^2 = 1e-12 (t^2 clamped
//         at 1e-14 before the root), as ops/so3.py::exp;
//   T   = ((pos_k + vel_k dt) + ((0.5 acc_k) dt) dt) - s_end.pos;
//   out = (R_li^T R_e^T) (R_i (R_li p + t_li) + T) - R_li^T t_li;
//
// a point without pmask is copied. Each 3-term sum runs left to right,
// each product rounds alone (-fmad=false), and the pose table and the
// segment-end state are cast to f32 where undistort_plain casts them, so
// the kernel gives undistort_plain's bits on the card (sinf, cosf, sqrtf
// and the divisions are CUDA's accurate ones there).
//
// Bound on an H100: 29 bytes a point (the point, its time and mask, the
// result) and the pose table once; about 220 operations a point. At the
// LIO scan's 32768 rows memory binds it (~0.3 us), far below a launch, so
// the kernel is held by its launch and by each thread's chain of steps.
// chip_smoke.py counts the bound from its inputs.
//
// Design: one thread a point, 256 a block. A table of at most STAGE_M
// rows (the pipeline's up to max_imu_per_group 512): each block first
// stages the M offsets in dynamic shared memory (coalesced loads, the
// table's own dtype) while warp 0 forms the frame's constants once
// (R_li^T R_e^T and R_li^T t_li in undistort_plain's order, and the
// calibration and the state's position cast to f32) and every
// thread's point, time and mask are in flight; one barrier. The search
// then runs in shared memory with torch's probes, so it finds the same row
// whatever the offsets' order (padding, duplicates, NaN). A larger table
// (the launch picks the layout by M, a template parameter) is not staged:
// the same search, probe for probe, reads the offsets where they lie in
// global memory (its top levels stay in L1 and L2), so any M the int
// indices hold runs in the same one launch and gives the same bits. The pose
// row's 21 values are loaded as one batch of independent loads before
// the Exp and the products. With -DPHASE_STAMPS (phase_stamps.cuh) the
// kernel stamps the staged table (1), the searched rows (2) and its end
// (3).

#include <cuda_runtime.h>
#include <stdint.h>

#include "phase_stamps.cuh"

namespace {

constexpr int THREADS = 256;
// the largest pose table staged in shared memory: Pipeline.max_scan_poses
// = 8 (max_imu_per_group + 1) at max_imu_per_group 512; 32.8 KB of f64
// offsets, under the 48 KB of dynamic shared memory a launch has without
// opting in. A larger table is searched in global memory.
constexpr int STAGE_M = 4104;
constexpr float T2_MIN = 1e-14f;    // float32(so3._SMALL ** 2)
constexpr float T2_SMALL = 1e-12f;  // float32((10 so3._SMALL) ** 2)

template <typename P>
struct Pose {  // the pose table's fields; a row of each at `stride` elements
  const P* offs;
  const P* rot;  // a row: 9 contiguous values, row-major
  const P* pos;
  const P* vel;
  const P* acc;
  const P* gyr;
  long long s_offs, s_rot, s_pos, s_vel, s_acc, s_gyr;
  int M;
};

// C = A B for 3x3 matrices: each entry (a0 b0 + a1 b1) + a2 b2
__device__ __forceinline__ void mat3(const float A[3][3], const float B[3][3], float C[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) C[i][j] = (A[i][0] * B[0][j] + A[i][1] * B[1][j]) + A[i][2] * B[2][j];
}

template <typename P, bool STAGED>
__global__ void __launch_bounds__(THREADS) undistort_kernel(
    Pose<P> pose, const double* __restrict__ s_rot, const double* __restrict__ s_pos,
    const float* __restrict__ lid_rot, const float* __restrict__ lid_off,
    const float* __restrict__ pts, const float* __restrict__ t_rel,
    const bool* __restrict__ pmask, float* __restrict__ out, int N) {
  extern __shared__ double s_dyn[];  // the M offsets, as P (STAGED)
  P* s_offs = reinterpret_cast<P*>(s_dyn);
  __shared__ float s_ext[3][3], s_c[3], s_L[3][3], s_off[3], s_spos[3];
  PHASE_STAMP_START();
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const int M = pose.M;
  const bool in = i < N;
  float x = 0.0f, y = 0.0f, z = 0.0f, t = 0.0f;
  bool act = false;
  if (in) {  // in flight while the block stages the table
    x = pts[3 * i];
    y = pts[3 * i + 1];
    z = pts[3 * i + 2];
    t = t_rel[i];
    act = pmask[i];
  }
  if (STAGED)
    for (int r = threadIdx.x; r < M; r += THREADS) s_offs[r] = pose.offs[r * pose.s_offs];
  if (threadIdx.x < 32) {
    // the frame's constants: ext = R_li^T R_e^T (lanes 0-8), c = R_li^T
    // t_li (9-11); the calibration (12-23) and the state's position in f32
    // (24-26)
    const int l = threadIdx.x;
    if (l < 9) {
      const int a = l / 3, b = l % 3;
      s_ext[a][b] = (lid_rot[a] * (float)s_rot[3 * b] + lid_rot[3 + a] * (float)s_rot[3 * b + 1])
                    + lid_rot[6 + a] * (float)s_rot[3 * b + 2];
    } else if (l < 12) {
      const int a = l - 9;
      s_c[a] = (lid_rot[a] * lid_off[0] + lid_rot[3 + a] * lid_off[1]) + lid_rot[6 + a] * lid_off[2];
    } else if (l < 21) {
      s_L[(l - 12) / 3][(l - 12) % 3] = lid_rot[l - 12];
    } else if (l < 24) {
      s_off[l - 21] = lid_off[l - 21];
    } else if (l < 27) {
      s_spos[l - 24] = (float)s_pos[l - 24];
    }
  }
  __syncthreads();
  PHASE_STAMP(1);

  // torch.searchsorted's lower bound on the offsets, staged or in place
  const auto offs_at = [&](int r) -> float {
    return STAGED ? (float)s_offs[r] : (float)pose.offs[(long long)r * pose.s_offs];
  };
  int k = 0;
  if (act) {
    int lo = 0, hi = M;
    while (lo < hi) {
      const int mid = lo + ((hi - lo) >> 1);
      if (!(offs_at(mid) >= t))
        lo = mid + 1;
      else
        hi = mid;
    }
    k = lo - 1;
    k = k < 0 ? 0 : (k > M - 1 ? M - 1 : k);
  }
  PHASE_STAMP(2);

  if (act) {
    const float dt = t - offs_at(k);
    // the pose row: 21 independent loads
    float Rh[3][3], pk[3], vk[3], ak[3], gk[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) Rh[a][b] = (float)pose.rot[k * pose.s_rot + 3 * a + b];
      pk[a] = (float)pose.pos[k * pose.s_pos + a];
      vk[a] = (float)pose.vel[k * pose.s_vel + a];
      ak[a] = (float)pose.acc[k * pose.s_acc + a];
      gk[a] = (float)pose.gyr[k * pose.s_gyr + a];
    }

    // Exp(gyr_k dt)
    float phi[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) phi[a] = gk[a] * dt;
    const float t2 = (phi[0] * phi[0] + phi[1] * phi[1]) + phi[2] * phi[2];
    const float th = sqrtf(t2 < T2_MIN ? T2_MIN : t2);  // a NaN stays NaN, as torch.clamp
    const bool small = t2 < T2_SMALL;
    const float ca = small ? 1.0f - t2 / 6.0f : sinf(th) / th;
    const float cb = small ? 0.5f - t2 / 24.0f : (1.0f - cosf(th)) / (th * th);
    const float K[3][3] = {{0.0f, -phi[2], phi[1]}, {phi[2], 0.0f, -phi[0]},
                           {-phi[1], phi[0], 0.0f}};
    float K2[3][3], E[3][3], Ri[3][3];
    mat3(K, K, K2);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) E[a][b] = ((a == b ? 1.0f : 0.0f) + ca * K[a][b]) + cb * K2[a][b];
    mat3(Rh, E, Ri);

    float T[3], q[3], pw[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      T[a] = ((pk[a] + vk[a] * dt) + ((0.5f * ak[a]) * dt) * dt) - s_spos[a];
      q[a] = ((s_L[a][0] * x + s_L[a][1] * y) + s_L[a][2] * z) + s_off[a];
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) pw[a] = ((Ri[a][0] * q[0] + Ri[a][1] * q[1]) + Ri[a][2] * q[2]) + T[a];
    float o[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      o[a] = ((s_ext[a][0] * pw[0] + s_ext[a][1] * pw[1]) + s_ext[a][2] * pw[2]) - s_c[a];
    x = o[0];
    y = o[1];
    z = o[2];
  }
  if (in) {  // a point without pmask is copied
    out[3 * i] = x;
    out[3 * i + 1] = y;
    out[3 * i + 2] = z;
  }
  PHASE_STAMP(3);
}

template <typename P>
int launch(const void* const* f, const long long* strides, int M, const void* s_rot,
           const void* s_pos, const void* lid_rot, const void* lid_off, const void* pts,
           const void* t_rel, const void* pmask, void* out, int N, cudaStream_t stream) {
  Pose<P> pose{static_cast<const P*>(f[0]), static_cast<const P*>(f[1]),
               static_cast<const P*>(f[2]), static_cast<const P*>(f[3]),
               static_cast<const P*>(f[4]), static_cast<const P*>(f[5]),
               strides[0], strides[1], strides[2], strides[3], strides[4], strides[5], M};
  const int blocks = (N + THREADS - 1) / THREADS;
  const double* sr = static_cast<const double*>(s_rot);
  const double* sp = static_cast<const double*>(s_pos);
  const float* lr = static_cast<const float*>(lid_rot);
  const float* lo = static_cast<const float*>(lid_off);
  const float* x = static_cast<const float*>(pts);
  const float* tr = static_cast<const float*>(t_rel);
  const bool* pm = static_cast<const bool*>(pmask);
  float* o = static_cast<float*>(out);
  if (M <= STAGE_M)
    undistort_kernel<P, true><<<blocks, THREADS, M * sizeof(P), stream>>>(pose, sr, sp, lr, lo,
                                                                           x, tr, pm, o, N);
  else
    undistort_kernel<P, false><<<blocks, THREADS, 0, stream>>>(pose, sr, sp, lr, lo, x, tr, pm,
                                                               o, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface for ctypes. fields: the pose table's offs, rot, pos, vel,
// acc, gyr (M rows, f64 if pose_f64 else f32; a row's values contiguous,
// rows `strides[j]` elements apart); s_rot (3, 3) and s_pos (3,) f64;
// lid_rot (3, 3) and lid_off (3,) f32; pts (N, 3) f32, t_rel (N,) f32,
// pmask (N,) bool; out (N, 3) f32. Tables of up to STAGE_M rows are
// staged in shared memory, larger ones searched in place. Returns the
// launch's cudaError_t (0 = cudaSuccess; cudaErrorInvalidValue for M < 1);
// N = 0 launches nothing.
extern "C" int undistort_launch(const void* const* fields, const long long* strides, int M,
                                int pose_f64, const void* s_rot, const void* s_pos,
                                const void* lid_rot, const void* lid_off, const void* pts,
                                const void* t_rel, const void* pmask, void* out, int N,
                                void* stream) {
  if (N <= 0) return 0;
  if (M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pose_f64 ? launch<double>(fields, strides, M, s_rot, s_pos, lid_rot, lid_off, pts,
                                   t_rel, pmask, out, N, s)
                  : launch<float>(fields, strides, M, s_rot, s_pos, lid_rot, lid_off, pts,
                                  t_rel, pmask, out, N, s);
}

PHASE_STAMPS_EXPORT(undistort)
