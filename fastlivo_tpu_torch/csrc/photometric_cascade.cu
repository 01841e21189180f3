// The photometric EKF's coarse-to-fine cascade in one launch, for Hopper,
// and its prior-anchored f64 step alone in another.
//
// photometric_cascade replaces the device program the JAX package
// compiles from the `jax.lax.while_loop` of
// fastlivo_tpu/vio.py::photometric_update_levels (the loop at :723, its
// body :666-711), whose measurement samples through the TPU kernel
// fastlivo_tpu/ops/pallas_image.py::patches_and_grads_pallas
// (`pl.pallas_call` at :180). Each iteration, at the pyramid level in
// force:
//   the measurement of csrc/photometric_err_H.cu (photometric_measure.cuh:
//   projection, taps, the 43 terms per pixel, the fixed-order sums) gives
//   [HᵀWH | HᵀWz], err = Σperr / max(Σw·P·P, 1) and the per-point errors;
//   the step (lidar_selection.cpp:861-878): K = P'[:, :6] (HᵀH₆ P'[:6, :6]
//   + I₆)⁻¹ by a 6x6 Gauss-Jordan with partial pivoting (the JAX
//   package's ops/linalg.py::gj_solve, which its kalman_gain6_f64 runs),
//   vec = [Log(rotᵀ prior.rot), prior_x - x], sol = vec - K (Hᵀz + HᵀH₆
//   vec[:6]), rot' = rot Exp(sol[:3]), x' = x + sol[3:], G = K HᵀH₆ and the
//   two convergence norms, all f64;
//   the carry (vio.py:679-711): improved = err <= last_err keeps the step
//   or rolls back; a level ends on a rollback, convergence or max_iter and
//   the next level starts afresh (last_err 1e10, G 0, perr 1e10).
// After the loop: rot, x, the G of the last accepted step, its per-point
// errors, last_err and the iteration count. The plain version is the host
// loop vio.py::photometric_loop with ops/photometric.py's plain measurement
// and photometric_step_plain.
//
// photometric_step is that step alone (one warp), for the host loop a
// device mesh runs: a psum between the measurement and the step cannot
// live inside one kernel. Both run the same device code (ekf_step.cuh), so
// a world of one gets the single device's bits. The LIO host loop
// (lio.lio_loop) launches it too, with its own thresholds and -Hᵀz.
//
// Bound: the cascade's chain, not bytes or operations. Per iteration
// ~0.15 MB of taps and patches and ~2.2 M float operations (far below
// what the card moves and computes in a microsecond), then a dependent f64
// chain of a few hundred operations (the reduction, the elimination, Log
// and Exp) that the next iteration's projection needs. Design: one cooperative, persistent
// launch (cudaLaunchCooperativeKernel) of as many blocks as can be
// co-resident, at most G; block b measures points b, b + grid, ... into
// the (G, 44) partials, a grid barrier, then block 0 reduces the partials
// in the order of photometric_err_H's last block (so HT, err and n_meas
// are bit-equal to it on the same pose), runs the step in one warp and the
// carry in one thread, writes the next pose and the level, a second grid
// barrier, and every block reads whether the cascade is done. No host
// read and no launch between iterations; no float atomics (the grid
// barrier is the only atomic). Built with -fmad=false: every product
// rounds alone, as in the plain version.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "patch_sample.cuh"
#include "photometric_measure.cuh"
#include "so3.cuh"
#include "ekf_step.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_LEVELS = 8;
constexpr double CONV_ROT_DEG = 0.001;  // lidar_selection.cpp:885
constexpr double CONV_POS_CM = 0.001;

struct Cascade {
  Meas m;
  const double* Pp;         // (18, 18) P' = prior.cov / img_point_cov
  const double* prior_rot;  // (3, 3)
  const double* prior_x;    // (15,)
  const double* rot0;       // (3, 3) the state's
  const double* x0;         // (15,)
  double* cur;              // scratch (24): the next iteration's rot, x
  int* ctl;                 // scratch (2): its level index, done
  float* partial;           // scratch (G, NP)
  float* perr_cur;          // scratch (G,): this iteration's errors
  double* rot_out;          // (3, 3)
  double* x_out;            // (15,)
  double* Gmat;             // (18, 6)
  float* perr_out;          // (G,)
  double* last_err;         // ()
  int* its;                 // ()
  int levels[MAX_LEVELS];
  int n_lv, max_iter;
};

// Block 0's carry between iterations (the while_loop's carry).
struct Carry {
  double rot[9], x[NX], o_rot[9], o_x[NX];
  double last_err;
  double Gb[DS * 6];
  int it_l, its, li, done;
  int act;  // perr and G: 0 keep, 1 take this iteration's, 2 reset
};

__global__ void photometric_cascade_kernel(const Cascade c) {
  extern __shared__ float smem[];
  __shared__ Step st;
  __shared__ Carry cr;
  __shared__ Prior pr;
  __shared__ float pose[12];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const Meas& m = c.m;
  const int G = m.G;
  const int PP = m.P * m.P;
  const bool lead = blockIdx.x == 0;

  if (lead) {
    load_prior(c.Pp, c.prior_rot, c.prior_x, pr, tid, blockDim.x);
    if (tid == 0) {
      for (int k = 0; k < 9; ++k) cr.rot[k] = cr.o_rot[k] = c.rot0[k];
      for (int k = 0; k < NX; ++k) cr.x[k] = cr.o_x[k] = c.x0[k];
      cr.last_err = 1e10;
      cr.it_l = cr.its = cr.li = cr.done = 0;
    }
    for (int e = tid; e < DS * 6; e += blockDim.x) cr.Gb[e] = 0.0;
    for (int g = tid; g < G; g += blockDim.x) c.perr_out[g] = 1e10f;
  }
  __syncthreads();

  for (int iter = 0;; ++iter) {
    const int li = iter == 0 ? 0 : __ldcg(c.ctl);
    const int level = c.levels[li];
    const float* patch = m.tr_patch + (size_t)level * PP;
    load_pose(iter == 0 ? c.rot0 : c.cur, iter == 0 ? c.x0 : c.cur + 9, pose);
    for (int g = blockIdx.x; g < G; g += gridDim.x)
      measure_point(m, pose, level, patch, g, smem, c.partial, c.perr_cur);
    grid.sync();

    if (lead) {
      reduce_partials(c.partial, G, smem, m.P);
      const float* tot = meas_tot(smem, m.P);
      if (tid < 32) step_warp(pr, cr.rot, cr.x, tot, st, tid, CONV_ROT_DEG, CONV_POS_CM);
      __syncthreads();
      if (tid == 0) {
        const float n_meas = fmaxf(tot[NT] * (float)m.P * (float)m.P, 1.0f);
        const float err = tot[NH] / n_meas;
        const bool improved = (double)err <= cr.last_err;
        if (improved) {  // the current pose becomes the rollback point
          for (int k = 0; k < 9; ++k) {
            cr.o_rot[k] = cr.rot[k];
            cr.rot[k] = st.nrot[k];
          }
          for (int k = 0; k < NX; ++k) {
            cr.o_x[k] = cr.x[k];
            cr.x[k] = st.nx[k];
          }
          cr.last_err = (double)err;
        } else {  // roll back and end the level (lidar_selection.cpp:889-892)
          for (int k = 0; k < 9; ++k) cr.rot[k] = cr.o_rot[k];
          for (int k = 0; k < NX; ++k) cr.x[k] = cr.o_x[k];
        }
        const bool level_done = !improved || st.conv || cr.it_l + 1 >= c.max_iter;
        const bool done = level_done && cr.li == c.n_lv - 1;
        const bool advance = level_done && !done;
        cr.it_l = level_done ? 0 : cr.it_l + 1;
        cr.its += 1;
        cr.act = advance ? 2 : (improved ? 1 : 0);
        if (advance) {  // the next level: a fresh UpdateState
          cr.li += 1;
          for (int k = 0; k < 9; ++k) cr.o_rot[k] = cr.rot[k];
          for (int k = 0; k < NX; ++k) cr.o_x[k] = cr.x[k];
          cr.last_err = 1e10;
        }
        cr.done = done;
        for (int k = 0; k < 9; ++k) c.cur[k] = cr.rot[k];
        for (int k = 0; k < NX; ++k) c.cur[9 + k] = cr.x[k];
        c.ctl[0] = cr.li;
        c.ctl[1] = cr.done;
      }
      __syncthreads();
      if (cr.act != 0) {
        for (int g = tid; g < G; g += blockDim.x)
          c.perr_out[g] = cr.act == 1 ? __ldcg(c.perr_cur + g) : 1e10f;
        for (int e = tid; e < DS * 6; e += blockDim.x)
          cr.Gb[e] = cr.act == 1 ? st.G[e / 6][e - (e / 6) * 6] : 0.0;
      }
    }
    grid.sync();
    if (__ldcg(c.ctl + 1)) break;
  }

  if (lead) {
    __syncthreads();
    for (int e = tid; e < DS * 6; e += blockDim.x) c.Gmat[e] = cr.Gb[e];
    if (tid == 0) {
      for (int k = 0; k < 9; ++k) c.rot_out[k] = cr.rot[k];
      for (int k = 0; k < NX; ++k) c.x_out[k] = cr.x[k];
      *c.last_err = cr.last_err;
      *c.its = cr.its;
    }
  }
}

__global__ void photometric_step_kernel(const double* __restrict__ Pp,
                                        const double* __restrict__ prior_rot,
                                        const double* __restrict__ prior_x,
                                        const double* __restrict__ rot,
                                        const double* __restrict__ x,
                                        const float* __restrict__ HT, double* rot_out,
                                        double* x_out, uint8_t* conv, double* Gmat,
                                        double conv_rot_deg, double conv_pos_cm) {
  __shared__ Step st;
  __shared__ Prior pr;
  const int lane = threadIdx.x;
  load_prior(Pp, prior_rot, prior_x, pr, lane, 32);
  step_warp(pr, rot, x, HT, st, lane, conv_rot_deg, conv_pos_cm);
  if (lane < 9) rot_out[lane] = st.nrot[lane];
  if (lane < NX) x_out[lane] = st.nx[lane];
  for (int e = lane; e < DS * 6; e += 32) Gmat[e] = st.G[e / 6][e - (e / 6) * 6];
  if (lane == 0) *conv = (uint8_t)st.conv;
}

}  // namespace

// The cascade on G >= 0 tracked points (the measurement's inputs as for
// photometric_err_H_launch, with tr_patch the whole (G, L, P, P) block:
// patch_stride = L·P·P, and a level l's plane at l·P·P), P' (18, 18),
// the prior's rot (3, 3) and x (15,), the state's rot and x, all f64;
// levels[0:n_lv] in order (each < L), max_iter >= 1; scratch cur (24) f64,
// ctl (2) int, partial (max(G, 1), 44) f32, perr_cur (max(G, 1)) f32;
// outputs rot (3, 3), x (15,), Gmat (18, 6), last_err () f64, perr (G,)
// f32 and its () int32. All contiguous on the device. `grid_out`
// receives the number of blocks launched. Returns the launch's
// cudaError_t (0 = cudaSuccess); cudaErrorCooperativeLaunchTooLarge where
// not even one block fits on an SM.
extern "C" int photometric_cascade_launch(
    const void* img, const void* tr_pos, const void* tr_patch, const void* tr_slevel,
    const void* tr_valid, const void* Rci, const void* Pci, const void* Jdphi_dR,
    const void* Jdp_dR, const void* fx, const void* fy, const void* cx, const void* cy,
    const void* dist, const void* Pp, const void* prior_rot, const void* prior_x,
    const void* rot0, const void* x0, void* cur, void* ctl, void* partial, void* perr_cur,
    void* rot_out, void* x_out, void* Gmat, void* perr_out, void* last_err, void* its,
    const int* levels, int n_lv, int max_iter, int G, int H, int W, int P,
    int patch_stride, int robust, float k_h, float inv_b, float inv_rs, int* grid_out,
    void* stream) {
  if (G < 0 || P < 1 || P > 16 || n_lv < 1 || n_lv > MAX_LEVELS || max_iter < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Cascade c;
  Meas& m = c.m;
  m.img = static_cast<const float*>(img);
  m.tr_pos = static_cast<const float*>(tr_pos);
  m.tr_patch = static_cast<const float*>(tr_patch);
  m.tr_slevel = static_cast<const int32_t*>(tr_slevel);
  m.tr_valid = static_cast<const uint8_t*>(tr_valid);
  m.Rci = static_cast<const float*>(Rci);
  m.Pci = static_cast<const float*>(Pci);
  m.Jdphi_dR = static_cast<const float*>(Jdphi_dR);
  m.Jdp_dR = static_cast<const float*>(Jdp_dR);
  m.fx = static_cast<const float*>(fx);
  m.fy = static_cast<const float*>(fy);
  m.cx = static_cast<const float*>(cx);
  m.cy = static_cast<const float*>(cy);
  m.dist = static_cast<const float*>(dist);
  m.G = G;
  m.H = H;
  m.W = W;
  m.P = P;
  m.patch_stride = patch_stride;
  m.robust = robust;
  m.k_h = k_h;
  m.inv_b = inv_b;
  m.inv_rs = inv_rs;
  c.Pp = static_cast<const double*>(Pp);
  c.prior_rot = static_cast<const double*>(prior_rot);
  c.prior_x = static_cast<const double*>(prior_x);
  c.rot0 = static_cast<const double*>(rot0);
  c.x0 = static_cast<const double*>(x0);
  c.cur = static_cast<double*>(cur);
  c.ctl = static_cast<int*>(ctl);
  c.partial = static_cast<float*>(partial);
  c.perr_cur = static_cast<float*>(perr_cur);
  c.rot_out = static_cast<double*>(rot_out);
  c.x_out = static_cast<double*>(x_out);
  c.Gmat = static_cast<double*>(Gmat);
  c.perr_out = static_cast<float*>(perr_out);
  c.last_err = static_cast<double*>(last_err);
  c.its = static_cast<int*>(its);
  for (int k = 0; k < MAX_LEVELS; ++k) c.levels[k] = k < n_lv ? levels[k] : 0;
  c.n_lv = n_lv;
  c.max_iter = max_iter;

  const int threads = meas_threads(P);
  const size_t smem = (size_t)meas_smem_floats(P, threads) * sizeof(float);
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, photometric_cascade_kernel,
                                                      threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int resident = per_sm * sms;
  const int grid = G < 1 ? 1 : (G < resident ? G : resident);
  *grid_out = grid;
  void* args[] = {&c};
  e = cudaLaunchCooperativeKernel((const void*)photometric_cascade_kernel, dim3(grid),
                                  dim3(threads), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The step alone: P' (18, 18), the prior's rot (3, 3) and x (15,), the
// pose's rot (3, 3) and x (15,), f64, and HT (6, 7) f32; writes rot'
// (3, 3), x' (15,), G (18, 6) f64 and conv (one byte) against the two
// thresholds (the camera frame's 0.001 / 0.001; the LIO host loop's 0.01 /
// 0.015 with -Hᵀz, see ekf_step.cuh). One block of one warp. Returns the
// launch's cudaError_t.
extern "C" int photometric_step_launch(const void* Pp, const void* prior_rot,
                                       const void* prior_x, const void* rot, const void* x,
                                       const void* HT, void* rot_out, void* x_out, void* conv,
                                       void* Gmat, double conv_rot_deg, double conv_pos_cm,
                                       void* stream) {
  photometric_step_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(Pp), static_cast<const double*>(prior_rot),
      static_cast<const double*>(prior_x), static_cast<const double*>(rot),
      static_cast<const double*>(x), static_cast<const float*>(HT),
      static_cast<double*>(rot_out), static_cast<double*>(x_out),
      static_cast<uint8_t*>(conv), static_cast<double*>(Gmat), conv_rot_deg, conv_pos_cm);
  return static_cast<int>(cudaGetLastError());
}
