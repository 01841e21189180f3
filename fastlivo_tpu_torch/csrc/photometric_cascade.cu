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
// and Exp) that the next iteration's projection needs. Design: one
// cooperative, persistent launch (cudaLaunchCooperativeKernel) of as many
// blocks as can be co-resident, at most G. Each iteration, block b's
// measuring warps measure points b, b + grid, ... into the (G, 44)
// partials of the iteration's parity while a spare warp of the block forms
// the step's vec (Log, on the pose only); one grid barrier; then every
// block reduces the partials in the order of photometric_err_H's last
// block (so HT, err and n_meas are bit-equal to it on the same pose), runs
// the step in one warp's registers and the carry in one thread, and so
// holds the same next pose and level as every other block: no second
// barrier. The partials and per-point errors are double-buffered by the
// iteration's parity, so a block that starts iteration i + 1 never writes
// what a slower block still reads of iteration i (it cannot start i + 2
// before every block has passed i + 1's barrier). Block 0 writes the
// outputs: G from the gain of the last accepted step, the errors from the
// buffer of its iteration. No host read and no launch between iterations;
// no float atomics (the grid barrier is the only atomic). Built with
// -fmad=false: every product rounds alone, as in the plain version.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "patch_sample.cuh"
#include "photometric_measure.cuh"
#include "so3.cuh"
#include "ekf_step.cuh"
#include "phase_stamps.cuh"

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
  float* partial;           // scratch (2, stride, NP): by the iteration's parity
  float* perr_cur;          // scratch (2, stride): the iteration's errors
  int stride;               // max(G, 1)
  double* rot_out;          // (3, 3)
  double* x_out;            // (15,)
  double* Gmat;             // (18, 6)
  float* perr_out;          // (G,)
  double* last_err;         // ()
  int* its;                 // ()
  int levels[MAX_LEVELS];
  int n_lv, max_iter;
};

// The carry between iterations (the while_loop's), the same in every
// block.
struct Carry {
  double rot[9], x[NX], o_rot[9], o_x[NX];
  double last_err;
  int it_l, its, li, done;
  int slot;        // the step's gain slot; the other holds the accepted step's
  int g_on;        // G: 0, or the gain in slot g_slot
  int g_slot;
  int p_on;        // perr: 1e10, or the errors of parity p_par
  int p_par;
};

// Threads per block: the measuring warps (meas_threads), a spare warp for
// vec and at least 256 threads, which hold the reduction's 352 chains in
// two passes at most.
__host__ __device__ inline int cascade_threads(int P) {
  const int t = meas_threads(P) + 32;
  return t > 256 ? t : 256;
}

// cascade_threads' largest block (416 threads from P = 16 on). STAGED:
// taps_staged(P), the taps in shared memory, else read in place.
template <bool STAGED>
__global__ void __launch_bounds__(MEAS_MAX_THREADS + 32) photometric_cascade_kernel(
    const Cascade c) {
  extern __shared__ float smem[];
  __shared__ Step st;
  __shared__ Carry cr;
  __shared__ Prior pr;
  __shared__ float pose[12];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Meas& m = c.m;
  const int G = m.G;
  const int PP = m.P * m.P;
  const int nmt = meas_threads(m.P);  // warps 0 .. nmt / 32 - 1 measure
  const int spare = nmt >> 5;         // and this one forms vec meanwhile

  PHASE_STAMP_START();
  load_prior(c.Pp, c.prior_rot, c.prior_x, pr, tid, blockDim.x);
  if (tid == 0) {
    for (int k = 0; k < 9; ++k) cr.rot[k] = cr.o_rot[k] = c.rot0[k];
    for (int k = 0; k < NX; ++k) cr.x[k] = cr.o_x[k] = c.x0[k];
    cr.last_err = 1e10;
    cr.it_l = cr.its = cr.li = cr.done = 0;
    cr.slot = cr.g_on = cr.g_slot = cr.p_on = cr.p_par = 0;
  }
  __syncthreads();

  for (int iter = 0;; ++iter) {
    PHASE_STAMP_IT(iter, 0);
    const int par = iter & 1;
    float* partial = c.partial + (size_t)par * c.stride * NP;
    float* perr = c.perr_cur + (size_t)par * c.stride;
    const int level = c.levels[cr.li];
    if (tid < 12) pose[tid] = (float)(tid < 9 ? cr.rot[tid] : cr.x[tid - 9]);
    __syncthreads();
    if (warp < spare) {
      const float* patch = m.tr_patch + (size_t)level * PP;
      for (int g = blockIdx.x; g < G; g += gridDim.x)
        measure_point<STAGED>(m, pose, level, patch, g, smem, partial, perr, nmt);
    } else if (warp == spare) {
      step_vec(pr, cr.rot, cr.x, st.vec, lane);
    }
    PHASE_STAMP_IT(iter, 1);
    grid.sync();
    PHASE_STAMP_IT(iter, 2);

    reduce_partials(partial, G, smem, m.P);
    PHASE_STAMP_IT(iter, 3);
    const float* tot = meas_tot(smem, m.P);
    if (warp == 0)
      step_warp(pr, cr.rot, cr.x, tot, st, lane, CONV_ROT_DEG, CONV_POS_CM, cr.slot);
    __syncthreads();
    PHASE_STAMP_IT(iter, 4);
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
      if (advance) {  // the next level: a fresh UpdateState, G 0, perr 1e10
        cr.li += 1;
        for (int k = 0; k < 9; ++k) cr.o_rot[k] = cr.rot[k];
        for (int k = 0; k < NX; ++k) cr.o_x[k] = cr.x[k];
        cr.last_err = 1e10;
        cr.g_on = cr.p_on = 0;
      } else if (improved) {  // G and perr of this step
        cr.g_on = cr.p_on = 1;
        cr.g_slot = cr.slot;
        cr.slot ^= 1;
        cr.p_par = par;
      }
      cr.done = done;
    }
    __syncthreads();
    PHASE_STAMP_IT(iter, 5);
    if (cr.done) break;
  }

  if (blockIdx.x == 0) {
    if (cr.g_on) {
      step_gain(st, cr.g_slot, c.Gmat, tid, blockDim.x);
    } else {
      for (int e = tid; e < DS * 6; e += blockDim.x) c.Gmat[e] = 0.0;
    }
    const float* perr = c.perr_cur + (size_t)cr.p_par * c.stride;
    for (int g = tid; g < G; g += blockDim.x) c.perr_out[g] = cr.p_on ? __ldcg(perr + g) : 1e10f;
    if (tid == 0) {
      for (int k = 0; k < 9; ++k) c.rot_out[k] = cr.rot[k];
      for (int k = 0; k < NX; ++k) c.x_out[k] = cr.x[k];
      *c.last_err = cr.last_err;
      *c.its = cr.its;
    }
  }
  PHASE_STAMP(1);
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
  __shared__ double pose[9 + NX];
  __shared__ float ht[EKF_NH];
  const int lane = threadIdx.x;
  if (lane < 9) pose[lane] = rot[lane];
  if (lane < NX) pose[9 + lane] = x[lane];
  for (int e = lane; e < EKF_NH; e += 32) ht[e] = HT[e];
  load_prior(Pp, prior_rot, prior_x, pr, lane, 32);
  step_vec(pr, pose, pose + 9, st.vec, lane);
  __syncwarp();
  step_warp(pr, pose, pose + 9, ht, st, lane, conv_rot_deg, conv_pos_cm, 0);
  if (lane < 9) rot_out[lane] = st.nrot[lane];
  if (lane < NX) x_out[lane] = st.nx[lane];
  step_gain(st, 0, Gmat, lane, 32);
  if (lane == 0) *conv = (uint8_t)st.conv;
}

}  // namespace

PHASE_STAMPS_EXPORT(photometric_cascade)

// The cascade on G >= 0 tracked points (the measurement's inputs as for
// photometric_err_H_launch, with tr_patch the whole (G, L, P, P) block:
// patch_stride = L·P·P, and a level l's plane at l·P·P), P' (18, 18),
// the prior's rot (3, 3) and x (15,), the state's rot and x, all f64;
// levels[0:n_lv] in order (each < L), max_iter >= 1; scratch partial (2,
// max(G, 1), 44) f32 and perr_cur (2, max(G, 1)) f32 (by the iteration's
// parity);
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
    const void* rot0, const void* x0, void* partial, void* perr_cur,
    void* rot_out, void* x_out, void* Gmat, void* perr_out, void* last_err, void* its,
    const int* levels, int n_lv, int max_iter, int G, int H, int W, int P,
    int patch_stride, int robust, float k_h, float inv_b, float inv_rs, int* grid_out,
    void* stream) {
  if (G < 0 || P < 1 || n_lv < 1 || n_lv > MAX_LEVELS || max_iter < 1)
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
  c.partial = static_cast<float*>(partial);
  c.perr_cur = static_cast<float*>(perr_cur);
  c.stride = G < 1 ? 1 : G;
  c.rot_out = static_cast<double*>(rot_out);
  c.x_out = static_cast<double*>(x_out);
  c.Gmat = static_cast<double*>(Gmat);
  c.perr_out = static_cast<float*>(perr_out);
  c.last_err = static_cast<double*>(last_err);
  c.its = static_cast<int*>(its);
  for (int k = 0; k < MAX_LEVELS; ++k) c.levels[k] = k < n_lv ? levels[k] : 0;
  c.n_lv = n_lv;
  c.max_iter = max_iter;

  const int threads = cascade_threads(P);
  const size_t smem = (size_t)meas_smem_floats(P, threads) * sizeof(float);
  int dev = 0, sms = 0, per_sm = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const void* fn = taps_staged(P) ? (const void*)photometric_cascade_kernel<true>
                                  : (const void*)photometric_cascade_kernel<false>;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int resident = per_sm * sms;
  const int grid = G < 1 ? 1 : (G < resident ? G : resident);
  *grid_out = grid;
  void* args[] = {&c};
  e = cudaLaunchCooperativeKernel(fn, dim3(grid),
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
