// One photometric EKF iteration's measurement in one launch, for Hopper:
// [HᵀWH | HᵀWz], the mean patch error and the per-point errors.
//
// Replaces the TPU kernel
// fastlivo_tpu/ops/pallas_image.py::patches_and_grads_pallas (the
// `pl.pallas_call` at line 180) together with everything the iteration
// computed around it: the JAX package's `compute_err_H` (vio.py:585-655),
// the reference's UpdateState measurement (lidar_selection.cpp:805-860).
// The plain version is ops/photometric.py::photometric_err_H_plain. Per
// tracked point g of G:
//   the camera pose rcw = Rci·rot32ᵀ, pcw = -rcw·pos32 + Pci (the f64
//   state cast to f32), the point pf = rcw·p + pcw, its pixel through
//   camera.world2cam (radial-tangential distortion) and front = z > 1e-6;
//   the scale s = (1 << level) << search_level, the anchor and the
//   (P+3)² clamped taps of patch_sample.cuh (shared with
//   patches_and_grads.cu), and per pixel val, du, dv;
//   res = val - tr_patch[g, level], h = [du dv]·Jdpi·Mg (6 entries,
//   lidar_selection.cpp:826-832), w = valid & front, the robust weight
//   (Huber or Tukey on |res|·(1/robust_scale), or none), and the 42
//   products of [hᵀ·wr·h | hᵀ·wr·res] and res_w².
//
// Design (the per-point body and the reduction live in
// photometric_measure.cuh, shared with photometric_cascade.cu): one
// block per tracked point, (P+3)² rounded up to whole warps, at most 384
// threads (128 at P = 8). Every thread forms the pose and the projection
// itself (a few dozen flops on broadcast loads, no barrier), the block
// loads its taps into shared memory (past P = 87 they are read in place
// from the image, a template parameter), each thread forms the 43 terms
// of its pixels (one at P <= 16) and sums them in registers, and the
// block reduces them in a fixed tree: a 5-step butterfly
// (__shfl_xor_sync) in each warp, then the warps in index order through
// shared memory. Each block writes a 44-float partial
// (the 42 sums, its perr, its weight) and its perr. The last block to
// finish (an int ticket: atomicAdd after __threadfence; it then resets
// the counter for the next launch on the stream) sums each quantity over
// the G partials in a fixed order (ops/photometric.py::partials_sum:
// eight interleaved chains a quantity, each chain a thread's with its 24
// loads through L2 in flight at once: the latency of those loads bounds
// it, and a version whose warps waited on each in turn took 21 us at G =
// 192), and writes HT (6, 7), err = Σperr / max(Σw·P·P, 1), n_meas and
// Σperr (over a device mesh the ranks sum [HT | Σperr |
// n_meas] and divide after the sum, vio.photometric_loop). No
// float atomics: the result is the same from run to run. Every product
// and sum rounds as the plain version's, which writes this order out
// (-fmad=false): the outputs are bit-equal to it.
//
// Bound on an H100: bytes, at the path's G = 192, P = 8: per point its
// (P+3)² taps (at most 484 B; chip_smoke.py counts the distinct pixels),
// its level of tr_patch (256 B), tr_pos, search level and valid flag
// (17 B) and its perr (4 B): ~0.15 MB, ~0.044 us at 3.35 TB/s (the
// partials are this design's scratch, not the function's bytes); ~150
// float operations per pixel and ~1.7 k per point (~2.2 M) take ~0.033 us
// at 67 TFLOP/s. At that size the kernel is bound by its dependent chain
// (loads -> projection -> taps -> sums -> ticket -> final sum), i.e. by
// latency, not by the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "patch_sample.cuh"
#include "photometric_measure.cuh"

namespace {

struct Args {
  Meas m;
  const double* rot;  // (3, 3) f64
  const double* pos;  // (3,) f64
  float* partial;     // (G, NP) scratch
  int* ticket;        // one int, 0 between launches
  float* out;         // HT (42), err, n_meas, Σperr
  float* perr;        // (G,)
  int level;
};

template <bool STAGED>
__global__ void photometric_err_H_kernel(const Args a) {
  extern __shared__ float smem[];
  __shared__ int s_last;
  __shared__ float pose[12];
  const int g = blockIdx.x;
  const int G = gridDim.x;
  const int tid = threadIdx.x;

  load_pose(a.rot, a.pos, pose);
  measure_point<STAGED>(a.m, pose, a.level, a.m.tr_patch, g, smem, a.partial, a.perr,
                        blockDim.x);
  __threadfence();  // the partial is visible before the ticket is taken
  __syncthreads();
  if (tid == 0) s_last = (atomicAdd(a.ticket, 1) == G - 1);
  __syncthreads();
  if (!s_last) return;

  // the last block: the G partials in a fixed order
  __threadfence();
  reduce_partials(a.partial, G, smem, a.m.P);
  const float* tot = meas_tot(smem, a.m.P);
  if (tid < NH) a.out[tid] = tot[tid];
  if (tid == 0) {
    const float n_meas = fmaxf(tot[NT] * (float)a.m.P * (float)a.m.P, 1.0f);
    a.out[NH] = tot[NH] / n_meas;
    a.out[NH + 1] = n_meas;
    a.out[NH + 2] = tot[NH];  // Σperr, the numerator a mesh sums
    *a.ticket = 0;
  }
}

}  // namespace

// C interface for ctypes: G tracked points (G >= 1); img (H, W) f32,
// tr_pos (G, 3) f32, tr_patch (G, P, P) f32 with row stride patch_stride
// elements and contiguous (P, P) planes, tr_slevel (G,) int32, tr_valid
// (G,) u8, rot (3, 3) / pos (3,) f64, Rci, Jdphi_dR, Jdp_dR (3, 3) and
// Pci (3,) f32, the camera's fx, fy, cx, cy (f32 scalars) and dist (4,)
// f32, P >= 1; scratch partial (G, 44) f32 and ticket (one int, 0); outputs out
// (45,) f32 = [HT (6, 7) row-major, err, n_meas, Σperr] and perr (G,) f32. All
// on the device. robust: 0 none, 1 Huber, 2 Tukey. Returns the launch's
// cudaError_t (0 = cudaSuccess).
extern "C" int photometric_err_H_launch(
    const void* img, const void* tr_pos, const void* tr_patch,
    const void* tr_slevel, const void* tr_valid, const void* rot,
    const void* pos, const void* Rci, const void* Pci, const void* Jdphi_dR,
    const void* Jdp_dR, const void* fx, const void* fy, const void* cx,
    const void* cy, const void* dist, void* partial, void* ticket, void* out,
    void* perr, int G, int H, int W, int P, int level, int patch_stride,
    int robust, float k_h, float inv_b, float inv_rs, void* stream) {
  if (G <= 0 || P < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  Meas& m = a.m;
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
  a.rot = static_cast<const double*>(rot);
  a.pos = static_cast<const double*>(pos);
  a.partial = static_cast<float*>(partial);
  a.ticket = static_cast<int*>(ticket);
  a.out = static_cast<float*>(out);
  a.perr = static_cast<float*>(perr);
  a.level = level;
  const int threads = meas_threads(P);
  const size_t smem = (size_t)meas_smem_floats(P, threads) * sizeof(float);
  auto st = static_cast<cudaStream_t>(stream);
  if (taps_staged(P)) {
    photometric_err_H_kernel<true><<<G, threads, smem, st>>>(a);
  } else {
    photometric_err_H_kernel<false><<<G, threads, smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
