// Fused patch + centred-difference gradient sampling, for Hopper.
//
// Replaces the TPU kernel
// fastlivo_tpu/ops/pallas_image.py::patches_and_grads_pallas (body
// `_kernel`, the `pl.pallas_call` at line 180). For each tracked point k
// of the photometric EKF (UpdateState, lidar_selection.cpp:805-832):
//   anchor u_i = floor(u/s)*s, v_i = floor(v/s)*s and remainders
//   su = (u-u_i)/s, sv = (v-v_i)/s (image._anchor_weights);
//   a (P+3)x(P+3) tap grid at stride s around the anchor, each tap
//   clamped to the image;
//   from it the bilinear PxP patch `val` and the centred differences
//   du = 0.5*(I(+s) - I(-s))/s along u, dv along v.
// Outputs are (K, P, P) f32, row x over v, column y over u.
//
// Design: one thread block per point. The TPU kernel built its tap grid
// from two one-hot selection matmuls on the MXU (a TPU kernel cannot
// gather); here the block's threads load the (P+3)^2 clamped taps
// straight into shared memory through the read-only path, then each
// thread forms val, du and dv of the pixels t, t + threads, ... (one at
// P <= 16) from shared memory; past P = 87, where (P+3)^2 floats would
// not fit there, from the taps read in place (a template parameter,
// patch_sample.cuh's views give the same values). The
// whole function (anchor and weights included) is this one launch. The
// sampling code lives in patch_sample.cuh, which the fused photometric
// kernel (photometric_err_H.cu) shares.
// Products and sums are evaluated in the order of the plain version
// (ops/image.py::patches_and_grads: w_tl*a + w_tr*b + w_bl*c + w_br*d,
// left to right); built with -fmad=false, every product rounds as there.
//
// Bound on an H100: per point it reads (P+3)^2*4 tap bytes plus 12 bytes
// of centre and scale, and writes 3*P*P*4 bytes: ~1.26 KB at P = 8,
// ~0.24 MB for the path's K = 192 points, ~0.07 us at 3.35 TB/s. At that
// shape the kernel is bound by launch latency, not by the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "patch_sample.cuh"

namespace {

template <bool STAGED>
__global__ void patches_and_grads_kernel(const float* __restrict__ img,
                                         const float* __restrict__ pc,
                                         const int32_t* __restrict__ scale,
                                         float* __restrict__ val,
                                         float* __restrict__ du,
                                         float* __restrict__ dv, int H, int W,
                                         int P) {
  extern __shared__ float taps[];  // (P+3) x (P+3) when STAGED
  const int k = blockIdx.x;
  const int s = scale[k];
  const PatchAnchor a = patch_anchor(pc[2 * k + 0], pc[2 * k + 1], s);
  if (STAGED) {
    load_taps(img, H, W, a, s, P, taps, threadIdx.x, blockDim.x);
    __syncthreads();
  }
  const StagedTaps staged{taps, P + 3};
  const ImageTaps direct{img, H, W, s, P / 2 + 1, a};
  for (int t = threadIdx.x; t < P * P; t += blockDim.x) {
    const int x = t / P;  // row of the patch (v)
    const int y = t - x * P;  // column (u)
    float v_, du_, dv_;
    if (STAGED) {
      patch_val_grad(staged, a, x, y, v_, du_, dv_);
    } else {
      patch_val_grad(direct, a, x, y, v_, du_, dv_);
    }
    const size_t o = (size_t)k * P * P + t;
    val[o] = v_;
    du[o] = du_;
    dv[o] = dv_;
  }
}

}  // namespace

// C interface for ctypes: K points (K >= 0), img (H, W) f32, pc (K, 2)
// f32, scale (K,) int32; outputs val, du, dv (K, P, P) f32, P >= 1. All
// contiguous on the device. Returns the launch's cudaError_t.
extern "C" int patches_and_grads_launch(const float* img, const float* pc,
                                        const int32_t* scale, float* val,
                                        float* du, float* dv, int K, int H,
                                        int W, int P, void* stream) {
  if (K == 0) return 0;
  if (K < 0 || P < 1) return (int)cudaErrorInvalidValue;
  const int n = P + 3;
  int threads = (n * n > P * P ? n * n : P * P);
  threads = (threads + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  auto st = (cudaStream_t)stream;
  if (taps_staged(P)) {
    patches_and_grads_kernel<true><<<K, threads, (size_t)n * n * sizeof(float), st>>>(
        img, pc, scale, val, du, dv, H, W, P);
  } else {
    patches_and_grads_kernel<false><<<K, threads, 0, st>>>(img, pc, scale, val, du, dv, H,
                                                           W, P);
  }
  return (int)cudaGetLastError();
}
