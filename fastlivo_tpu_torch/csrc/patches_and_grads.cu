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
// straight into shared memory through the read-only path, then one
// thread per output pixel forms val, du and dv from shared memory. The
// whole function (anchor and weights included) is this one launch.
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

namespace {

__global__ void patches_and_grads_kernel(const float* __restrict__ img,
                                         const float* __restrict__ pc,
                                         const int32_t* __restrict__ scale,
                                         float* __restrict__ val,
                                         float* __restrict__ du,
                                         float* __restrict__ dv, int H, int W,
                                         int P) {
  extern __shared__ float taps[];  // (P+3) x (P+3)
  const int k = blockIdx.x;
  const int n = P + 3;
  const int s = scale[k];
  const float sf = (float)s;
  const float u = pc[2 * k + 0];
  const float v = pc[2 * k + 1];
  // int32 arithmetic wraps as the plain version's does
  const int32_t u_i = (int32_t)((uint32_t)(int32_t)floorf(u / sf) * (uint32_t)s);
  const int32_t v_i = (int32_t)((uint32_t)(int32_t)floorf(v / sf) * (uint32_t)s);

  const int origin = P / 2 + 1;
  for (int t = threadIdx.x; t < n * n; t += blockDim.x) {
    const int e = t / n;
    const int f = t - e * n;
    int r = (int32_t)((uint32_t)v_i + (uint32_t)(e - origin) * (uint32_t)s);
    int c = (int32_t)((uint32_t)u_i + (uint32_t)(f - origin) * (uint32_t)s);
    r = min(max(r, 0), H - 1);
    c = min(max(c, 0), W - 1);
    taps[t] = __ldg(img + (size_t)r * W + c);
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t >= P * P) return;
  const float su = (u - (float)u_i) / sf;
  const float sv = (v - (float)v_i) / sf;
  const float w_tl = (1.0f - su) * (1.0f - sv);
  const float w_tr = su * (1.0f - sv);
  const float w_bl = (1.0f - su) * sv;
  const float w_br = su * sv;
  const int x = t / P;  // row of the patch (v)
  const int y = t - x * P;  // column (u)

  // sample at stride offsets (a, b) in {-1, 0, 1}; grid origin at 1
  auto sample = [&](int a, int b) {
    const float* q = taps + (1 + a + x) * n + (1 + b + y);
    float acc = w_tl * q[0];
    acc = acc + w_tr * q[1];
    acc = acc + w_bl * q[n];
    acc = acc + w_br * q[n + 1];
    return acc;
  };
  const size_t o = (size_t)k * P * P + t;
  val[o] = sample(0, 0);
  du[o] = 0.5f * (sample(0, 1) - sample(0, -1)) / sf;
  dv[o] = 0.5f * (sample(1, 0) - sample(-1, 0)) / sf;
}

}  // namespace

// img (H, W) f32, pc (K, 2) f32, scale (K,) int32 -> val, du, dv (K, P, P)
// f32, all contiguous on the device. Launches on `stream`; returns the
// launch's cudaError_t (0 on success). K = 0 launches nothing.
extern "C" int patches_and_grads_launch(const float* img, const float* pc,
                                        const int32_t* scale, float* val,
                                        float* du, float* dv, int K, int H,
                                        int W, int P, void* stream) {
  if (K == 0) return 0;
  const int n = P + 3;
  int threads = (n * n > P * P ? n * n : P * P);
  threads = (threads + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  const size_t smem = (size_t)n * n * sizeof(float);
  patches_and_grads_kernel<<<K, threads, smem, (cudaStream_t)stream>>>(
      img, pc, scale, val, du, dv, H, W, P);
  return (int)cudaGetLastError();
}
