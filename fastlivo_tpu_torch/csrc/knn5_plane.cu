// Fused 5-nearest-neighbour selection + centred TLS plane fit, for Hopper.
//
// Replaces the TPU kernel fastlivo_tpu/ops/pallas_lio.py::knn5_plane
// (body `_kernel`, the `pl.pallas_call` at line 219): for each LIO query,
//   squared distance to its M gathered map candidates (missing ones
//   masked to BIG) -> five rounds of min-select, ties to the lowest row
//   -> the centred total-least-squares plane through the five picks
//   (missing picks are zeros and still count as points) -> the gate
//   "normal found and all five picks within `threshold` of the plane".
//
// Design: one thread per query. The M squared distances live in
// registers (the loops over rows are unrolled, M is a template
// parameter), each round is a strict `<` scan over rows 0..M-1, so the
// lowest row wins a tie. The plane algebra (plane_fit.cuh, shared with
// knn5_plane_tiled.cu) is a transcription of plane.sym3x3_min_eigvec
// with the real acosf/cosf/sqrtf (the TPU kernel used a polynomial acos
// because Mosaic had none). Build without
// --use_fast_math (the fit needs the accurate functions) and with
// -fmad=false, so every product rounds as in the plain PyTorch version
// (ops/knn_plane.py::knn5_plane_plain), which sums in the same order.
//
// Bound on an H100: memory. Per query it reads M*12 candidate bytes,
// M mask bytes and 12 query bytes and writes 16 + 1 + 4 bytes: ~384 B at
// M = 27, ~6.3 MB at N = 16384 -> ~1.9 us at 3.35 TB/s. The arithmetic
// (~500 flops per query) is far below the card's float32 rate.
//
// The LIO search does not call this kernel: it runs knn5_plane_tiled.cu,
// which walks the tiled map itself instead of reading the (N, M, 3) block
// that a separate gather wrote (the TPU left the gather outside only
// because a TPU kernel cannot gather). This kernel keeps the TPU kernel's
// signature and stays as its counterpart.

#include <cuda_runtime.h>
#include <stdint.h>

#include "plane_fit.cuh"

namespace {

constexpr float BIG = 3.0e37f;

template <int M>
__global__ void knn5_plane_kernel(const float* __restrict__ cand,
                                  const uint8_t* __restrict__ found,
                                  const float* __restrict__ queries,
                                  float* __restrict__ pabcd,
                                  uint8_t* __restrict__ plane_ok,
                                  float* __restrict__ nd2_5, int n,
                                  float threshold) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* c = cand + (size_t)i * M * 3;
  const uint8_t* f = found + (size_t)i * M;
  const float qx = queries[3 * i + 0];
  const float qy = queries[3 * i + 1];
  const float qz = queries[3 * i + 2];

  float d2[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const float dx = c[3 * j + 0] - qx;
    const float dy = c[3 * j + 1] - qy;
    const float dz = c[3 * j + 2] - qz;
    d2[j] = f[j] ? dx * dx + dy * dy + dz * dz : BIG;
  }

  float nx[5], ny[5], nz[5];
  float dmin = BIG;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    dmin = d2[0];
    int pick = 0;
#pragma unroll
    for (int j = 1; j < M; ++j) {
      if (d2[j] < dmin) {
        dmin = d2[j];
        pick = j;
      }
    }
    const bool v = dmin < BIG * 0.5f;
    nx[k] = v ? c[3 * pick + 0] : 0.0f;
    ny[k] = v ? c[3 * pick + 1] : 0.0f;
    nz[k] = v ? c[3 * pick + 2] : 0.0f;
#pragma unroll
    for (int j = 0; j < M; ++j) d2[j] = (j == pick) ? BIG : d2[j];
  }

  // centred TLS plane (all five picks count, missing ones as zeros)
  float ux, uy, uz, d;
  const bool ok = plane5_fit(nx, ny, nz, threshold, ux, uy, uz, d);

  pabcd[4 * i + 0] = ux;
  pabcd[4 * i + 1] = uy;
  pabcd[4 * i + 2] = uz;
  pabcd[4 * i + 3] = d;
  plane_ok[i] = ok ? 1 : 0;
  nd2_5[i] = dmin;
}

template <int M>
void launch(const float* cand, const uint8_t* found, const float* queries,
            float* pabcd, uint8_t* plane_ok, float* nd2_5, int n,
            float threshold, cudaStream_t stream) {
  constexpr int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  knn5_plane_kernel<M><<<blocks, threads, 0, stream>>>(
      cand, found, queries, pabcd, plane_ok, nd2_5, n, threshold);
}

}  // namespace

// C interface for ctypes. m must be 27 (radius 1) or 125 (radius 2).
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int knn5_plane_launch(const void* cand, const void* found,
                                 const void* queries, void* pabcd,
                                 void* plane_ok, void* nd2_5, int n, int m,
                                 float threshold, void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<const float*>(cand);
  auto* f = static_cast<const uint8_t*>(found);
  auto* q = static_cast<const float*>(queries);
  auto* pa = static_cast<float*>(pabcd);
  auto* ok = static_cast<uint8_t*>(plane_ok);
  auto* nd = static_cast<float*>(nd2_5);
  if (m == 27) {
    launch<27>(c, f, q, pa, ok, nd, n, threshold, s);
  } else if (m == 125) {
    launch<125>(c, f, q, pa, ok, nd, n, threshold, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
