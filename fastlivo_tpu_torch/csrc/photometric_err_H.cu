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
// Design: one block per tracked point, (P+3)² rounded up to whole warps
// (128 threads at P = 8). Every thread forms the pose and the projection
// itself (a few dozen flops on broadcast loads, no barrier), the block
// loads its taps into shared memory, one thread per pixel forms its 43
// terms in registers, and the block reduces them in a fixed tree: a
// 5-step butterfly (__shfl_xor_sync) in each warp, then the warps in
// index order through shared memory. Each block writes a 44-float partial
// (the 42 sums, its perr, its weight) and its perr. The last block to
// finish (an int ticket: atomicAdd after __threadfence; it then resets
// the counter for the next launch on the stream) stages the G partials
// through shared memory 192 rows at a time, with 24 independent loads in
// flight per thread (a first version whose warps waited on each L2 load
// in turn took 21 us at G = 192), sums each quantity over the rows in a
// fixed order, and writes HT (6, 7), err = Σperr / max(Σw·P·P, 1),
// n_meas and Σperr (over a device mesh the ranks sum [HT | Σperr |
// n_meas] and divide after the sum, vio.photometric_update_levels). No
// float atomics: the result is the same from run to run. The
// sampling and the projection round as the plain version (-fmad=false);
// only the order of the sums over G·P² rows differs from its matmul.
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

namespace {

constexpr int NH = 42;  // [HᵀWH | HᵀWz], 6 x 7 row-major
constexpr int NT = NH + 1;  // a pixel's terms: the 42 products and res_w²
constexpr int NP = NH + 2;  // a block's partial: the 42 sums, perr, weight
constexpr int CH = 192;  // partial rows the last block stages at a time
constexpr int LB = 24;  // loads in flight per thread while staging
constexpr unsigned FULL = 0xffffffffu;
enum { ROBUST_NONE = 0, ROBUST_HUBER = 1, ROBUST_TUKEY = 2 };

struct Args {
  const float* img;
  const float* tr_pos;    // (G, 3)
  const float* tr_patch;  // (G, P, P) level slice, row stride patch_stride
  const int32_t* tr_slevel;
  const uint8_t* tr_valid;
  const double* rot;  // (3, 3) f64
  const double* pos;  // (3,) f64
  const float* Rci;
  const float* Pci;
  const float* Jdphi_dR;
  const float* Jdp_dR;
  const float* fx;
  const float* fy;
  const float* cx;
  const float* cy;
  const float* dist;  // (4,) k1, k2, p1, p2
  float* partial;     // (G, NP) scratch
  int* ticket;        // one int, 0 between launches
  float* out;         // HT (42), err, n_meas, Σperr
  float* perr;        // (G,)
  int H, W, P, level, patch_stride, robust;
  float k_h, inv_b, inv_rs;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
  return v;
}

__global__ void photometric_err_H_kernel(const Args a) {
  extern __shared__ float smem[];
  __shared__ int s_last;
  const int n = a.P + 3;
  const int nwarps = blockDim.x >> 5;
  float* taps = smem;                // n * n
  float* red = taps + n * n;         // max(nwarps x NT, CH x NP)
  float* tot = red + (nwarps * NT > CH * NP ? nwarps * NT : CH * NP);  // NP
  const int g = blockIdx.x;
  const int G = gridDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // camera pose: rcw = Rci @ rot32ᵀ, pcw = -(rcw @ pos32) + Pci, each
  // 3-term product sum left to right (the plain version's _rows_times)
  float r32[9], p32[3], rcw[9], pcw[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) r32[k] = (float)a.rot[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) p32[k] = (float)a.pos[k];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      rcw[3 * i + j] = (a.Rci[3 * i + 0] * r32[3 * j + 0] +
                        a.Rci[3 * i + 1] * r32[3 * j + 1]) +
                       a.Rci[3 * i + 2] * r32[3 * j + 2];
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pcw[i] = -((rcw[3 * i + 0] * p32[0] + rcw[3 * i + 1] * p32[1]) +
               rcw[3 * i + 2] * p32[2]) + a.Pci[i];
  }
  const float X = a.tr_pos[3 * g + 0];
  const float Y = a.tr_pos[3 * g + 1];
  const float Z = a.tr_pos[3 * g + 2];
  float pf[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pf[i] = ((X * rcw[3 * i + 0] + Y * rcw[3 * i + 1]) + Z * rcw[3 * i + 2]) +
            pcw[i];
  }

  // camera.world2cam (camera.py: distort, then fx * xd + cx)
  const float fx = *a.fx, fy = *a.fy, cx = *a.cx, cy = *a.cy;
  const float k1 = a.dist[0], k2 = a.dist[1], p1 = a.dist[2], p2 = a.dist[3];
  const float xn = pf[0] / pf[2];
  const float yn = pf[1] / pf[2];
  const float r2 = xn * xn + yn * yn;
  const float radial = (1.0f + k1 * r2) + (k2 * r2) * r2;
  const float xd = (xn * radial + ((2.0f * p1) * xn) * yn) +
                   p2 * (r2 + (2.0f * xn) * xn);
  const float yd = (yn * radial + p1 * (r2 + (2.0f * yn) * yn)) +
                   ((2.0f * p2) * xn) * yn;
  const float u = fx * xd + cx;
  const float v = fy * yd + cy;
  const bool front = pf[2] > 1e-6f;

  const int s = (1 << a.level) << a.tr_slevel[g];
  const PatchAnchor an = patch_anchor(u, v, s);
  load_taps(a.img, a.H, a.W, an, s, a.P, taps, tid, blockDim.x);

  // N = Jdpi · Mg (2 x 6), Mg = [skew(pf)·Jdphi_dR - Jdp_dR | -rcw]
  const float zi = 1.0f / (front ? pf[2] : 1.0f);
  const float zi2 = zi * zi;
  const float J[2][3] = {{fx * zi, 0.0f, ((-fx) * pf[0]) * zi2},
                         {0.0f, fy * zi, ((-fy) * pf[1]) * zi2}};
  const float ph[3][3] = {{0.0f, -pf[2], pf[1]},
                          {pf[2], 0.0f, -pf[0]},
                          {-pf[1], pf[0], 0.0f}};
  float Mg[3][6];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
#pragma unroll
    for (int f = 0; f < 3; ++f) {
      Mg[d][f] = ((ph[d][0] * a.Jdphi_dR[0 * 3 + f] +
                   ph[d][1] * a.Jdphi_dR[1 * 3 + f]) +
                  ph[d][2] * a.Jdphi_dR[2 * 3 + f]) -
                 a.Jdp_dR[3 * d + f];
      Mg[d][3 + f] = -rcw[3 * d + f];
    }
  }
  float N0[6], N1[6];
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    N0[f] = (J[0][0] * Mg[0][f] + J[0][1] * Mg[1][f]) + J[0][2] * Mg[2][f];
    N1[f] = (J[1][0] * Mg[0][f] + J[1][1] * Mg[1][f]) + J[1][2] * Mg[2][f];
  }
  const float w = (a.tr_valid[g] != 0 && front) ? 1.0f : 0.0f;
  __syncthreads();  // taps loaded

  float acc[NT];
#pragma unroll
  for (int q = 0; q < NT; ++q) acc[q] = 0.0f;
  if (tid < a.P * a.P) {
    const int x = tid / a.P;  // patch row (v)
    const int y = tid - x * a.P;  // column (u)
    float val, du, dv;
    patch_val_grad(taps, n, an, x, y, val, du, dv);
    const float res = val - a.tr_patch[(size_t)g * a.patch_stride + tid];
    float h[6];
#pragma unroll
    for (int f = 0; f < 6; ++f) h[f] = du * N0[f] + dv * N1[f];
    const float res_w = res * w;
    acc[NH] = res_w * res_w;
    float wr = w;
    if (a.robust != ROBUST_NONE) {
      const float t = fabsf(res) * a.inv_rs;
      float wh;
      if (a.robust == ROBUST_HUBER) {
        wh = fminf(a.k_h / fmaxf(t, 1e-12f), 1.0f);
      } else {
        const float tb = t * a.inv_b;
        const float uu = fminf(fmaxf(1.0f - tb * tb, 0.0f), 1.0f);
        wh = uu * uu;
      }
      wr = w * wh;
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float hw = h[i] * wr;
#pragma unroll
      for (int j = 0; j < 6; ++j) acc[7 * i + j] = hw * h[j];
      acc[7 * i + 6] = hw * res;
    }
  }

  // block sums: a butterfly in each warp, then the warps in order
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    const float t = warp_sum(acc[q]);
    if (lane == 0) red[warp * NT + q] = t;
  }
  __syncthreads();
  if (tid < NT) {
    float t = red[tid];
    for (int k = 1; k < nwarps; ++k) t = t + red[k * NT + tid];
    a.partial[(size_t)g * NP + tid] = t;
    if (tid == NH) a.perr[g] = t;
  } else if (tid == NT) {
    a.partial[(size_t)g * NP + NT] = w;
  }
  __threadfence();  // the partial is visible before the ticket is taken
  __syncthreads();
  if (tid == 0) s_last = (atomicAdd(a.ticket, 1) == G - 1);
  __syncthreads();
  if (!s_last) return;

  // the last block: the G partials, CH rows at a time through shared
  // memory (every thread keeps LB independent loads in flight), each
  // quantity summed by one thread over the rows in order, in eight
  // interleaved partial sums
  __threadfence();
  float* rows = red;  // CH x NP, over the no longer needed warp sums
  float t[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int g0 = 0; g0 < G; g0 += CH) {
    const int nr = min(CH, G - g0);
    const int nv = nr * NP;
    const float* src = a.partial + (size_t)g0 * NP;
    for (int b = 0; b < nv; b += LB * blockDim.x) {
      float v[LB];
#pragma unroll
      for (int j = 0; j < LB; ++j) {
        const int e = b + j * blockDim.x + tid;
        v[j] = e < nv ? __ldcg(src + e) : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < LB; ++j) {
        const int e = b + j * blockDim.x + tid;
        if (e < nv) rows[e] = v[j];
      }
    }
    __syncthreads();
    if (tid < NP) {
      int r = 0;
      for (; r + 8 <= nr; r += 8) {
#pragma unroll
        for (int j = 0; j < 8; ++j) t[j] = t[j] + rows[(r + j) * NP + tid];
      }
      for (; r < nr; ++r) t[0] = t[0] + rows[r * NP + tid];
    }
    __syncthreads();
  }
  if (tid < NP) tot[tid] = ((t[0] + t[1]) + (t[2] + t[3])) + ((t[4] + t[5]) + (t[6] + t[7]));
  __syncthreads();
  if (tid < NH) a.out[tid] = tot[tid];
  if (tid == 0) {
    const float n_meas = fmaxf(tot[NT] * (float)a.P * (float)a.P, 1.0f);
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
// f32; scratch partial (G, 44) f32 and ticket (one int, 0); outputs out
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
  if (G <= 0 || P < 1 || P > 16) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.img = static_cast<const float*>(img);
  a.tr_pos = static_cast<const float*>(tr_pos);
  a.tr_patch = static_cast<const float*>(tr_patch);
  a.tr_slevel = static_cast<const int32_t*>(tr_slevel);
  a.tr_valid = static_cast<const uint8_t*>(tr_valid);
  a.rot = static_cast<const double*>(rot);
  a.pos = static_cast<const double*>(pos);
  a.Rci = static_cast<const float*>(Rci);
  a.Pci = static_cast<const float*>(Pci);
  a.Jdphi_dR = static_cast<const float*>(Jdphi_dR);
  a.Jdp_dR = static_cast<const float*>(Jdp_dR);
  a.fx = static_cast<const float*>(fx);
  a.fy = static_cast<const float*>(fy);
  a.cx = static_cast<const float*>(cx);
  a.cy = static_cast<const float*>(cy);
  a.dist = static_cast<const float*>(dist);
  a.partial = static_cast<float*>(partial);
  a.ticket = static_cast<int*>(ticket);
  a.out = static_cast<float*>(out);
  a.perr = static_cast<float*>(perr);
  a.H = H;
  a.W = W;
  a.P = P;
  a.level = level;
  a.patch_stride = patch_stride;
  a.robust = robust;
  a.k_h = k_h;
  a.inv_b = inv_b;
  a.inv_rs = inv_rs;
  const int n = P + 3;
  // (P+3)^2 >= P*P pixels, and at least the NP threads that write the
  // partial
  const int warps_px = (n * n + 31) / 32;
  const int threads = 32 * (warps_px > 2 ? warps_px : 2);
  const int nwarps = threads / 32;
  const int red = nwarps * NT > CH * NP ? nwarps * NT : CH * NP;
  const size_t smem = (size_t)(n * n + red + NP) * sizeof(float);
  photometric_err_H_kernel<<<G, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
