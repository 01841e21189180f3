// One photometric iteration's measurement, shared by
// csrc/photometric_err_H.cu (one iteration per launch) and
// csrc/photometric_cascade.cu (the whole cascade in one launch), so that
// the two cannot drift apart: per tracked point the projection, the
// (P+3)^2 taps, the 43 terms per pixel and the block's fixed-order sums
// (measure_point), and over the G points the fixed-order sum of their
// partials (reduce_partials, the order of ops/photometric.py::
// partials_sum). Include after patch_sample.cuh. Each expression follows
// ops/photometric.py::photometric_err_H_plain in its order of operations
// (built with -fmad=false), and so do the sums: the plain version writes
// the per-point order out (ops/photometric.py::point_sums).
#pragma once

#include <stdint.h>

namespace {

constexpr int NH = 42;      // [HᵀWH | HᵀWz], 6 x 7 row-major
constexpr int NT = NH + 1;  // a pixel's terms: the 42 products and res_w²
constexpr int NP = NH + 2;  // a point's partial: the 42 sums, perr, weight
constexpr int NCH = 8 * NP;  // the reduction's chains: 8 interleaved per quantity
constexpr int RB = 24;       // rows of a chain loaded at once
constexpr unsigned FULL = 0xffffffffu;
enum { ROBUST_NONE = 0, ROBUST_HUBER = 1, ROBUST_TUKEY = 2 };

// The measurement's inputs that stay fixed over a cascade.
struct Meas {
  const float* img;
  const float* tr_pos;    // (G, 3)
  const float* tr_patch;  // (G, ..., P, P): point g's plane of a level at
                          // g * patch_stride + plane offset
  const int32_t* tr_slevel;
  const uint8_t* tr_valid;
  const float* Rci;
  const float* Pci;
  const float* Jdphi_dR;
  const float* Jdp_dR;
  const float* fx;
  const float* fy;
  const float* cx;
  const float* cy;
  const float* dist;  // (4,) k1, k2, p1, p2
  int G, H, W, P, patch_stride, robust;
  float k_h, inv_b, inv_rs;
};

// The measuring threads of a block: (P+3)^2 rounded up to whole warps, at
// least two warps (the NP threads that write a partial), at most
// MEAS_MAX_THREADS (every P <= 16 below it: one thread a pixel there).
// ops/photometric.py::meas_threads is the same function.
constexpr int MEAS_MAX_THREADS = 384;
__host__ __device__ inline int meas_threads(int P) {
  const int n = P + 3;
  const int warps_px = (n * n + 31) / 32;
  const int t = 32 * (warps_px > 2 ? warps_px : 2);
  return t < MEAS_MAX_THREADS ? t : MEAS_MAX_THREADS;
}

// Shared floats of the staged taps: (P+3)^2, or none where they are read
// in place (patch_sample.cuh's taps_staged).
__host__ __device__ inline int taps_floats(int P) {
  return taps_staged(P) ? (P + 3) * (P + 3) : 0;
}

// Shared floats of a block: the taps, the warp sums or the reduction's
// chain sums, and the reduction's totals.
__host__ __device__ inline int meas_red_floats(int threads) {
  const int nwarps = threads / 32;
  return nwarps * NT > NCH ? nwarps * NT : NCH;
}

// A barrier of the first nt threads of the block (nt a multiple of 32):
// the measurement's, which the warps past them do not join.
__device__ __forceinline__ void meas_sync(int nt) {
  asm volatile("bar.sync 1, %0;" ::"r"(nt) : "memory");
}
__host__ __device__ inline int meas_smem_floats(int P, int threads) {
  return taps_floats(P) + meas_red_floats(threads) + NP;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(FULL, v, m);
  return v;
}

// The pose (rot (3, 3), pos (3,), f64) as f32 in shared memory: twelve
// loads through L2 (so a pose another block wrote before a grid barrier
// is seen) for the whole block, then a barrier.
__device__ __forceinline__ void load_pose(const double* rot, const double* pos,
                                          float* pose) {
  const int tid = threadIdx.x;
  if (tid < 12) pose[tid] = (float)(tid < 9 ? __ldcg(rot + tid) : __ldcg(pos + tid - 9));
  __syncthreads();
}

// Point g's measurement at the pose in `pose` (rot32 (9), pos32 (3), in
// shared memory) and pyramid `level`, by the block's first nt threads
// (meas_threads(P), a multiple of 32; their own barriers): writes the
// 44-float partial[g] (the 42 sums, its perr, its weight) and perr[g].
// `patch` is tr_patch offset to the level's plane. STAGED
// (taps_staged(P)): the taps in shared memory, else read in place. The
// order of the sums: thread t holds the terms of pixels t, t + nt, ...
// summed in that order (the first as it is; a thread with no pixel holds
// zeros), then a butterfly in each warp, then the warps in index order.
template <bool STAGED>
__device__ __forceinline__ void measure_point(const Meas& a, const float* pose, int level,
                                              const float* patch, int g, float* smem,
                                              float* partial, float* perr, int nt) {
  const int n = a.P + 3;
  const int nwarps = nt >> 5;
  float* taps = smem;                    // n * n when STAGED
  float* red = taps + taps_floats(a.P);  // nwarps x NT
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // camera pose: rcw = Rci @ rot32ᵀ, pcw = -(rcw @ pos32) + Pci, each
  // 3-term product sum left to right (the plain version's _rows_times)
  float r32[9], p32[3], rcw[9], pcw[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) r32[k] = pose[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) p32[k] = pose[9 + k];
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

  const int s = (1 << level) << a.tr_slevel[g];
  const PatchAnchor an = patch_anchor(u, v, s);
  if (STAGED) load_taps(a.img, a.H, a.W, an, s, a.P, taps, tid, nt);

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
  meas_sync(nt);  // taps loaded

  const StagedTaps staged{taps, n};
  const ImageTaps direct{a.img, a.H, a.W, s, a.P / 2 + 1, an};
  float acc[NT];
#pragma unroll
  for (int q = 0; q < NT; ++q) acc[q] = 0.0f;
  for (int p = tid; p < a.P * a.P; p += nt) {
    const bool first = p == tid;
    const int x = p / a.P;  // patch row (v)
    const int y = p - x * a.P;  // column (u)
    float val, du, dv;
    if (STAGED) {
      patch_val_grad(staged, an, x, y, val, du, dv);
    } else {
      patch_val_grad(direct, an, x, y, val, du, dv);
    }
    const float res = val - patch[(size_t)g * a.patch_stride + p];
    float h[6];
#pragma unroll
    for (int f = 0; f < 6; ++f) h[f] = du * N0[f] + dv * N1[f];
    const float res_w = res * w;
    acc[NH] = first ? res_w * res_w : acc[NH] + res_w * res_w;
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
      for (int j = 0; j < 6; ++j) acc[7 * i + j] = first ? hw * h[j] : acc[7 * i + j] + hw * h[j];
      acc[7 * i + 6] = first ? hw * res : acc[7 * i + 6] + hw * res;
    }
  }

  // block sums: a butterfly in each warp, then the warps in order
#pragma unroll
  for (int q = 0; q < NT; ++q) {
    const float t = warp_sum(acc[q]);
    if (lane == 0) red[warp * NT + q] = t;
  }
  meas_sync(nt);
  if (tid < NT) {
    float t = red[tid];
    for (int k = 1; k < nwarps; ++k) t = t + red[k * NT + tid];
    partial[(size_t)g * NP + tid] = t;
    if (tid == NH) perr[g] = t;
  } else if (tid == NT) {
    partial[(size_t)g * NP + NT] = w;
  }
}

// The G partials summed by the whole block into tot[0:NP] (shared
// memory) in a fixed order: quantity q's rows g < G8 = G - G % 8 in eight
// interleaved chains (row g into chain g % 8, in row order), the last G %
// 8 rows after chain 0's, each chain from 0.0f; then ((t0 + t1) + (t2 +
// t3)) + ((t4 + t5) + (t6 + t7)). Each of the 8 x NP chains is one
// thread's, read through L2 RB rows at a time, a thread's two chains at
// once. Ends with a block barrier; tot then holds the 42 sums, Σperr and
// Σweight.
__device__ __forceinline__ void reduce_partials(const float* partial, int G, float* smem,
                                                int P) {
  const int tid = threadIdx.x, nt = blockDim.x;
  float* chains = smem + taps_floats(P);  // NCH, over the warp sums
  float* tot = chains + meas_red_floats(nt);
  const int G8 = G - (G & 7);
  for (int u0 = tid; u0 < NCH; u0 += 2 * nt) {
    const int u[2] = {u0, u0 + nt};
    const bool two = u[1] < NCH;
    int jj[2], q[2];
    float t[2] = {0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      jj[k] = (two || k == 0 ? u[k] : u[0]) / NP;
      q[k] = (two || k == 0 ? u[k] : u[0]) - jj[k] * NP;
    }
    int g = 0;  // chain k's rows jj[k] + g, jj[k] + g + 8, ...
    for (; g + 8 * (RB - 1) + 7 < G8; g += 8 * RB) {
      float v[2][RB];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int i = 0; i < RB; ++i)
          v[k][i] = __ldcg(partial + (size_t)(jj[k] + g + 8 * i) * NP + q[k]);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k) {
#pragma unroll
        for (int i = 0; i < RB; ++i) t[k] = t[k] + v[k][i];
      }
    }
    for (; g < G8; g += 8) {
#pragma unroll
      for (int k = 0; k < 2; ++k) t[k] = t[k] + __ldcg(partial + (size_t)(jj[k] + g) * NP + q[k]);
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (jj[k] == 0) {
        for (int r = G8; r < G; ++r) t[k] = t[k] + __ldcg(partial + (size_t)r * NP + q[k]);
      }
    }
    chains[u[0]] = t[0];
    if (two) chains[u[1]] = t[1];
  }
  __syncthreads();
  if (tid < NP) {
    const float* c = chains + tid;
    tot[tid] = ((c[0] + c[NP]) + (c[2 * NP] + c[3 * NP])) +
               ((c[4 * NP] + c[5 * NP]) + (c[6 * NP] + c[7 * NP]));
  }
  __syncthreads();
}

// The totals' shared-memory address (reduce_partials' output).
__device__ __forceinline__ float* meas_tot(float* smem, int P) {
  return smem + taps_floats(P) + meas_red_floats(blockDim.x);
}

}  // namespace
