// The LIO cascade kernel, its launch and its C entry points, shared by
// csrc/lio_cascade.cu (the templated walks at M = 27), lio_cascade_125.cu
// (at M = 125, LIO_CASCADE_M 125) and lio_cascade_any.cu (the walks'
// generic form at any other M, LIO_CASCADE_M 0), three libraries built in
// parallel, 12, 12 and 6 instances: see lio_cascade.cu for what it
// computes. Include after cooperative_groups.h,
// hash_mix.cuh, knn5_select.cuh, plane_fit.cuh, the three walks, so3.cuh,
// ekf_step.cuh and phase_stamps.cuh.
#pragma once

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;
constexpr int CH = 64;  // rows of a chunk, and sums of a group at every level
constexpr unsigned FULL_MASK = 0xffffffffu;
// the walk: HASH, DENSE (knn5_hashed_walk.cuh) or TILED (knn5_tiled_walk.cuh)
constexpr int TILED = 2;
constexpr int ANY_M = 0;  // the instances of the walks' generic form: M = c.m

struct Lio {
  TiledView mp;             // the tiled map (TILED)
  HashedView hp;            // the hash map or the dense grid (HASH, DENSE)
  float* cand;              // (n, M, 3) the block `cache_knn` gathers (G), scratch
  uint8_t* found;           // (n, M)
  const float* p_imu;       // (n, 3) the scan in the IMU frame
  const float* bns;         // (n,) |p_body|^(1/2)
  const uint8_t* pmask;     // (n,)
  const double* Pp;         // (18, 18) P' = prior.cov / laser_point_cov
  const double* prior_rot;  // (3, 3)
  const double* prior_x;    // (15,)
  const double* rot0;       // (3, 3) the state's
  const double* x0;         // (15,)
  float* part;              // scratch (2, 42, stride): the chunk sums by parity
  float* gsum;              // scratch (2, 42, gstride): the group sums by parity
  int* tickets;             // scratch (groups1(nch),): 0 between launches
  int stride, gstride;      // max(nch, 1), max(groups1(nch), 1), rounded up to 4
  double* rot_out;          // (3, 3)
  double* x_out;            // (15,)
  double* Gmat;             // (18, 6)
  uint8_t* sel_out;         // (n,)
  float* pabcd_out;         // (n, 4)
  uint8_t* ok_out;          // (n,)
  int* its;                 // ()
  int n, m, nch, cpb, max_iter;  // m = (2r+1)^3 candidates a query
  double threshold;             // the plane fit's (cast down to f32 for the TLS fit)
  float sq_dist_gate, s_gate, res_gate;
  double conv_rot_deg, conv_pos_cm;
};

// Groups of 64 at the first level of the chunk sums' reduction, and at
// the second.
__host__ __device__ constexpr int groups1(int nch) { return (nch + CH - 1) / CH; }
__host__ __device__ constexpr int groups2(int nch) { return (groups1(nch) + CH - 1) / CH; }

// The block's dynamic shared memory for `cpb` chunks of nch: per owned
// row p_imu (3), |p|^(1/2) (1) and the plane (4) as floats; the chunk's
// world points (3 x 64) and its products (64 x 42), or a group's chunk
// sums (42 x 64); the level sums above the first (42 x groups1, 42 x
// groups2, in turn); one byte of flags per owned row (bit 0 pmask, 1 sel,
// 2 plane_ok).
__host__ __device__ constexpr size_t smem_bytes(int cpb, int nch) {
  return (size_t)(8 * cpb * CH + 3 * CH + CH * EKF_NH
                  + EKF_NH * (groups1(nch) + groups2(nch))) * sizeof(float)
         + (size_t)cpb * CH;
}

// 16 bytes from device memory (through L2, as another block wrote them
// before the grid barrier) into shared memory, asynchronously: no register
// holds them, so a thread keeps all its pieces in flight at once
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// The halving tree of ops/lio_cascade.py::fixed_order_sum over 64 values,
// lane i holding values i and i + 32: their sum, then lanes i and i + 16,
// 8, 4, 2, 1. The total in lane 0.
__device__ __forceinline__ float tree64_pair(float lo, float hi) {
  float v = lo + hi;
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) v = v + __shfl_down_sync(FULL_MASK, v, s);
  return v;
}

// Warp `warp` of the block sums columns warp, warp + 8, ... of a chunk's
// (64, 42) rows in red; column c's sum goes to out[c * ostride].
__device__ __forceinline__ void tree64(const float* red, float* out, int ostride, int warp,
                                       int lane) {
  for (int col = warp; col < EKF_NH; col += NWARP) {
    const float v = tree64_pair(red[lane * EKF_NH + col], red[(lane + 32) * EKF_NH + col]);
    if (lane == 0) out[(size_t)col * ostride] = v;
  }
}

// One level of the fixed order, by the whole block, from shared memory:
// the cnt values of each of the 42 columns (value i of column c at in[c *
// stride + i]) in groups of 64, zeros past cnt, each group summed by
// tree64_pair into out[c * ostride + group], a warp's (group, column)
// pairs four at a time.
__device__ void tree_level(const float* in, int stride, int cnt, float* out, int ostride,
                           int warp, int lane) {
  constexpr int TB = 4;
  const int T = groups1(cnt) * EKF_NH;
  for (int t0 = warp; t0 < T; t0 += NWARP * TB) {
    float lo[TB], hi[TB];
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const int t = t0 + b * NWARP;
      const int g = t / EKF_NH, col = t - g * EKF_NH;
      const int i = g * CH + lane;
      const float* src = in + col * stride;
      lo[b] = t < T && i < cnt ? src[i] : 0.0f;
      hi[b] = t < T && i + 32 < cnt ? src[i + 32] : 0.0f;
    }
#pragma unroll
    for (int b = 0; b < TB; ++b) {
      const float v = tree64_pair(lo[b], hi[b]);
      const int t = t0 + b * NWARP;
      if (lane == 0 && t < T) out[(t % EKF_NH) * ostride + t / EKF_NH] = v;
    }
  }
}

// The sum of group g of the chunk sums (chunks 64 g .. 64 g + cnt - 1,
// column-major in part, column stride `stride`), by the block whose chunk
// completed the group: the group's 42 columns staged into `stage` (42 x
// 64; cp.async through L2, every piece in flight at once), tree64_pair
// over each (zeros past cnt), column c's sum to gsum[c * gstride + g].
__device__ void group_sum(const float* part, int stride, int g, int cnt, float* stage,
                          float* gsum, int gstride, int tid) {
  const int q = (cnt + 3) >> 2;  // 16-byte pieces a column
  for (int e = tid; e < EKF_NH * q; e += THREADS) {
    const int col = e / q, k = e - col * q;
    cp_async16(stage + col * CH + 4 * k, part + (size_t)col * stride + g * CH + 4 * k);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  tree_level(stage, CH, cnt, gsum + g, gstride, tid >> 5, tid & 31);
}

// tot (42) from the chunk sums in the fixed order, after the grid
// barrier: one chunk is its own total; otherwise the group sums (gsum,
// column stride gstride, formed before the barrier by group_sum) and,
// with more than one group, the levels above them in the block's shared
// memory (lv1 holds the group sums, then lv2 and lv1 in turn), groups of
// 64 until one is left. Every thread of the block calls; ends with a
// block barrier. Past 64² chunks (n > 262144) there is a third level and
// more, each in the same two buffers.
__device__ void reduce_chunks(const float* part, int stride, const float* gsum, int gstride,
                              int nch, float* lv1, float* lv2, float* tot, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  int cnt = groups1(nch);
  if (cnt <= 1) {
    if (tid < EKF_NH)
      tot[tid] = nch == 0 ? 0.0f
                          : __ldcg(nch == 1 ? part + (size_t)tid * stride : gsum + tid * gstride);
    __syncthreads();
    return;
  }
  for (int e = tid; e < EKF_NH * cnt; e += THREADS) {
    const int col = e / cnt, g = e - col * cnt;
    lv1[e] = __ldcg(gsum + col * gstride + g);
  }
  __syncthreads();
  float* bufs[2] = {lv1, lv2};
  for (int level = 1; cnt > 1; ++level) {
    const float* in = bufs[(level & 1) ^ 1];
    const int groups = groups1(cnt);
    float* out = groups == 1 ? tot : bufs[level & 1];
    tree_level(in, cnt, cnt, out, groups == 1 ? 1 : groups, warp, lane);
    __syncthreads();
    cnt = groups;
  }
}

// The search of the query of row `row` with the plane fit F: walk W's on
// the map; with G (`cache_knn`) at the first search the walk's gather form,
// which writes the row's block (nothing for a row past n), and at every
// later search the re-rank of that block. The gather form and the re-rank
// are two calls, never live together, so an instance holds the registers
// of the larger. M = 27 and 125 are the walks' templated form; M = ANY_M
// their generic form at the launch's c.m candidates.
template <int W, bool G, int M, int L, int F>
__device__ __forceinline__ bool map_walk(const Lio& c, bool first, int row, float qx, float qy,
                                         float qz, int sub, float (&pl)[4], float& dmin) {
  const int m = M == ANY_M ? c.m : M;
  // the generic instances gather or not at run time (G = true covers both)
  const bool g = M == ANY_M ? c.cand != nullptr : G;
  if constexpr (G) {
    if (g && !first) {
      const CachedView cv{c.cand, c.found, c.n};
      if constexpr (M == ANY_M)
        return knn5_cached_walk_any<L, F>(cv, m, row, qx, qy, qz, sub, c.threshold, pl, dmin);
      else
        return knn5_cached_walk<M, L, F>(cv, row, qx, qy, qz, sub, c.threshold, pl, dmin);
    }
  }
  const bool out = g && row < c.n;
  float* gc = out ? c.cand + (size_t)row * m * 3 : nullptr;
  uint8_t* gf = out ? c.found + (size_t)row * m : nullptr;
  if constexpr (W == TILED) {
    if constexpr (M == ANY_M)
      return knn5_tiled_walk_any<L, F, G>(c.mp, m, qx, qy, qz, sub, c.threshold, pl, dmin, gc,
                                          gf);
    else
      return knn5_tiled_walk<M, L, F, G>(c.mp, qx, qy, qz, sub, c.threshold, pl, dmin, gc, gf);
  } else {
    if constexpr (M == ANY_M)
      return knn5_hashed_walk_any<W, L, F, G>(c.hp, m, qx, qy, qz, sub, c.threshold, pl, dmin,
                                              gc, gf);
    else
      return knn5_hashed_walk<W, M, L, F, G>(c.hp, qx, qy, qz, sub, c.threshold, pl, dmin, gc,
                                             gf);
  }
}

template <int W, bool G, int M, int L, int F>
__global__ void __launch_bounds__(THREADS, 2) lio_cascade_kernel(const Lio c) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Step st;
  __shared__ Prior pr;
  __shared__ float pose[12];  // rot (3, 3) and pos (3) in f32
  __shared__ float tot[EKF_NH];
  __shared__ double crot[9], cx[NX];                // the pose in force
  __shared__ int it_s, rematch_s, search_s, stop_s;  // the state machine
  __shared__ int last_s;                             // this block completed a group
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool lead = blockIdx.x == 0;
  const int R = c.cpb * CH;  // rows a block owns
  PHASE_STAMP_START();
  float* s_p = smem;          // (3, R) p_imu
  float* s_bns = s_p + 3 * R;  // (R,)
  float* s_pl = s_bns + R;    // (4, R) the plane
  float* s_pw = s_pl + 4 * R;  // (3, CH) a chunk's world points
  float* red = s_pw + 3 * CH;  // (CH, 42) a chunk's products
  float* lv1 = red + CH * EKF_NH;               // (42, groups1)
  float* lv2 = lv1 + EKF_NH * groups1(c.nch);  // (42, groups2)
  uint8_t* s_fl = reinterpret_cast<uint8_t*>(lv2 + EKF_NH * groups2(c.nch));  // (R,) flags

  // the owned rows: chunk k of this block is blockIdx.x + k * gridDim.x
  for (int e = tid; e < R; e += THREADS) {
    const int row = (blockIdx.x + (e / CH) * gridDim.x) * CH + e % CH;
    const bool in = row < c.n && blockIdx.x + (e / CH) * gridDim.x < c.nch;
    for (int j = 0; j < 3; ++j) s_p[j * R + e] = in ? c.p_imu[3 * (size_t)row + j] : 0.0f;
    s_bns[e] = in ? c.bns[row] : 1.0f;
    s_fl[e] = in ? (c.pmask[row] ? 1 : 0) : 0;
  }
  if (tid < 9) crot[tid] = c.rot0[tid];
  if (tid < NX) cx[tid] = c.x0[tid];
  if (tid == 0) {
    it_s = -1;
    rematch_s = stop_s = 0;
    search_s = 1;
  }
  load_prior(c.Pp, c.prior_rot, c.prior_x, pr, tid, THREADS);

  for (int iter = 0;; ++iter) {
    PHASE_STAMP_IT(iter, 0);
    float* part = c.part + (size_t)(iter & 1) * EKF_NH * c.stride;
    float* gsum = c.gsum + (size_t)(iter & 1) * EKF_NH * c.gstride;
    const bool search = search_s != 0;
    // the pose in f32, as the plain version casts it (rot.to(f32))
    if (tid < 12) pose[tid] = (float)(tid < 9 ? crot[tid] : cx[tid - 9]);
    __syncthreads();

    for (int k = 0; k < c.cpb; ++k) {
      const int chunk = blockIdx.x + k * gridDim.x;
      if (chunk >= c.nch) break;  // uniform over the block
      const int r0 = k * CH;
      // the chunk's world points: p_imu rot32ᵀ + pos32, three products
      // summed left to right (lio.world_points)
      if (tid < CH) {
        const float px = s_p[r0 + tid], py = s_p[R + r0 + tid], pz = s_p[2 * R + r0 + tid];
#pragma unroll
        for (int j = 0; j < 3; ++j)
          s_pw[j * CH + tid] =
              ((px * pose[3 * j] + py * pose[3 * j + 1]) + pz * pose[3 * j + 2]) + pose[9 + j];
      }
      __syncthreads();
      if (search) {
        // L lanes a query: THREADS / L queries a pass (rows past n walk at
        // a harmless point, or read no block, and write nothing); the
        // first iteration always searches
        for (int q0 = 0; q0 < CH; q0 += THREADS / L) {
          const int q = q0 + tid / L, sub = tid % L;
          float pl[4], dmin;
          const bool ok = map_walk<W, G, M, L, F>(c, iter == 0, chunk * CH + q, s_pw[q],
                                                  s_pw[CH + q], s_pw[2 * CH + q], sub, pl,
                                                  dmin);
          if (sub == 0 && chunk * CH + q < c.n) {
            const int lr = r0 + q;
#pragma unroll
            for (int j = 0; j < 4; ++j) s_pl[j * R + lr] = pl[j];
            const int pm = s_fl[lr] & 1;
            const int sel = pm && dmin <= c.sq_dist_gate;
            s_fl[lr] = (uint8_t)(pm | (sel << 1) | ((ok ? 1 : 0) << 2));
          }
        }
        __syncthreads();
      }
      // the gates, the H row and its 42 products (zeros past n); the
      // last warp forms the step's vec meanwhile
      if (tid < CH) {
        const int lr = r0 + tid;
        float* out = red + tid * EKF_NH;
        if (chunk * CH + tid < c.n) {
          const float px = s_pw[tid], py = s_pw[CH + tid], pz = s_pw[2 * CH + tid];
          const float a = s_pl[lr], b = s_pl[R + lr], cc = s_pl[2 * R + lr],
                      d = s_pl[3 * R + lr];
          const float pd2 = ((a * px + b * py) + cc * pz) + d;
          const float s = 1.0f - (0.9f * fabsf(pd2)) / s_bns[lr];
          const int fl = s_fl[lr];
          const int sel = ((fl >> 1) & 1) && ((fl >> 2) & 1) && s > c.s_gate;
          s_fl[lr] = (uint8_t)((fl & 5) | (sel << 1));
          const float w = (sel && fabsf(pd2) <= c.res_gate) ? 1.0f : 0.0f;
          // Rᵀn: (n0 R[0][j] + n1 R[1][j]) + n2 R[2][j]
          float v[3];
#pragma unroll
          for (int j = 0; j < 3; ++j) v[j] = (a * pose[j] + b * pose[3 + j]) + cc * pose[6 + j];
          const float ix = s_p[lr], iy = s_p[R + lr], iz = s_p[2 * R + lr];
          const float h[6] = {iy * v[2] - iz * v[1], iz * v[0] - ix * v[2],
                              ix * v[1] - iy * v[0], a, b, cc};
          const float rhs[7] = {h[0], h[1], h[2], h[3], h[4], h[5], -pd2};
#pragma unroll
          for (int r = 0; r < 6; ++r) {
            const float hw = h[r] * w;
#pragma unroll
            for (int q = 0; q < 7; ++q) out[r * 7 + q] = hw * rhs[q];
          }
        } else {
          for (int e = 0; e < EKF_NH; ++e) out[e] = 0.0f;
        }
      } else if (k == 0 && warp == NWARP - 1) {
        step_vec(pr, crot, cx, st.vec, lane);
      }
      __syncthreads();
      tree64(red, part + chunk, c.stride, warp, lane);
      if (c.nch > 1) {  // the block that completes a group of 64 sums it
        __threadfence();  // the chunk sum is visible before the ticket is taken
        __syncthreads();
        const int g = chunk / CH, cnt = min(CH, c.nch - g * CH);
        if (tid == 0) {
          last_s = atomicAdd(c.tickets + g, 1) == cnt - 1;
          if (last_s) c.tickets[g] = 0;  // every other chunk of g has taken one
        }
        __syncthreads();
        if (last_s) {
          __threadfence();
          group_sum(part, c.stride, g, cnt, red, gsum, c.gstride, tid);
        }
      }
      __syncthreads();
    }
    if (blockIdx.x >= c.nch && warp == NWARP - 1) step_vec(pr, crot, cx, st.vec, lane);
    PHASE_STAMP_IT(iter, 1);
    grid.sync();
    PHASE_STAMP_IT(iter, 2);

    reduce_chunks(part, c.stride, gsum, c.gstride, c.nch, lv1, lv2, tot, tid);
    if (tid < 6) tot[7 * tid + 6] = -tot[7 * tid + 6];  // the photometric form
    __syncthreads();
    PHASE_STAMP_IT(iter, 3);
    if (warp == 0) step_warp(pr, crot, cx, tot, st, lane, c.conv_rot_deg, c.conv_pos_cm, 0);
    __syncthreads();
    PHASE_STAMP_IT(iter, 4);
    if (tid == 0) {
      const int it = it_s;
      const bool rematch = st.conv || (rematch_s == 0 && it == c.max_iter - 2);
      rematch_s += rematch ? 1 : 0;
      const bool stop = rematch_s >= 2 || it == c.max_iter - 1;
      it_s = it + 1;
      for (int k = 0; k < 9; ++k) crot[k] = st.nrot[k];
      for (int k = 0; k < NX; ++k) cx[k] = st.nx[k];
      search_s = rematch ? 1 : 0;
      stop_s = stop ? 1 : 0;
    }
    __syncthreads();
    PHASE_STAMP_IT(iter, 5);
    if (stop_s) break;
  }

  for (int e = tid; e < R; e += THREADS) {
    const int chunk = blockIdx.x + (e / CH) * gridDim.x;
    const int row = chunk * CH + e % CH;
    if (chunk < c.nch && row < c.n) {
      c.sel_out[row] = (s_fl[e] >> 1) & 1;
      c.ok_out[row] = (s_fl[e] >> 2) & 1;
      for (int j = 0; j < 4; ++j) c.pabcd_out[4 * (size_t)row + j] = s_pl[j * R + e];
    }
  }
  if (lead) {
    if (tid < 9) c.rot_out[tid] = crot[tid];
    if (tid < NX) c.x_out[tid] = cx[tid];
    step_gain(st, 0, c.Gmat, tid, THREADS);
    if (tid == 0) *c.its = it_s + 1;
  }
  PHASE_STAMP(1);
}

template <int W, bool G, int M, int L, int F>
int launch(Lio& c, int* grid_out, cudaStream_t stream) {
  auto kernel = lio_cascade_kernel<W, G, M, L, F>;
  int dev = 0, sms = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // chunks per block: the fewest for which the grid is co-resident
  int cpb = 1, grid = 1;
  size_t smem = 0;
  for (;;) {
    smem = smem_bytes(cpb, c.nch);
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    int per_sm = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    const int resident = per_sm * sms;
    grid = c.nch < 1 ? 1 : (c.nch + cpb - 1) / cpb;
    if (grid <= resident) break;
    cpb = (c.nch + resident - 1) / resident;
  }
  c.cpb = cpb;
  *grid_out = grid;
  void* args[] = {&c};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(THREADS), args, smem,
                                  stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

#ifndef LIO_CASCADE_M
#define LIO_CASCADE_M 27  // the library's candidates: 27, 125, or 0 (any m)
#endif

#if LIO_CASCADE_M == 0
// The generic walks' instances (lio_cascade_any.cu): any m >= 1, 16 lanes
// a query, G = true for both searches (c.cand null: the walk at every
// search; set: `cache_knn`'s gather form, then the re-rank), with the fit
// `fit`.
template <int W>
int launch_walk(Lio& c, int m, int fit, int* grid_out, cudaStream_t s) {
  if ((c.cand == nullptr) != (c.found == nullptr) || m < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  c.m = m;
  if (fit == FIT_TLS) return launch<W, true, ANY_M, 16, FIT_TLS>(c, grid_out, s);
  if (fit == FIT_REF) return launch<W, true, ANY_M, 16, FIT_REF>(c, grid_out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
#else
// The instance of walk W, gathering the block or not (G), at the library's
// LIO_CASCADE_M candidates (lio_cascade.cu: 27, 4 lanes a query;
// lio_cascade_125.cu: 125, 16; any other m is lio_cascade_any.cu's, the
// walks' generic form, which was 7-15% slower than the templated walk at
// 125: scripts/torch_lio_cascade_bench.py) with the fit `fit`.
template <int W, bool G, int F>
int launch_m(Lio& c, int m, int* grid_out, cudaStream_t s) {
  c.m = m;
  constexpr int L = LIO_CASCADE_M == 27 ? 4 : 16;
  if (m == LIO_CASCADE_M) return launch<W, G, LIO_CASCADE_M, L, F>(c, grid_out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int W, bool G>
int launch_fit(Lio& c, int m, int fit, int* grid_out, cudaStream_t s) {
  if (fit == FIT_TLS) return launch_m<W, G, FIT_TLS>(c, m, grid_out, s);
  if (fit == FIT_REF) return launch_m<W, G, FIT_REF>(c, m, grid_out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The instance of walk W: with the block (c.cand and c.found both set,
// `cache_knn`) its gather form, without it the walk at every search.
template <int W>
int launch_walk(Lio& c, int m, int fit, int* grid_out, cudaStream_t s) {
  if ((c.cand == nullptr) != (c.found == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return c.cand ? launch_fit<W, true>(c, m, fit, grid_out, s)
                : launch_fit<W, false>(c, m, fit, grid_out, s);
}
#endif

}  // namespace

PHASE_STAMPS_EXPORT(lio_cascade)

namespace {

// The fields of c that do not depend on the map.
void fill(Lio& c, const void* p_imu, const void* bns, const void* pmask, const void* Pp,
          const void* prior_rot, const void* prior_x, const void* rot0, const void* x0,
          void* part, void* gsum, void* tickets, void* rot_out, void* x_out, void* Gmat,
          void* sel_out, void* pabcd_out, void* ok_out, void* its, void* cand_out,
          void* found_out, int n, int max_iter, double threshold, float sq_dist_gate,
          float s_gate, float res_gate, double conv_rot_deg, double conv_pos_cm) {
  c.p_imu = static_cast<const float*>(p_imu);
  c.bns = static_cast<const float*>(bns);
  c.pmask = static_cast<const uint8_t*>(pmask);
  c.Pp = static_cast<const double*>(Pp);
  c.prior_rot = static_cast<const double*>(prior_rot);
  c.prior_x = static_cast<const double*>(prior_x);
  c.rot0 = static_cast<const double*>(rot0);
  c.x0 = static_cast<const double*>(x0);
  c.part = static_cast<float*>(part);
  c.gsum = static_cast<float*>(gsum);
  c.tickets = static_cast<int*>(tickets);
  c.rot_out = static_cast<double*>(rot_out);
  c.x_out = static_cast<double*>(x_out);
  c.Gmat = static_cast<double*>(Gmat);
  c.sel_out = static_cast<uint8_t*>(sel_out);
  c.pabcd_out = static_cast<float*>(pabcd_out);
  c.ok_out = static_cast<uint8_t*>(ok_out);
  c.its = static_cast<int*>(its);
  c.cand = static_cast<float*>(cand_out);
  c.found = static_cast<uint8_t*>(found_out);
  c.n = n;
  c.nch = (n + CH - 1) / CH;
  c.stride = ((c.nch < 1 ? 1 : c.nch) + 3) & ~3;
  c.gstride = ((groups1(c.nch) < 1 ? 1 : groups1(c.nch)) + 3) & ~3;
  c.cpb = 1;
  c.max_iter = max_iter;
  c.threshold = threshold;
  c.sq_dist_gate = sq_dist_gate;
  c.s_gate = s_gate;
  c.res_gate = res_gate;
  c.conv_rot_deg = conv_rot_deg;
  c.conv_pos_cm = conv_pos_cm;
}

}  // namespace

// The cascade on n >= 0 points: the tiled map (dir_check, dir_slot (D,)
// int32, cell_check (T*512,) int32, pts (T*512, 3) f32, voxel_size () f32,
// log2_dims (3,) int32) and the offsets (m, 3) int32, m = (2r+1)^3: the
// library's LIO_CASCADE_M (27 or 125), or any m >= 1 in
// lio_cascade_any.cu's (cudaErrorInvalidValue otherwise); p_imu (n, 3) f32, bns (n,) f32, pmask (n,) u8; P' (18,
// 18), the prior's rot (3, 3) and x (15,), the state's rot and x, f64;
// scratch part (2, 42, stride) and gsum (2, 42, gstride) f32 (by the
// iteration's parity) and tickets (max(groups, 1),) int32, zero before
// the launch and left at zero, with nch = ceil(n / 64), groups = ceil(nch
// / 64), stride = max(nch, 1) and gstride = max(groups, 1), each rounded
// up to a multiple of 4; outputs rot (3, 3), x (15,), Gmat (18, 6) f64, sel
// (n,) u8, pabcd (n, 4) f32, plane_ok (n,) u8 and its () int32; under
// `cache_knn` the block, scratch the first search writes and the later
// ones read, cand_out (n, m, 3) f32 and found_out (n, m) u8 (found flags
// everywhere, points where found), both null without it. All
// contiguous on the device. The plane fit (`fit` 0: TLS, 1: the
// reference's) and its threshold, the gates on nd2_5, s and |pd2|, and the
// convergence thresholds in degrees and centimetres. `grid_out` receives
// the number of blocks launched. Returns the launch's cudaError_t (0 =
// cudaSuccess); cudaErrorCooperativeLaunchTooLarge where not even one
// block fits on an SM (or the shared memory of a huge n does not fit).
extern "C" int lio_cascade_launch(
    const void* dir_check, const void* dir_slot, const void* cell_check, const void* pts,
    const void* voxel_size, const void* log2_dims, const void* offsets, const void* p_imu,
    const void* bns, const void* pmask, const void* Pp, const void* prior_rot,
    const void* prior_x, const void* rot0, const void* x0, void* part, void* gsum,
    void* tickets, void* rot_out, void* x_out, void* Gmat, void* sel_out, void* pabcd_out,
    void* ok_out, void* its, void* cand_out, void* found_out, int n, int m, int T, int fit,
    int max_iter, double threshold, float sq_dist_gate, float s_gate, float res_gate,
    double conv_rot_deg, double conv_pos_cm, int* grid_out, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  Lio c{};
  c.mp = TiledView{static_cast<const int32_t*>(dir_check), static_cast<const int32_t*>(dir_slot),
                   static_cast<const int32_t*>(cell_check), static_cast<const float*>(pts),
                   static_cast<const float*>(voxel_size), static_cast<const int32_t*>(log2_dims),
                   static_cast<const int32_t*>(offsets), T};
  fill(c, p_imu, bns, pmask, Pp, prior_rot, prior_x, rot0, x0, part, gsum, tickets, rot_out,
       x_out, Gmat, sel_out, pabcd_out, ok_out, its, cand_out, found_out, n, max_iter,
       threshold, sq_dist_gate, s_gate, res_gate, conv_rot_deg, conv_pos_cm);
  return launch_walk<TILED>(c, m, fit, grid_out, static_cast<cudaStream_t>(stream));
}

// The cascade on the hash map (backend 0: check (T,) int32 and pts (T, 3)
// f32 of its T slots, max_probe slots a row) or the dense grid (backend
// 1: its T cells, log2_dims (3,) int32; max_probe unread), voxel_size ()
// f32, T a power of two; every other argument as lio_cascade_launch's.
extern "C" int lio_cascade_hashed_launch(
    const void* check, const void* pts, const void* voxel_size, const void* log2_dims,
    const void* offsets, const void* p_imu, const void* bns, const void* pmask, const void* Pp,
    const void* prior_rot, const void* prior_x, const void* rot0, const void* x0, void* part,
    void* gsum, void* tickets, void* rot_out, void* x_out, void* Gmat, void* sel_out,
    void* pabcd_out, void* ok_out, void* its, void* cand_out, void* found_out, int n, int m,
    int T, int backend, int max_probe, int fit, int max_iter, double threshold,
    float sq_dist_gate, float s_gate, float res_gate, double conv_rot_deg, double conv_pos_cm,
    int* grid_out, void* stream) {
  if (n < 0 || T < 1 || (T & (T - 1)) || max_probe < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Lio c{};
  const auto* chk = static_cast<const int32_t*>(check);
  c.hp = HashedView{chk, static_cast<const float*>(pts), static_cast<const float*>(voxel_size),
                    static_cast<const int32_t*>(log2_dims), static_cast<const int32_t*>(offsets),
                    T, max_probe, T >= 4 && (reinterpret_cast<uintptr_t>(chk) & 15) == 0};
  fill(c, p_imu, bns, pmask, Pp, prior_rot, prior_x, rot0, x0, part, gsum, tickets, rot_out,
       x_out, Gmat, sel_out, pabcd_out, ok_out, its, cand_out, found_out, n, max_iter,
       threshold, sq_dist_gate, s_gate, res_gate, conv_rot_deg, conv_pos_cm);
  auto s = static_cast<cudaStream_t>(stream);
  if (backend == HASH) return launch_walk<HASH>(c, m, fit, grid_out, s);
  if (backend == DENSE) return launch_walk<DENSE>(c, m, fit, grid_out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
