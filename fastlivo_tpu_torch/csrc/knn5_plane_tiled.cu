// The LIO search in one launch: tiled-map neighbourhood gather, 5-nearest
// selection and centred TLS plane fit, for Hopper.
//
// Replaces the TPU kernel fastlivo_tpu/ops/pallas_lio.py::knn5_plane
// (body `_kernel`, the `pl.pallas_call` at line 219) together with the
// gather that fed it, ops/tiled_map.py::knn_candidates. For each query
// p (the scan point in the world frame):
//   its voxel floor(p / voxel_size) (a true f32 division), plus each of
//   the M = (2r+1)^3 neighbourhood offsets (voxel_map._neighbor_offsets
//   order) -> the tile (voxel >> 3) and in-tile cell, the wrapped
//   directory index and the 31-bit tile hash (_tile_of, _dir_of,
//   _check31 with its murmur mix, bit-identical) -> directory hit when
//   dir_check == hash, pool cell live when cell_check == hash -> squared
//   distance to the stored point, BIG where missing -> five rounds of
//   min-select, ties to the lowest row -> the plane fit and gate of
//   plane_fit.cuh.
// Outputs as knn5_plane.cu: pabcd (N, 4), plane_ok (N,), nd2_5 (N,).
//
// Design: a group of L lanes per query (L = 4 at M = 27, eight queries
// per warp; L = 16 at M = 125), lane j of a group owning candidate rows
// j, j + L, j + 2L, ... (7 or 8 rows). Each lane walks directory -> pool
// for its rows
// itself, so the (N, M, 3) candidate block and its (N, M) index and mask
// tensors of the unfused path are never written; a lane reads a pool
// cell and its point only where its directory entry matched. A round of the top-5 is a local strict-`<` scan
// over the lane's rows and a butterfly over the group (__shfl_xor_sync)
// on (d2, row), the lower row winning a tie; the owning lane hands the
// winner's point over with __shfl_sync. Every lane of a group then
// evaluates the fit, so one pass of the fit's instructions (the bulk of
// a query's: acosf, cosf, two divisions and a square root, unfused
// multiply-adds) serves eight queries at M = 27; the group's first lane
// writes. A first version with a whole warp per query ran the fit once
// per query and took 22 us at N = 16384; N = 16384 queries are now 2048
// warps at M = 27, where the one-thread-per-query kernel had 512. Built
// with -fmad=false and without --use_fast_math,
// it is bit-exact against its plain composition
// knn5_plane_plain(*knn_candidates(...)).
//
// Bound on an H100: the work reads each query (12 B), each distinct
// directory entry the neighbourhoods touch (8 B), each distinct pool cell
// behind a matching entry (4 B of hash) and each distinct live cell's
// point (12 B), and writes 21 B per query; at the LIO path's N = 16384,
// M = 27 the neighbourhoods overlap heavily, so these bytes are few and
// the operations bound it: ~28 per candidate row (indices, directory
// test, selection), a distance per live row, the tile hash once per
// distinct tile of a neighbourhood and ~270 per query (voxel, fit).
// chip_smoke.py counts both from its inputs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "plane_fit.cuh"

namespace {

constexpr float BIG = 3.0e37f;
constexpr int TC = 512;  // cells per tile
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// voxel_map._check31: the chained murmur mix of a tile coordinate, low 31
// bits (uint32 arithmetic wraps as the plain version's masked int64 does)
__device__ __forceinline__ int32_t check31(int32_t x, int32_t y, int32_t z) {
  uint32_t h = fmix32((uint32_t)x * 0x9E3779B1u);
  h = fmix32(h ^ ((uint32_t)y * 0x85EBCA77u));
  h = fmix32(h ^ ((uint32_t)z * 0xC2B2AE3Du));
  return (int32_t)(h & 0x7FFFFFFFu);
}

template <int M, int L>
__global__ void __launch_bounds__(256) knn5_plane_tiled_kernel(
    const float* __restrict__ queries, int n,
    const int32_t* __restrict__ dir_check, const int32_t* __restrict__ dir_slot,
    const int32_t* __restrict__ cell_check, const float* __restrict__ pts,
    const float* __restrict__ voxel_size, const int32_t* __restrict__ log2_dims,
    const int32_t* __restrict__ offsets, int T, float* __restrict__ pabcd,
    uint8_t* __restrict__ plane_ok, float* __restrict__ nd2_5,
    float threshold) {
  constexpr int R = (M + L - 1) / L;  // rows per lane
  const int gid = (int)((blockIdx.x * blockDim.x + threadIdx.x) / L);
  const int lane = threadIdx.x & 31;
  const int sub = lane % L;          // the lane's place in its group
  const int base = lane - sub;       // the group's first lane
  // every lane takes part in the shuffles: a group past the end works on
  // the last query and writes nothing
  const bool live_q = gid < n;
  const int i = live_q ? gid : n - 1;

  const float vs = __ldg(voxel_size);
  const float qx = queries[3 * i + 0];
  const float qy = queries[3 * i + 1];
  const float qz = queries[3 * i + 2];
  const int32_t bx = (int32_t)floorf(qx / vs);
  const int32_t by = (int32_t)floorf(qy / vs);
  const int32_t bz = (int32_t)floorf(qz / vs);
  const int l0 = __ldg(log2_dims + 0);
  const int l1 = __ldg(log2_dims + 1);
  const int l2 = __ldg(log2_dims + 2);

  float d2[R], cx[R], cy[R], cz[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = sub + L * r;
    d2[r] = BIG;
    cx[r] = cy[r] = cz[r] = 0.0f;
    if (j < M) {
      // int32 sums wrap as the plain version's do
      const int32_t kx = (int32_t)((uint32_t)bx + (uint32_t)__ldg(offsets + 3 * j + 0));
      const int32_t ky = (int32_t)((uint32_t)by + (uint32_t)__ldg(offsets + 3 * j + 1));
      const int32_t kz = (int32_t)((uint32_t)bz + (uint32_t)__ldg(offsets + 3 * j + 2));
      const int32_t tx = kx >> 3, ty = ky >> 3, tz = kz >> 3;  // arithmetic
      const int32_t cofs = ((kx & 7) << 6) | ((ky & 7) << 3) | (kz & 7);
      const int32_t dir = ((tx & ((1 << l0) - 1)) << (l1 + l2)) |
                          ((ty & ((1 << l1) - 1)) << l2) |
                          (tz & ((1 << l2) - 1));
      const int32_t chk = check31(tx, ty, tz);
      // two dependent steps, each with its loads issued together: the
      // directory entry (hash and slot), then the pool cell (hash and
      // point)
      const int32_t dchk = __ldg(dir_check + dir);
      const int32_t slot = min(max(__ldg(dir_slot + dir), 0), T - 1);
      if (dchk == chk) {
        const int32_t p = slot * TC + cofs;
        const int32_t cchk = __ldg(cell_check + p);
        const float px = __ldg(pts + 3 * (size_t)p + 0);
        const float py = __ldg(pts + 3 * (size_t)p + 1);
        const float pz = __ldg(pts + 3 * (size_t)p + 2);
        if (cchk == chk) {
          const float dx = px - qx, dy = py - qy, dz = pz - qz;
          d2[r] = dx * dx + dy * dy + dz * dz;
          cx[r] = px;
          cy[r] = py;
          cz[r] = pz;
        }
      }
    }
  }

  float nx[5], ny[5], nz[5];
  float dmin = BIG;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    // the lane's own rows, ascending: strict < keeps the lowest row
    float bd = d2[0];
    int br = sub;
#pragma unroll
    for (int r = 1; r < R; ++r) {
      if (d2[r] < bd) {
        bd = d2[r];
        br = sub + L * r;
      }
    }
    // butterfly over the group on (d2, row); every lane ends with the min
#pragma unroll
    for (int m = L / 2; m >= 1; m >>= 1) {
      const float od = __shfl_xor_sync(FULL, bd, m);
      const int orow = __shfl_xor_sync(FULL, br, m);
      if (od < bd || (od == bd && orow < br)) {
        bd = od;
        br = orow;
      }
    }
    dmin = bd;
    const int owner = base + br % L;
    const int rr = br / L;
    float sx = 0.0f, sy = 0.0f, sz = 0.0f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r == rr) {
        sx = cx[r];
        sy = cy[r];
        sz = cz[r];
      }
    }
    sx = __shfl_sync(FULL, sx, owner);
    sy = __shfl_sync(FULL, sy, owner);
    sz = __shfl_sync(FULL, sz, owner);
    const bool v = dmin < BIG * 0.5f;
    nx[k] = v ? sx : 0.0f;
    ny[k] = v ? sy : 0.0f;
    nz[k] = v ? sz : 0.0f;
    if (lane == owner) {
#pragma unroll
      for (int r = 0; r < R; ++r) d2[r] = (r == rr) ? BIG : d2[r];
    }
  }

  float ux, uy, uz, d;
  const bool ok = plane5_fit(nx, ny, nz, threshold, ux, uy, uz, d);
  if (sub == 0 && live_q) {
    pabcd[4 * i + 0] = ux;
    pabcd[4 * i + 1] = uy;
    pabcd[4 * i + 2] = uz;
    pabcd[4 * i + 3] = d;
    plane_ok[i] = ok ? 1 : 0;
    nd2_5[i] = dmin;
  }
}

template <int M, int L>
int launch(const float* queries, int n, const int32_t* dir_check,
           const int32_t* dir_slot, const int32_t* cell_check, const float* pts,
           const float* voxel_size, const int32_t* log2_dims,
           const int32_t* offsets, int T, float* pabcd, uint8_t* plane_ok,
           float* nd2_5, float threshold, cudaStream_t stream) {
  constexpr int threads = 256;  // 256 / L queries per block
  const int blocks = (int)(((long long)n * L + threads - 1) / threads);
  knn5_plane_tiled_kernel<M, L><<<blocks, threads, 0, stream>>>(
      queries, n, dir_check, dir_slot, cell_check, pts, voxel_size, log2_dims,
      offsets, T, pabcd, plane_ok, nd2_5, threshold);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface for ctypes. queries (n, 3) f32; the tiled map's dir_check,
// dir_slot (D,) int32, cell_check (T*512,) int32, pts (T*512, 3) f32,
// voxel_size () f32, log2_dims (3,) int32; offsets (m, 3) int32 with m 27
// (radius 1) or 125 (radius 2); outputs pabcd (n, 4) f32, plane_ok (n,)
// u8, nd2_5 (n,) f32. All contiguous on the device. Returns the launch's
// cudaError_t (0 = cudaSuccess); n = 0 launches nothing.
extern "C" int knn5_plane_tiled_launch(
    const void* queries, const void* dir_check, const void* dir_slot,
    const void* cell_check, const void* pts, const void* voxel_size,
    const void* log2_dims, const void* offsets, void* pabcd, void* plane_ok,
    void* nd2_5, int n, int m, int T, float threshold, void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto* q = static_cast<const float*>(queries);
  auto* dc = static_cast<const int32_t*>(dir_check);
  auto* ds = static_cast<const int32_t*>(dir_slot);
  auto* cc = static_cast<const int32_t*>(cell_check);
  auto* p = static_cast<const float*>(pts);
  auto* vs = static_cast<const float*>(voxel_size);
  auto* l2 = static_cast<const int32_t*>(log2_dims);
  auto* of = static_cast<const int32_t*>(offsets);
  auto* pa = static_cast<float*>(pabcd);
  auto* ok = static_cast<uint8_t*>(plane_ok);
  auto* nd = static_cast<float*>(nd2_5);
  if (m == 27) {
    return launch<27, 4>(q, n, dc, ds, cc, p, vs, l2, of, T, pa, ok, nd, threshold, s);
  }
  if (m == 125) {
    return launch<125, 16>(q, n, dc, ds, cc, p, vs, l2, of, T, pa, ok, nd, threshold, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
