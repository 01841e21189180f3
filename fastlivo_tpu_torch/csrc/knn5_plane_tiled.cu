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
//   distance to the stored point, KNN5_BIG where missing -> five rounds of
//   min-select, ties to the lowest row -> the plane fit and gate of
//   plane_fit.cuh.
// Outputs as knn5_plane.cu: pabcd (N, 4), plane_ok (N,), nd2_5 (N,).
// That per-query walk is knn5_tiled_walk.cuh, which csrc/lio_cascade.cu
// runs inside the LIO cascade on one card; this launch is the search of
// the LIO host loop (a device mesh, the smoke run's comparisons).
//
// Design: a group of L lanes per query (L = 4 at M = 27, eight queries
// per warp; L = 16 at M = 125 and at any other M, where the walk's generic
// form streams a lane's rows into its own five nearest), lane j of a group owning candidate rows
// j, j + L, j + 2L, ... (7 or 8 rows). Each lane walks directory -> pool
// for its rows itself, so the (N, M, 3) candidate block and its (N, M)
// index and mask tensors of the unfused path are never written; a lane
// reads a pool cell and its point only where its directory entry
// matched. The top-5 is knn5_select.cuh's group selection (a strict-`<`
// scan over the lane's rows, a butterfly over the group on (d2, row),
// the lower row winning a tie), the tile hash hash_mix.cuh's murmur
// chain; both are shared with the other 5-NN kernels. Every lane of a
// group then
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

#include "hash_mix.cuh"
#include "knn5_select.cuh"
#include "plane_fit.cuh"
#include "knn5_tiled_walk.cuh"

namespace {

// M = 0: the walk's generic form at m candidates (knn5_tiled_walk_any)
template <int M, int L>
__global__ void __launch_bounds__(256) knn5_plane_tiled_kernel(
    const float* __restrict__ queries, int n, int m, const TiledView mp,
    float* __restrict__ pabcd, uint8_t* __restrict__ plane_ok, float* __restrict__ nd2_5,
    float threshold) {
  const int gid = (int)((blockIdx.x * blockDim.x + threadIdx.x) / L);
  const int sub = (threadIdx.x & 31) % L;  // the lane's place in its group
  // every lane takes part in the shuffles: a group past the end works on
  // the last query and writes nothing
  const bool live_q = gid < n;
  const int i = live_q ? gid : n - 1;

  float pl[4], dmin;
  bool ok;
  if constexpr (M == 0)
    ok = knn5_tiled_walk_any<L>(mp, m, queries[3 * i + 0], queries[3 * i + 1],
                                queries[3 * i + 2], sub, threshold, pl, dmin);
  else
    ok = knn5_tiled_walk<M, L>(mp, queries[3 * i + 0], queries[3 * i + 1], queries[3 * i + 2],
                               sub, threshold, pl, dmin);
  if (sub == 0 && live_q) {
    pabcd[4 * i + 0] = pl[0];
    pabcd[4 * i + 1] = pl[1];
    pabcd[4 * i + 2] = pl[2];
    pabcd[4 * i + 3] = pl[3];
    plane_ok[i] = ok ? 1 : 0;
    nd2_5[i] = dmin;
  }
}

template <int M, int L>
int launch(const float* queries, int n, int m, const TiledView& mp, float* pabcd, uint8_t* plane_ok,
           float* nd2_5, float threshold, cudaStream_t stream) {
  constexpr int threads = 256;  // 256 / L queries per block
  const int blocks = (int)(((long long)n * L + threads - 1) / threads);
  knn5_plane_tiled_kernel<M, L><<<blocks, threads, 0, stream>>>(queries, n, m, mp, pabcd,
                                                                plane_ok, nd2_5, threshold);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface for ctypes. queries (n, 3) f32; the tiled map's dir_check,
// dir_slot (D,) int32, cell_check (T*512,) int32, pts (T*512, 3) f32,
// voxel_size () f32, log2_dims (3,) int32; offsets (m, 3) int32 with m =
// (2r+1)^3 for any radius r >= 0 (27 and 125 the templated walks, any
// other m the generic form); outputs pabcd (n, 4) f32, plane_ok (n,)
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
  const TiledView mp{static_cast<const int32_t*>(dir_check), static_cast<const int32_t*>(dir_slot),
                     static_cast<const int32_t*>(cell_check), static_cast<const float*>(pts),
                     static_cast<const float*>(voxel_size), static_cast<const int32_t*>(log2_dims),
                     static_cast<const int32_t*>(offsets), T};
  auto* pa = static_cast<float*>(pabcd);
  auto* ok = static_cast<uint8_t*>(plane_ok);
  auto* nd = static_cast<float*>(nd2_5);
  if (m == 27) return launch<27, 4>(q, n, m, mp, pa, ok, nd, threshold, s);
  if (m == 125) return launch<125, 16>(q, n, m, mp, pa, ok, nd, threshold, s);
  if (m >= 1) return launch<0, 16>(q, n, m, mp, pa, ok, nd, threshold, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
