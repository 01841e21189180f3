// The LIO search in one launch on the hash map and on the dense grid:
// the map's neighbourhood lookup, 5-nearest selection and centred TLS
// plane fit, for Hopper.
//
// Replaces the TPU kernel fastlivo_tpu/ops/pallas_lio.py::knn5_plane
// (body `_kernel`, the `pl.pallas_call` at line 219) together with the
// gather that fed it, ops/voxel_map.py::knn_candidates (hash) or
// ops/dense_map.py::knn_candidates (dense). For each query p (the scan
// point in the world frame):
//   its voxel floor(p / voxel_size) (a true f32 division), plus each of
//   the M = (2r+1)^3 neighbourhood offsets (neighbor_offsets order,
//   wrapping int32 sums) ->
//   hash: z = the voxel's murmur mix (hash_mix.cuh); the chain starts at
//     slot (z >> 13) & (T - 1) (the JAX package's 19-bit slot, kept for
//     parity) and probes max_probe slots, slot + 1 each, wrapping; the
//     FIRST slot whose check equals z & 0x7FFFFFFF holds the voxel. An
//     empty slot does not end the chain: delete_boxes leaves holes, and
//     the plain version probes past them;
//   dense: the cell is each coordinate & (dim - 1) (two's complement),
//     found when its check equals the voxel's 31-bit hash (an aliased
//     occupant is not found) ->
//   squared distance to the stored point, KNN5_BIG where missing (no
//   point read) -> five rounds of min-select, ties to the lowest row ->
//   the plane fit and gate of plane_fit.cuh.
// Outputs as knn5_plane.cu: pabcd (N, 4), plane_ok (N,), nd2_5 (N,).
//
// Design: the walk is knn5_hashed_walk.cuh, which csrc/lio_cascade.cu
// runs inside the LIO cascade; the lane groups of knn5_plane_tiled.cu
// (L = 4 lanes per query at M = 27, L = 16 at M = 125 and at any other M,
// the walk's generic form; lane j owns rows
// j, j + L, ...; the group selection of knn5_select.cuh, the fit on
// every lane, the first lane writes). No (N, M, 3) candidate block, index or mask tensor is
// written: the unfused path's knn_candidates was 12 probe rounds of
// small torch ops, ~98% of the search. A lane mixes each of its rows'
// keys itself (the key varies per row). The probes run in rounds over
// all of the lane's rows at once, so the loads of up to R rows are in
// flight together: a round reads four consecutive check words with one
// 16-byte load (T is a multiple of 4, so an aligned group of four never
// straddles the wrap) and takes them in chain order; a row leaves at its
// first match or after max_probe slots. A table not 16-byte aligned, or
// of fewer than 4 slots, probes one word a load. Points are read only
// for found rows, all of a lane's together. Built with -fmad=false and
// without --use_fast_math, it is bit-exact against its plain
// composition knn5_plane_plain(*knn_candidates(...)): the plain version
// gathers a point for a missing row too (the table's last slot, or the
// aliased occupant), but a missing row's d2 is KNN5_BIG and its pick is
// zeroed either way.
//
// Bound on an H100: the work reads each query (12 B), each distinct
// check word the chains probe (4 B) and each distinct found point
// (12 B), and writes 21 B per query; at the LIO path's N = 16384,
// M = 27 the neighbourhoods overlap, so the bytes are few and the
// operations bound it: the murmur mix per candidate row, each probe
// compare taken (a missing voxel takes all max_probe), a distance per
// found row, the selection and ~270 per query (voxel, fit).
// chip_smoke.py counts both from its inputs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_mix.cuh"
#include "knn5_select.cuh"
#include "plane_fit.cuh"
#include "knn5_hashed_walk.cuh"

namespace {

// M = 0: the walk's generic form at m candidates (knn5_hashed_walk_any)
template <int B, int M, int L>
__global__ void __launch_bounds__(256) knn5_plane_hashed_kernel(
    const float* __restrict__ queries, int n, int m, const HashedView mp,
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
    ok = knn5_hashed_walk_any<B, L>(mp, m, queries[3 * i + 0], queries[3 * i + 1],
                                    queries[3 * i + 2], sub, threshold, pl, dmin);
  else
    ok = knn5_hashed_walk<B, M, L>(mp, queries[3 * i + 0], queries[3 * i + 1],
                                   queries[3 * i + 2], sub, threshold, pl, dmin);
  if (sub == 0 && live_q) {
    pabcd[4 * i + 0] = pl[0];
    pabcd[4 * i + 1] = pl[1];
    pabcd[4 * i + 2] = pl[2];
    pabcd[4 * i + 3] = pl[3];
    plane_ok[i] = ok ? 1 : 0;
    nd2_5[i] = dmin;
  }
}

template <int B, int M, int L>
int launch(const float* queries, int n, int m, const int32_t* check, const float* pts,
           const float* voxel_size, const int32_t* log2_dims, const int32_t* offsets,
           int T, int max_probe, float* pabcd, uint8_t* plane_ok, float* nd2_5,
           float threshold, cudaStream_t stream) {
  constexpr int threads = 256;  // 256 / L queries per block
  const int blocks = (int)(((long long)n * L + threads - 1) / threads);
  const bool vec = T >= 4 && (reinterpret_cast<uintptr_t>(check) & 15) == 0;
  const HashedView mp{check, pts, voxel_size, log2_dims, offsets, T, max_probe, vec};
  knn5_plane_hashed_kernel<B, M, L><<<blocks, threads, 0, stream>>>(
      queries, n, m, mp, pabcd, plane_ok, nd2_5, threshold);
  return (int)cudaGetLastError();
}

template <int B>
int dispatch(int m, const float* q, int n, const int32_t* c, const float* p,
             const float* vs, const int32_t* l2, const int32_t* of, int T,
             int max_probe, float* pa, uint8_t* ok, float* nd, float threshold,
             cudaStream_t s) {
  if (m == 27) {
    return launch<B, 27, 4>(q, n, m, c, p, vs, l2, of, T, max_probe, pa, ok, nd, threshold, s);
  }
  if (m == 125) {
    return launch<B, 125, 16>(q, n, m, c, p, vs, l2, of, T, max_probe, pa, ok, nd, threshold,
                              s);
  }
  if (m >= 1) {
    return launch<B, 0, 16>(q, n, m, c, p, vs, l2, of, T, max_probe, pa, ok, nd, threshold, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// C interface for ctypes. queries (n, 3) f32; the map's check (T,) int32
// and pts (T, 3) f32 (T a power of two: the hash table's slots or the
// dense grid's cells), voxel_size () f32, log2_dims (3,) int32 (dense;
// unread for the hash map); offsets (m, 3) int32 with m = (2r+1)^3 for
// any radius r >= 0 (27 and 125 the templated walks, any other m the
// generic form); backend 0 = hash (max_probe slots a row), 1 = dense;
// outputs pabcd (n, 4) f32, plane_ok (n,) u8, nd2_5 (n,) f32. All
// contiguous on the device. Returns the launch's cudaError_t (0 =
// cudaSuccess); n = 0 launches nothing.
extern "C" int knn5_plane_hashed_launch(
    const void* queries, const void* check, const void* pts, const void* voxel_size,
    const void* log2_dims, const void* offsets, void* pabcd, void* plane_ok,
    void* nd2_5, int n, int m, int T, int backend, int max_probe, float threshold,
    void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto* q = static_cast<const float*>(queries);
  auto* c = static_cast<const int32_t*>(check);
  auto* p = static_cast<const float*>(pts);
  auto* vs = static_cast<const float*>(voxel_size);
  auto* l2 = static_cast<const int32_t*>(log2_dims);
  auto* of = static_cast<const int32_t*>(offsets);
  auto* pa = static_cast<float*>(pabcd);
  auto* ok = static_cast<uint8_t*>(plane_ok);
  auto* nd = static_cast<float*>(nd2_5);
  if (backend == HASH) {
    return dispatch<HASH>(m, q, n, c, p, vs, l2, of, T, max_probe, pa, ok, nd, threshold, s);
  }
  if (backend == DENSE) {
    return dispatch<DENSE>(m, q, n, c, p, vs, l2, of, T, max_probe, pa, ok, nd, threshold, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
