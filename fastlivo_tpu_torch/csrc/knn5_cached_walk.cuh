// One query's LIO search on its own gathered candidate block, by a group
// of L lanes of one warp: the re-rank of csrc/knn5_plane.cu (the block
// that `cache_knn` gathers once a frame at the prior pose, re-ranked
// against the moved query at every search), walked as the map walks are
// (knn5_tiled_walk.cuh, knn5_hashed_walk.cuh) so that a block of
// lio_cascade.cu runs its lanes alike on every walk. The block is written
// in the same launch, by the gather form of the map walk at the first
// search, and by the same lane that reads it here (lane `sub` of a query
// owns rows sub, sub + L, ... in both): so it is read with coherent loads
// through L2 (__ldcg), never through the read-only path (__ldg), which
// may hold lines of the same scratch from an earlier launch. Include
// after knn5_select.cuh (group_top5, KNN5_BIG) and plane_fit.cuh
// (plane5_fit_as).
#pragma once

#include <stdint.h>

namespace {

// The gathered block as the walk reads it: row i's M candidates and their
// found flags (a point only where found), in the order of the backend's
// knn_candidates
// (tiled_map.neighbor_offsets on the tiled map, voxel_map.neighbor_offsets
// on the hash and dense maps).
struct CachedView {
  const float* cand;     // (n, M, 3)
  const uint8_t* found;  // (n, M)
  int n;                 // rows
};

// Row `row`'s query (qx, qy, qz), world frame: for each of its M rows
// found, the squared distance (dx dx + dy dy) + dz dz to the gathered
// point, KNN5_BIG for a row not found (no point read) -> five rounds of
// min-select, ties to the lowest row (group_top5) -> the plane fit F of
// plane_fit.cuh (FIT_TLS or FIT_REF) and its gate. A row past n reads
// nothing: every candidate is missing. Lane `sub` of the group owns
// candidate rows sub, sub + L, ...; every lane of the warp must call.
// Every lane returns the gate, the plane (ux, uy, uz, d) in pl and the
// fifth-nearest squared distance in dmin.
// RB of a lane's rows of the block, j0, j0 + L, ... (those below M):
// each row's squared distance and point, KNN5_BIG and 0 where not found.
template <int RB, int L>
__device__ __forceinline__ void cached_rows(const float* c, const uint8_t* f, bool in, int j0,
                                            int M, float qx, float qy, float qz,
                                            float (&d2)[RB], float (&cx)[RB], float (&cy)[RB],
                                            float (&cz)[RB]) {
  bool hit[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int j = j0 + L * r;
    hit[r] = in && j < M && __ldcg(f + j) != 0;
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) {  // a lane's found points, all loads together
    const int j = j0 + L * r;
    d2[r] = KNN5_BIG;
    cx[r] = cy[r] = cz[r] = 0.0f;
    if (hit[r]) {
      cx[r] = __ldcg(c + 3 * j + 0);
      cy[r] = __ldcg(c + 3 * j + 1);
      cz[r] = __ldcg(c + 3 * j + 2);
    }
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (hit[r]) {
      const float dx = cx[r] - qx, dy = cy[r] - qy, dz = cz[r] - qz;
      d2[r] = dx * dx + dy * dy + dz * dz;
    }
  }
}

template <int M, int L, int F>
__device__ __forceinline__ bool knn5_cached_walk(const CachedView& cv, int row, float qx,
                                                 float qy, float qz, int sub,
                                                 double threshold, float (&pl)[4],
                                                 float& dmin) {
  constexpr int R = (M + L - 1) / L;  // rows per lane
  const bool in = row < cv.n;
  const float* c = cv.cand + (size_t)(in ? row : 0) * M * 3;
  const uint8_t* f = cv.found + (size_t)(in ? row : 0) * M;
  float d2[R], cx[R], cy[R], cz[R];
  cached_rows<R, L>(c, f, in, sub, M, qx, qy, qz, d2, cx, cy, cz);
  float nx[5], ny[5], nz[5];
  dmin = group_top5<R, L>(d2, cx, cy, cz, sub, nx, ny, nz);
  return plane5_fit_as<F>(nx, ny, nz, threshold, pl);
}

// The generic form: the same re-rank at any M (a runtime value), the
// lane's rows read KNN5_RB at a time into its Top5 and the group's lists
// merged (knn5_select.cuh's group_merge5): the same planes and fifth
// distance bit for bit.
template <int L, int F>
__device__ __forceinline__ bool knn5_cached_walk_any(const CachedView& cv, int M, int row,
                                                     float qx, float qy, float qz, int sub,
                                                     double threshold, float (&pl)[4],
                                                     float& dmin) {
  const bool in = row < cv.n;
  const float* c = cv.cand + (size_t)(in ? row : 0) * M * 3;
  const uint8_t* f = cv.found + (size_t)(in ? row : 0) * M;
  Top5 t;
  top5_clear(t);
  for (int j0 = sub; j0 < M; j0 += L * KNN5_RB) {
    float d2[KNN5_RB], cx[KNN5_RB], cy[KNN5_RB], cz[KNN5_RB];
    cached_rows<KNN5_RB, L>(c, f, in, j0, M, qx, qy, qz, d2, cx, cy, cz);
#pragma unroll
    for (int r = 0; r < KNN5_RB; ++r) top5_push(t, d2[r], j0 + L * r, cx[r], cy[r], cz[r]);
  }
  float nx[5], ny[5], nz[5];
  dmin = group_merge5<L>(t, sub, nx, ny, nz);
  return plane5_fit_as<F>(nx, ny, nz, threshold, pl);
}

}  // namespace
