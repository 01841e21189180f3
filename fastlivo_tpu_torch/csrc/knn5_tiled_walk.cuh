// One query's LIO search on the tiled map, by a group of L lanes of one
// warp: the neighbourhood walk (directory -> pool), the five nearest and
// the plane fit (the TLS fit, or the reference's inside the LIO cascade).
// Shared by csrc/knn5_plane_tiled.cu (the search alone) and
// csrc/lio_cascade.cu (the search inside the LIO cascade), so that the
// two give the same planes bit for bit. Include after hash_mix.cuh
// (check31), knn5_select.cuh (group_top5, KNN5_BIG) and plane_fit.cuh
// (plane5_fit_as).
#pragma once

#include <stdint.h>

namespace {

constexpr int TILE_CELLS = 512;  // cells per tile (8 x 8 x 8 voxels)

// The tiled map as the walk reads it (ops/tiled_map.TiledMap), and the
// neighbourhood offsets (m, 3) int32 of voxel_map._neighbor_offsets.
struct TiledView {
  const int32_t* dir_check;   // (D,)
  const int32_t* dir_slot;    // (D,)
  const int32_t* cell_check;  // (T * 512,)
  const float* pts;           // (T * 512, 3)
  const float* voxel_size;    // ()
  const int32_t* log2_dims;   // (3,)
  const int32_t* offsets;     // (M, 3)
  int T;                      // pool tiles
};

// The query (qx, qy, qz), world frame: its voxel floor(q / voxel_size) (a
// true f32 division), plus each of the M = (2r+1)^3 offsets -> the tile
// (voxel >> 3) and in-tile cell, the wrapped directory index and the
// 31-bit tile hash -> directory hit when dir_check == hash, pool cell live
// when cell_check == hash -> squared distance to the stored point,
// KNN5_BIG where missing -> five rounds of min-select, ties to the lowest
// row (group_top5) -> the plane fit F of plane_fit.cuh (FIT_TLS or
// FIT_REF) and its gate. Lane `sub` of the group owns candidate rows sub,
// sub + L, ...; every lane of the warp must call. Every lane returns the
// gate, the plane (ux, uy, uz, d) in pl and the fifth-nearest squared
// distance in dmin. The gather form (G, lio_cascade.cu's first search
// under `cache_knn`) also writes each of the lane's rows into the query's
// block where gfound is not null: gfound[j] the row's found flag and,
// where found, gcand[3 j ..] its point (tiled_map.knn_candidates' found
// and points; a row not found gets no point). M is a template constant
// (27 or 125); knn5_tiled_walk_any takes any M.
// The query's voxel and the map's directory dims, read once a query.
struct TiledQuery {
  float qx, qy, qz;
  int32_t bx, by, bz;
  int l0, l1, l2;
};

__device__ __forceinline__ TiledQuery tiled_query(const TiledView& mp, float qx, float qy,
                                                  float qz) {
  const float vs = __ldg(mp.voxel_size);
  return TiledQuery{qx,
                    qy,
                    qz,
                    (int32_t)floorf(qx / vs),
                    (int32_t)floorf(qy / vs),
                    (int32_t)floorf(qz / vs),
                    __ldg(mp.log2_dims + 0),
                    __ldg(mp.log2_dims + 1),
                    __ldg(mp.log2_dims + 2)};
}

// RB of a lane's rows, j0, j0 + L, ... (those below M): each row's squared
// distance and point (KNN5_BIG and 0 where missing) and its found flag;
// with the block (gfound not null) each row's flag and, where found, its
// point written into the query's block.
template <int RB, int L>
__device__ __forceinline__ void tiled_rows(const TiledView& mp, const TiledQuery& q, int j0,
                                           int M, float (&d2)[RB], float (&cx)[RB],
                                           float (&cy)[RB], float (&cz)[RB], float* gcand,
                                           uint8_t* gfound) {
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int j = j0 + L * r;
    d2[r] = KNN5_BIG;
    cx[r] = cy[r] = cz[r] = 0.0f;
    if (j < M) {
      // int32 sums wrap as the plain version's do
      const int32_t kx = (int32_t)((uint32_t)q.bx + (uint32_t)__ldg(mp.offsets + 3 * j + 0));
      const int32_t ky = (int32_t)((uint32_t)q.by + (uint32_t)__ldg(mp.offsets + 3 * j + 1));
      const int32_t kz = (int32_t)((uint32_t)q.bz + (uint32_t)__ldg(mp.offsets + 3 * j + 2));
      const int32_t tx = kx >> 3, ty = ky >> 3, tz = kz >> 3;  // arithmetic
      const int32_t cofs = ((kx & 7) << 6) | ((ky & 7) << 3) | (kz & 7);
      const int32_t dir = ((tx & ((1 << q.l0) - 1)) << (q.l1 + q.l2)) |
                          ((ty & ((1 << q.l1) - 1)) << q.l2) |
                          (tz & ((1 << q.l2) - 1));
      const int32_t chk = check31(tx, ty, tz);
      // two dependent steps, each with its loads issued together: the
      // directory entry (hash and slot), then the pool cell (hash and
      // point)
      const int32_t dchk = __ldg(mp.dir_check + dir);
      const int32_t slot = min(max(__ldg(mp.dir_slot + dir), 0), mp.T - 1);
      bool hit = false;
      if (dchk == chk) {
        const int32_t p = slot * TILE_CELLS + cofs;
        const int32_t cchk = __ldg(mp.cell_check + p);
        const float px = __ldg(mp.pts + 3 * (size_t)p + 0);
        const float py = __ldg(mp.pts + 3 * (size_t)p + 1);
        const float pz = __ldg(mp.pts + 3 * (size_t)p + 2);
        if (cchk == chk) {
          const float dx = px - q.qx, dy = py - q.qy, dz = pz - q.qz;
          d2[r] = dx * dx + dy * dy + dz * dz;
          cx[r] = px;
          cy[r] = py;
          cz[r] = pz;
          hit = true;
        }
      }
      if (gfound) {
        gfound[j] = hit ? 1 : 0;
        if (hit) {
          gcand[3 * j + 0] = cx[r];
          gcand[3 * j + 1] = cy[r];
          gcand[3 * j + 2] = cz[r];
        }
      }
    }
  }
}

template <int M, int L, int F = FIT_TLS, bool G = false>
__device__ __forceinline__ bool knn5_tiled_walk(const TiledView& mp, float qx, float qy,
                                                float qz, int sub, double threshold,
                                                float (&pl)[4], float& dmin,
                                                float* gcand = nullptr,
                                                uint8_t* gfound = nullptr) {
  constexpr int R = (M + L - 1) / L;  // rows per lane
  const TiledQuery q = tiled_query(mp, qx, qy, qz);
  float d2[R], cx[R], cy[R], cz[R];
  tiled_rows<R, L>(mp, q, sub, M, d2, cx, cy, cz, G ? gcand : nullptr, G ? gfound : nullptr);
  float nx[5], ny[5], nz[5];
  dmin = group_top5<R, L>(d2, cx, cy, cz, sub, nx, ny, nz);
  return plane5_fit_as<F>(nx, ny, nz, threshold, pl);
}

// The generic form: the same search at any M (a runtime value), the
// lane's rows walked KNN5_RB at a time into its Top5 and the group's lists
// merged (knn5_select.cuh's group_merge5): the same planes and fifth
// distance bit for bit.
template <int L, int F = FIT_TLS, bool G = false>
__device__ __forceinline__ bool knn5_tiled_walk_any(const TiledView& mp, int M, float qx,
                                                    float qy, float qz, int sub,
                                                    double threshold, float (&pl)[4],
                                                    float& dmin, float* gcand = nullptr,
                                                    uint8_t* gfound = nullptr) {
  const TiledQuery q = tiled_query(mp, qx, qy, qz);
  Top5 t;
  top5_clear(t);
  for (int j0 = sub; j0 < M; j0 += L * KNN5_RB) {
    float d2[KNN5_RB], cx[KNN5_RB], cy[KNN5_RB], cz[KNN5_RB];
    tiled_rows<KNN5_RB, L>(mp, q, j0, M, d2, cx, cy, cz, G ? gcand : nullptr,
                           G ? gfound : nullptr);
#pragma unroll
    for (int r = 0; r < KNN5_RB; ++r) top5_push(t, d2[r], j0 + L * r, cx[r], cy[r], cz[r]);
  }
  float nx[5], ny[5], nz[5];
  dmin = group_merge5<L>(t, sub, nx, ny, nz);
  return plane5_fit_as<F>(nx, ny, nz, threshold, pl);
}

}  // namespace
