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
// and points; a row not found gets no point).
template <int M, int L, int F = FIT_TLS, bool G = false>
__device__ __forceinline__ bool knn5_tiled_walk(const TiledView& mp, float qx, float qy,
                                                float qz, int sub, double threshold,
                                                float (&pl)[4], float& dmin,
                                                float* gcand = nullptr,
                                                uint8_t* gfound = nullptr) {
  constexpr int R = (M + L - 1) / L;  // rows per lane
  const float vs = __ldg(mp.voxel_size);
  const int32_t bx = (int32_t)floorf(qx / vs);
  const int32_t by = (int32_t)floorf(qy / vs);
  const int32_t bz = (int32_t)floorf(qz / vs);
  const int l0 = __ldg(mp.log2_dims + 0);
  const int l1 = __ldg(mp.log2_dims + 1);
  const int l2 = __ldg(mp.log2_dims + 2);

  float d2[R], cx[R], cy[R], cz[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = sub + L * r;
    d2[r] = KNN5_BIG;
    cx[r] = cy[r] = cz[r] = 0.0f;
    if (j < M) {
      // int32 sums wrap as the plain version's do
      const int32_t kx = (int32_t)((uint32_t)bx + (uint32_t)__ldg(mp.offsets + 3 * j + 0));
      const int32_t ky = (int32_t)((uint32_t)by + (uint32_t)__ldg(mp.offsets + 3 * j + 1));
      const int32_t kz = (int32_t)((uint32_t)bz + (uint32_t)__ldg(mp.offsets + 3 * j + 2));
      const int32_t tx = kx >> 3, ty = ky >> 3, tz = kz >> 3;  // arithmetic
      const int32_t cofs = ((kx & 7) << 6) | ((ky & 7) << 3) | (kz & 7);
      const int32_t dir = ((tx & ((1 << l0) - 1)) << (l1 + l2)) |
                          ((ty & ((1 << l1) - 1)) << l2) |
                          (tz & ((1 << l2) - 1));
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
          const float dx = px - qx, dy = py - qy, dz = pz - qz;
          d2[r] = dx * dx + dy * dy + dz * dz;
          cx[r] = px;
          cy[r] = py;
          cz[r] = pz;
          hit = true;
        }
      }
      if (G && gfound) {
        gfound[j] = hit ? 1 : 0;
        if (hit) {
          gcand[3 * j + 0] = cx[r];
          gcand[3 * j + 1] = cy[r];
          gcand[3 * j + 2] = cz[r];
        }
      }
    }
  }

  float nx[5], ny[5], nz[5];
  dmin = group_top5<R, L>(d2, cx, cy, cz, sub, nx, ny, nz);
  return plane5_fit_as<F>(nx, ny, nz, threshold, pl);
}

}  // namespace
