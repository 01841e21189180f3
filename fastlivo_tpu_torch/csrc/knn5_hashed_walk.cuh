// One query's LIO search on the hash map or the dense grid, by a group of
// L lanes of one warp: the neighbourhood walk (the probe chain or the
// computed cell), the five nearest and the plane fit (the TLS fit, or
// the reference's inside the LIO cascade). Shared by
// csrc/knn5_plane_hashed.cu (the search alone) and csrc/lio_cascade.cu
// (the search inside the LIO cascade), so that the two give the same
// planes bit for bit. Include after hash_mix.cuh (mix3, check31),
// knn5_select.cuh (group_top5, KNN5_BIG) and plane_fit.cuh (plane5_fit_as).
#pragma once

#include <stdint.h>

namespace {

enum Backend { HASH = 0, DENSE = 1 };

// The hash map (ops/voxel_map.VoxelMap) or the dense grid
// (ops/dense_map.DenseMap) as the walk reads it, and the neighbourhood
// offsets (m, 3) int32 of voxel_map._neighbor_offsets.
struct HashedView {
  const int32_t* check;      // (T,) the slots' or cells' check words
  const float* pts;          // (T, 3)
  const float* voxel_size;   // ()
  const int32_t* log2_dims;  // (3,) dense; unread for the hash map
  const int32_t* offsets;    // (M, 3)
  int T;                     // slots or cells, a power of two
  int max_probe;             // the hash map's probe depth
  bool vec;                  // check 16-byte aligned and T >= 4: four words a load
};

// The found slot of each of a lane's rows, -1 where missing: the first
// of max_probe consecutive slots (wrapping) whose check equals chk. The
// probes run in rounds over all of the lane's rows at once, so the loads
// of up to R rows are in flight together: with `vec`, a round reads four
// consecutive check words with one 16-byte load (T is a multiple of 4, so
// an aligned group of four never straddles the wrap) and takes them in
// chain order; a row leaves at its first match or after max_probe slots.
// An empty slot does not end the chain (delete_boxes leaves holes).
template <int R>
__device__ __forceinline__ void probe_rows(const int32_t* __restrict__ check,
                                           int32_t mask, int max_probe, bool vec,
                                           const int32_t (&slot)[R],
                                           const int32_t (&chk)[R],
                                           const bool (&row)[R], int32_t (&res)[R]) {
  if (!vec) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      res[r] = -1;
      int32_t s = slot[r];
      for (int p = 0; row[r] && p < max_probe; ++p) {
        if (__ldg(check + s) == chk[r]) {
          res[r] = s;
          break;
        }
        s = (s + 1) & mask;
      }
    }
    return;
  }
  int32_t g[R];  // the aligned group of four holding the next probe
  int k0[R];     // the chain's first slot within the first group
  int left[R];   // probes still to take
#pragma unroll
  for (int r = 0; r < R; ++r) {
    res[r] = -1;
    g[r] = slot[r] & ~3;
    k0[r] = slot[r] & 3;
    left[r] = row[r] ? max_probe : 0;
  }
  bool more = true;
  while (more) {
    int4 w[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {  // start every row's load first
      w[r] = make_int4(0, 0, 0, 0);
      if (left[r] > 0) w[r] = __ldg(reinterpret_cast<const int4*>(check + g[r]));
    }
    more = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (left[r] > 0) {
        const int32_t v[4] = {w[r].x, w[r].y, w[r].z, w[r].w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k >= k0[r] && left[r] > 0) {
            if (v[k] == chk[r]) {
              res[r] = g[r] + k;
              left[r] = 0;
            } else {
              --left[r];
            }
          }
        }
        k0[r] = 0;
        g[r] = (g[r] + 4) & mask;
        more = more || left[r] > 0;
      }
    }
  }
}

// The query (qx, qy, qz), world frame: its voxel floor(q / voxel_size) (a
// true f32 division by the device voxel size), plus each of the M =
// (2r+1)^3 offsets (wrapping int32 sums) ->
//   hash: z = the voxel's murmur mix; the chain starts at slot (z >> 13) &
//     (T - 1) (the JAX package's 19-bit slot, kept for parity) and probes
//     max_probe slots (probe_rows); the first slot whose check equals z &
//     0x7FFFFFFF holds the voxel;
//   dense: the cell is each coordinate & (dim - 1) (two's complement),
//     found when its check equals the voxel's 31-bit hash (an aliased
//     occupant is not found) ->
// the squared distance to the stored point, KNN5_BIG where missing (no
// point read) -> five rounds of min-select, ties to the lowest row
// (group_top5) -> the plane fit F of plane_fit.cuh (FIT_TLS or FIT_REF)
// and its gate. A lane mixes each of its rows' keys itself (the key
// varies per row); points are read only for found rows, all of a lane's
// together. Lane `sub` of the group
// owns candidate rows sub, sub + L, ...; every lane of the warp must call.
// Every lane returns the gate, the plane (ux, uy, uz, d) in pl and the
// fifth-nearest squared distance in dmin. The gather form (G, lio_cascade.cu's
// first search under `cache_knn`) also writes each of the lane's rows into
// the query's block where gfound is not null: gfound[j] the row's found
// flag and, where found, gcand[3 j ..] its point (the backend's
// knn_candidates' found and points; a row not found gets no point).
// The query's voxel and the dense grid's dims, read once a query.
struct HashedQuery {
  float qx, qy, qz;
  int32_t bx, by, bz;
  int l0, l1, l2;
};

template <int B>
__device__ __forceinline__ HashedQuery hashed_query(const HashedView& mp, float qx, float qy,
                                                    float qz) {
  const float vs = __ldg(mp.voxel_size);
  return HashedQuery{qx,
                     qy,
                     qz,
                     (int32_t)floorf(qx / vs),
                     (int32_t)floorf(qy / vs),
                     (int32_t)floorf(qz / vs),
                     B == DENSE ? __ldg(mp.log2_dims + 0) : 0,
                     B == DENSE ? __ldg(mp.log2_dims + 1) : 0,
                     B == DENSE ? __ldg(mp.log2_dims + 2) : 0};
}

// RB of a lane's rows, j0, j0 + L, ... (those below M): each row's squared
// distance and point (KNN5_BIG and 0 where missing); with the block
// (gfound not null) each row's found flag and, where found, its point
// written into the query's block.
template <int B, int RB, int L>
__device__ __forceinline__ void hashed_rows(const HashedView& mp, const HashedQuery& q, int j0,
                                            int M, float (&d2)[RB], float (&cx)[RB],
                                            float (&cy)[RB], float (&cz)[RB], float* gcand,
                                            uint8_t* gfound) {
  // each row's first slot (hash) or cell (dense) and its check word
  int32_t slot[RB], chk[RB], res[RB];
  bool row[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int j = j0 + L * r;
    row[r] = j < M;
    slot[r] = chk[r] = 0;
    if (row[r]) {
      // int32 sums wrap as the plain version's do
      const int32_t kx = (int32_t)((uint32_t)q.bx + (uint32_t)__ldg(mp.offsets + 3 * j + 0));
      const int32_t ky = (int32_t)((uint32_t)q.by + (uint32_t)__ldg(mp.offsets + 3 * j + 1));
      const int32_t kz = (int32_t)((uint32_t)q.bz + (uint32_t)__ldg(mp.offsets + 3 * j + 2));
      if (B == HASH) {
        const uint32_t z = mix3(kx, ky, kz);
        slot[r] = (int32_t)(z >> 13) & (mp.T - 1);
        chk[r] = (int32_t)(z & 0x7FFFFFFFu);
      } else {
        slot[r] = ((kx & ((1 << q.l0) - 1)) << (q.l1 + q.l2)) |
                  ((ky & ((1 << q.l1) - 1)) << q.l2) | (kz & ((1 << q.l2) - 1));
        chk[r] = check31(kx, ky, kz);
      }
    }
  }
  if (B == HASH) {
    probe_rows<RB>(mp.check, mp.T - 1, mp.max_probe, mp.vec, slot, chk, row, res);
  } else {
    int32_t c[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) c[r] = row[r] ? __ldg(mp.check + slot[r]) : 0;
#pragma unroll
    for (int r = 0; r < RB; ++r) res[r] = (row[r] && c[r] == chk[r]) ? slot[r] : -1;
  }

#pragma unroll
  for (int r = 0; r < RB; ++r) {
    d2[r] = KNN5_BIG;
    cx[r] = cy[r] = cz[r] = 0.0f;
    if (res[r] >= 0) {
      cx[r] = __ldg(mp.pts + 3 * (size_t)res[r] + 0);
      cy[r] = __ldg(mp.pts + 3 * (size_t)res[r] + 1);
      cz[r] = __ldg(mp.pts + 3 * (size_t)res[r] + 2);
    }
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (res[r] >= 0) {
      const float dx = cx[r] - q.qx, dy = cy[r] - q.qy, dz = cz[r] - q.qz;
      d2[r] = dx * dx + dy * dy + dz * dz;
    }
  }
  if (gfound) {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int j = j0 + L * r;
      if (row[r]) {
        gfound[j] = res[r] >= 0 ? 1 : 0;
        if (res[r] >= 0) {
          gcand[3 * j + 0] = cx[r];
          gcand[3 * j + 1] = cy[r];
          gcand[3 * j + 2] = cz[r];
        }
      }
    }
  }
}

template <int B, int M, int L, int F = FIT_TLS, bool G = false>
__device__ __forceinline__ bool knn5_hashed_walk(const HashedView& mp, float qx, float qy,
                                                 float qz, int sub, double threshold,
                                                 float (&pl)[4], float& dmin,
                                                 float* gcand = nullptr,
                                                 uint8_t* gfound = nullptr) {
  constexpr int R = (M + L - 1) / L;  // rows per lane
  const HashedQuery q = hashed_query<B>(mp, qx, qy, qz);
  float d2[R], cx[R], cy[R], cz[R];
  hashed_rows<B, R, L>(mp, q, sub, M, d2, cx, cy, cz, G ? gcand : nullptr,
                       G ? gfound : nullptr);
  float nx[5], ny[5], nz[5];
  dmin = group_top5<R, L>(d2, cx, cy, cz, sub, nx, ny, nz);
  return plane5_fit_as<F>(nx, ny, nz, threshold, pl);
}

// The generic form: the same search at any M (a runtime value), the
// lane's rows walked KNN5_RB at a time (their probes in flight together)
// into its Top5 and the group's lists merged (knn5_select.cuh's
// group_merge5): the same planes and fifth distance bit for bit.
template <int B, int L, int F = FIT_TLS, bool G = false>
__device__ __forceinline__ bool knn5_hashed_walk_any(const HashedView& mp, int M, float qx,
                                                     float qy, float qz, int sub,
                                                     double threshold, float (&pl)[4],
                                                     float& dmin, float* gcand = nullptr,
                                                     uint8_t* gfound = nullptr) {
  const HashedQuery q = hashed_query<B>(mp, qx, qy, qz);
  Top5 t;
  top5_clear(t);
  for (int j0 = sub; j0 < M; j0 += L * KNN5_RB) {
    float d2[KNN5_RB], cx[KNN5_RB], cy[KNN5_RB], cz[KNN5_RB];
    hashed_rows<B, KNN5_RB, L>(mp, q, j0, M, d2, cx, cy, cz, G ? gcand : nullptr,
                               G ? gfound : nullptr);
#pragma unroll
    for (int r = 0; r < KNN5_RB; ++r) top5_push(t, d2[r], j0 + L * r, cx[r], cy[r], cz[r]);
  }
  float nx[5], ny[5], nz[5];
  dmin = group_merge5<L>(t, sub, nx, ny, nz);
  return plane5_fit_as<F>(nx, ny, nz, threshold, pl);
}

}  // namespace
