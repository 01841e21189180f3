// One query's LIO search on the hash map or the dense grid, by a group of
// L lanes of one warp: the neighbourhood walk (the probe chain or the
// computed cell), the five nearest and the centred TLS plane fit. Shared
// by csrc/knn5_plane_hashed.cu (the search alone) and csrc/lio_cascade.cu
// (the search inside the LIO cascade), so that the two give the same
// planes bit for bit. Include after hash_mix.cuh (mix3, check31),
// knn5_select.cuh (group_top5, KNN5_BIG) and plane_fit.cuh (plane5_fit).
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
// (group_top5) -> the plane fit and gate of plane_fit.cuh. A lane mixes
// each of its rows' keys itself (the key varies per row); points are read
// only for found rows, all of a lane's together. Lane `sub` of the group
// owns candidate rows sub, sub + L, ...; every lane of the warp must call.
// Every lane returns the gate, the plane (ux, uy, uz, d) in pl and the
// fifth-nearest squared distance in dmin.
template <int B, int M, int L>
__device__ __forceinline__ bool knn5_hashed_walk(const HashedView& mp, float qx, float qy,
                                                 float qz, int sub, float threshold,
                                                 float (&pl)[4], float& dmin) {
  constexpr int R = (M + L - 1) / L;  // rows per lane
  const float vs = __ldg(mp.voxel_size);
  const int32_t bx = (int32_t)floorf(qx / vs);
  const int32_t by = (int32_t)floorf(qy / vs);
  const int32_t bz = (int32_t)floorf(qz / vs);
  const int l0 = B == DENSE ? __ldg(mp.log2_dims + 0) : 0;
  const int l1 = B == DENSE ? __ldg(mp.log2_dims + 1) : 0;
  const int l2 = B == DENSE ? __ldg(mp.log2_dims + 2) : 0;

  // each row's first slot (hash) or cell (dense) and its check word
  int32_t slot[R], chk[R], res[R];
  bool row[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int j = sub + L * r;
    row[r] = j < M;
    slot[r] = chk[r] = 0;
    if (row[r]) {
      // int32 sums wrap as the plain version's do
      const int32_t kx = (int32_t)((uint32_t)bx + (uint32_t)__ldg(mp.offsets + 3 * j + 0));
      const int32_t ky = (int32_t)((uint32_t)by + (uint32_t)__ldg(mp.offsets + 3 * j + 1));
      const int32_t kz = (int32_t)((uint32_t)bz + (uint32_t)__ldg(mp.offsets + 3 * j + 2));
      if (B == HASH) {
        const uint32_t z = mix3(kx, ky, kz);
        slot[r] = (int32_t)(z >> 13) & (mp.T - 1);
        chk[r] = (int32_t)(z & 0x7FFFFFFFu);
      } else {
        slot[r] = ((kx & ((1 << l0) - 1)) << (l1 + l2)) |
                  ((ky & ((1 << l1) - 1)) << l2) | (kz & ((1 << l2) - 1));
        chk[r] = check31(kx, ky, kz);
      }
    }
  }
  if (B == HASH) {
    probe_rows<R>(mp.check, mp.T - 1, mp.max_probe, mp.vec, slot, chk, row, res);
  } else {
    int32_t c[R];
#pragma unroll
    for (int r = 0; r < R; ++r) c[r] = row[r] ? __ldg(mp.check + slot[r]) : 0;
#pragma unroll
    for (int r = 0; r < R; ++r) res[r] = (row[r] && c[r] == chk[r]) ? slot[r] : -1;
  }

  float d2[R], cx[R], cy[R], cz[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    d2[r] = KNN5_BIG;
    cx[r] = cy[r] = cz[r] = 0.0f;
    if (res[r] >= 0) {
      cx[r] = __ldg(mp.pts + 3 * (size_t)res[r] + 0);
      cy[r] = __ldg(mp.pts + 3 * (size_t)res[r] + 1);
      cz[r] = __ldg(mp.pts + 3 * (size_t)res[r] + 2);
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (res[r] >= 0) {
      const float dx = cx[r] - qx, dy = cy[r] - qy, dz = cz[r] - qz;
      d2[r] = dx * dx + dy * dy + dz * dz;
    }
  }

  float nx[5], ny[5], nz[5];
  dmin = group_top5<R, L>(d2, cx, cy, cz, sub, nx, ny, nz);
  return plane5_fit(nx, ny, nz, threshold, pl[0], pl[1], pl[2], pl[3]);
}

}  // namespace
