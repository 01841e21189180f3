// The five nearest of a query's M candidate rows, selected by a group of
// L lanes of one warp, shared by the walks (knn5_tiled_walk.cuh,
// knn5_hashed_walk.cuh, knn5_cached_walk.cuh: csrc/knn5_plane_tiled.cu,
// csrc/knn5_plane_hashed.cu, csrc/lio_cascade.cu) and csrc/knn5_plane.cu
// so that the kernels cannot drift apart.
// Lane `sub` of a group (the group's lanes are consecutive, L divides
// 32) owns rows sub, sub + L, ... and holds their squared distances and
// points in registers (a missing row: d2 = KNN5_BIG, point 0). A round
// is a local strict-`<` scan over the lane's rows and a butterfly over
// the group (__shfl_xor_sync) on (d2, row), the lower row winning a tie,
// as the plain version's lowest-row min-select
// (ops/knn_plane.py::knn5_plane_plain); the owning lane hands the
// winner's point over with __shfl_sync. Every lane of the warp must call
// it.
//
// The generic form, for any M (the walks' `_any` forms, M = (2r+1)^3 a
// runtime value): a lane streams its rows in ascending order and keeps
// its own five nearest in registers (Top5: ascending by (d2, row); a row
// enters on a strict `<` against the fifth, so the lower row stays ahead
// on a tie), then group_merge5 merges the group's lists in five rounds of
// the same butterfly on (d2, row), the winner's lane popping its head. A
// missing row never enters (its d2 is KNN5_BIG, which every empty entry
// holds already), and an empty entry (KNN5_BIG, KNN5_NOROW) stands where
// the plain version's five rounds find only KNN5_BIG: its point is 0 and
// the fifth distance KNN5_BIG, as there. So the picks and the fifth
// distance are the lowest-row min-select's bit for bit.
#pragma once

constexpr float KNN5_BIG = 3.0e37f;  // a missing row's squared distance
constexpr int KNN5_NOROW = 0x7fffffff;  // an empty Top5 entry's row
constexpr int KNN5_RB = 4;  // rows a lane walks at once in the generic form

// Writes the picks (nx, ny, nz), zeros where fewer than five rows were
// found, and returns the fifth-nearest squared distance. d2 is consumed.
template <int R, int L>
__device__ __forceinline__ float group_top5(float (&d2)[R], const float (&cx)[R],
                                            const float (&cy)[R], const float (&cz)[R],
                                            int sub, float (&nx)[5], float (&ny)[5],
                                            float (&nz)[5]) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int base = lane - sub;  // the group's first lane
  float dmin = KNN5_BIG;
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
    const bool v = dmin < KNN5_BIG * 0.5f;
    nx[k] = v ? sx : 0.0f;
    ny[k] = v ? sy : 0.0f;
    nz[k] = v ? sz : 0.0f;
    if (lane == owner) {
#pragma unroll
      for (int r = 0; r < R; ++r) d2[r] = (r == rr) ? KNN5_BIG : d2[r];
    }
  }
  return dmin;
}

// A lane's five nearest rows so far, ascending by (d2, row), with their
// points; empty entries (KNN5_BIG, KNN5_NOROW, point 0) at the end.
struct Top5 {
  float d[5], x[5], y[5], z[5];
  int row[5];
};

__device__ __forceinline__ void top5_clear(Top5& t) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    t.d[k] = KNN5_BIG;
    t.x[k] = t.y[k] = t.z[k] = 0.0f;
    t.row[k] = KNN5_NOROW;
  }
}

// Row `row` (above every row pushed before) at squared distance d enters
// where d is strictly below the entry it passes: the entries from there
// move down one place and the fifth drops out.
__device__ __forceinline__ void top5_push(Top5& t, float d, int row, float x, float y,
                                          float z) {
#pragma unroll
  for (int k = 4; k > 0; --k) {
    if (d < t.d[k - 1]) {
      t.d[k] = t.d[k - 1];
      t.x[k] = t.x[k - 1];
      t.y[k] = t.y[k - 1];
      t.z[k] = t.z[k - 1];
      t.row[k] = t.row[k - 1];
    } else if (d < t.d[k]) {
      t.d[k] = d;
      t.x[k] = x;
      t.y[k] = y;
      t.z[k] = z;
      t.row[k] = row;
    }
  }
  if (d < t.d[0]) {
    t.d[0] = d;
    t.x[0] = x;
    t.y[0] = y;
    t.z[0] = z;
    t.row[0] = row;
  }
}

// The group's five nearest from its lanes' lists (lane `sub` of L
// consecutive lanes owns rows sub, sub + L, ...; L = 1: the lane's own
// list): five rounds, each the butterfly on the heads' (d2, row), the lower
// row winning a tie, and the owning lane popping its head. Writes the
// picks (zeros where fewer than five rows were found) and returns the
// fifth-nearest squared distance, as group_top5. Every lane of the warp
// must call it (for L > 1).
template <int L>
__device__ __forceinline__ float group_merge5(Top5& t, int sub, float (&nx)[5],
                                              float (&ny)[5], float (&nz)[5]) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int base = lane - sub;  // the group's first lane
  float dmin = KNN5_BIG;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    float bd = t.d[0];
    int br = t.row[0];
    float sx = t.x[0], sy = t.y[0], sz = t.z[0];
    if constexpr (L > 1) {
#pragma unroll
      for (int m = L / 2; m >= 1; m >>= 1) {
        const float od = __shfl_xor_sync(FULL, bd, m);
        const int orow = __shfl_xor_sync(FULL, br, m);
        if (od < bd || (od == bd && orow < br)) {
          bd = od;
          br = orow;
        }
      }
      const int owner = base + (br == KNN5_NOROW ? 0 : br % L);
      sx = __shfl_sync(FULL, sx, owner);
      sy = __shfl_sync(FULL, sy, owner);
      sz = __shfl_sync(FULL, sz, owner);
    }
    dmin = bd;
    const bool v = dmin < KNN5_BIG * 0.5f;
    nx[k] = v ? sx : 0.0f;
    ny[k] = v ? sy : 0.0f;
    nz[k] = v ? sz : 0.0f;
    if (br != KNN5_NOROW && br == t.row[0]) {  // this lane's head won: pop it
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        t.d[e] = t.d[e + 1];
        t.x[e] = t.x[e + 1];
        t.y[e] = t.y[e + 1];
        t.z[e] = t.z[e + 1];
        t.row[e] = t.row[e + 1];
      }
      t.d[4] = KNN5_BIG;
      t.x[4] = t.y[4] = t.z[4] = 0.0f;
      t.row[4] = KNN5_NOROW;
    }
  }
  return dmin;
}
