// The five nearest of a query's M candidate rows, selected by a group of
// L lanes of one warp, shared by csrc/knn5_plane_tiled.cu and
// csrc/knn5_plane_hashed.cu so that the two kernels cannot drift apart.
// Lane `sub` of a group (the group's lanes are consecutive, L divides
// 32) owns rows sub, sub + L, ... and holds their squared distances and
// points in registers (a missing row: d2 = KNN5_BIG, point 0). A round
// is a local strict-`<` scan over the lane's rows and a butterfly over
// the group (__shfl_xor_sync) on (d2, row), the lower row winning a tie,
// as the plain version's lowest-row min-select
// (ops/knn_plane.py::knn5_plane_plain); the owning lane hands the
// winner's point over with __shfl_sync. Every lane of the warp must call
// it.
#pragma once

constexpr float KNN5_BIG = 3.0e37f;  // a missing row's squared distance

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
