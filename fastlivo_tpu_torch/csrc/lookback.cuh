// Decoupled look-back over per-tile status words, for an exclusive int
// prefix across the blocks of one ordinary launch (csrc/voxel_centroids.cu,
// csrc/tiled_insert.cu). Tiles are handed out in launch order by an int
// ticket, so a tile only waits on tiles that are already running: no grid
// barrier, no cooperative launch.
//
// A tile's status word is 0 until it publishes: FLAG_A | its own count
// (an aggregate), then FLAG_P | the count of every tile up to its end (an
// inclusive prefix; tile 0 publishes that at once). Counts are below 2^30.
// The caller zeroes the words once; the last block of each launch sets
// them back to 0.
#pragma once

#include <cuda_runtime.h>

namespace lookback {

constexpr unsigned FLAG_A = 1u << 30;  // status: the tile's own count
constexpr unsigned FLAG_P = 2u << 30;  // status: the count up to its end
constexpr unsigned VALUE = FLAG_A - 1u;

__device__ __forceinline__ unsigned load_status(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

__device__ __forceinline__ void store_status(unsigned* p, unsigned v) {
  *reinterpret_cast<volatile unsigned*>(p) = v;
}

// The counts of tiles 0 .. t - 1 (a whole warp; every lane returns it):
// lane l reads the status of tile base - l, waits while it is unpublished,
// and the warp adds the aggregates down to the nearest inclusive prefix.
__device__ __forceinline__ int count_before(const unsigned* status, int t) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int total = 0;
  for (int base = t - 1; base >= 0; base -= 32) {
    const int i = base - lane;
    unsigned s = i >= 0 ? load_status(status + i) : FLAG_P;  // nothing before tile 0
    while (__any_sync(full, s == 0u))
      if (s == 0u) s = load_status(status + i);
    const unsigned p = __ballot_sync(full, (s & FLAG_P) != 0u);
    const int stop = p ? __ffs(p) - 1 : 31;
    int v = lane <= stop ? static_cast<int>(s & VALUE) : 0;
    for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(full, v, o);
    total += v;
    if (p) break;
  }
  return total;
}

}  // namespace lookback
