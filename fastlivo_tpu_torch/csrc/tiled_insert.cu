// The tiled map's insert around its one sort, for Hopper: three kernels.
//
// Replaces no TPU kernel: it is the port of the jitted XLA code of
// fastlivo_tpu/ops/tiled_map.py::insert (:107-200), whose torch version
// ops/tiled_map.py::insert_plain is some 200 small torch ops (the murmur
// mix in int64, fixed-shape masked scatters, two cumsums, a cummax and
// inverse-permutation scatters). ops/tiled_map.py::insert on a CUDA map
// runs
//
//   tiled_insert_keys   one thread a row: the voxel (a true division by
//                       the device voxel size, then floor), the tile and
//                       its wrapped directory index, the tile's 31-bit
//                       check (hash_mix.cuh), the in-tile cell, the
//                       squared distance to the voxel centre summed
//                       ((e0 e0 + e1 e1) + e2 e2), and the packed sort key
//                       (dir_idx << 40 | cell << 31 | the distance's bits;
//                       D << 40 for an invalid row). Writes the key and the
//                       row's [dir_idx, check, cell, distance bits, flag 0];
//   torch.sort          stable, on the keys: the sorted keys and `order`;
//   tiled_insert_tiles  one block: the tile heads (where the key's dir_idx
//                       changes, below D) mark their rows aliased or fresh
//                       from the directory as it was before any write;
//                       then, over the rows in their original order, a
//                       block scan gives each fresh head its allocation
//                       rank (the plain version's cumsum over row order),
//                       and every head that does not overflow the pool
//                       writes its directory entry and its slot's key.
//                       Sets n_alloc (clamped at T) and copies n_dropped;
//   tiled_insert_cells  one thread a sorted row: a row is ok when it is
//                       valid and its directory entry now holds its tile;
//                       the head of each (dir_idx, cell) run walks the run
//                       to its first ok row (the head itself can be a row
//                       of a losing, directory-aliasing tile, or a dropped
//                       row), which replaces the stored cell when that
//                       cell is dead or farther from the voxel centre.
//                       Adds the valid rows that are not ok to n_dropped
//                       (a block sum, one int atomic a block).
//
// Every index a kernel writes is written by one row only (one head a
// directory entry, one slot a head, one winner a cell), so the writes need
// no atomics and every launch gives the same bits as the plain version.
// Built with -fmad=false: each product and sum rounds as its torch op does.
//
// Bound on an H100: a few tens of bytes and about a hundred integer and
// float operations a row; at the LIO frame's 16384 rows that is ~0.2 us
// of memory traffic a pass, far below a launch, so each pass is held by
// its launch and its chain of dependent loads (the sorted key, then the
// row, then the directory, then the pool cell). The tiles pass is one
// block: its work is a head test a row and a scan, and one block keeps
// the rank an exact int prefix with no grid-wide step. chip_smoke.py
// counts each pass's bound from its inputs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_mix.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE_THREADS = 1024;
constexpr int TC = 512;  // cells a tile
constexpr unsigned FULL = 0xffffffffu;

// voxel_map.voxel_of: floor(p / voxel_size) as int32 (the conversion
// saturates, as torch's .to(torch.int32) on the card)
__device__ __forceinline__ void voxel_of(const float* __restrict__ pts, int row, float vs,
                                         float p[3], int32_t k[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    p[a] = pts[3 * row + a];
    k[a] = (int32_t)floorf(p[a] / vs);
  }
}

// the rows' shared per-row values, (5, B) int32
struct Rows {
  int32_t* dir;    // wrapped directory index
  int32_t* chk;    // the tile's check
  int32_t* cofs;   // in-tile cell
  int32_t* d2c;    // the distance to the voxel centre, its f32 bits
  int32_t* flag;   // 1 an aliased tile head, 2 a fresh one, else 0
};

__device__ __forceinline__ Rows rows_of(int32_t* base, int B) {
  return Rows{base, base + B, base + 2 * (size_t)B, base + 3 * (size_t)B, base + 4 * (size_t)B};
}

__global__ void __launch_bounds__(THREADS) tiled_insert_keys_kernel(
    const float* __restrict__ pts, const bool* __restrict__ valid,
    const float* __restrict__ voxel_size, const int32_t* __restrict__ log2_dims, int B,
    long long D, long long* __restrict__ gkey, int32_t* __restrict__ rows_base) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= B) return;
  const Rows rows = rows_of(rows_base, B);
  const float vs = voxel_size[0];
  const int l0 = log2_dims[0], l1 = log2_dims[1], l2 = log2_dims[2];
  float p[3];
  int32_t k[3];
  voxel_of(pts, i, vs, p, k);
  const int32_t tx = k[0] >> 3, ty = k[1] >> 3, tz = k[2] >> 3;
  const int32_t cofs = ((k[0] & 7) << 6) | ((k[1] & 7) << 3) | (k[2] & 7);
  const int32_t dir = ((tx & ((1 << l0) - 1)) << (l1 + l2)) | ((ty & ((1 << l1) - 1)) << l2)
                      | (tz & ((1 << l2) - 1));
  const int32_t chk = check31(tx, ty, tz);
  float e[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) e[a] = p[a] - ((float)k[a] + 0.5f) * vs;
  const float d2c = (e[0] * e[0] + e[1] * e[1]) + e[2] * e[2];
  const int32_t bits = __float_as_int(d2c);
  // the distance's bits widen with their sign, as .to(torch.int64) does
  const long long key = ((long long)dir << 40) | ((long long)cofs << 31) | (long long)bits;
  gkey[i] = valid[i] ? key : D << 40;
  rows.dir[i] = dir;
  rows.chk[i] = chk;
  rows.cofs[i] = cofs;
  rows.d2c[i] = bits;
  rows.flag[i] = 0;
}

// inclusive block scan of one int a thread (TILE_THREADS threads); the
// block's total in *total
__device__ int block_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int s = warp_sums[lane];  // TILE_THREADS / 32 == 32 warps
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += u;
    }
    warp_sums[lane] = s;
  }
  __syncthreads();
  const int out = v + (warp > 0 ? warp_sums[warp - 1] : 0);
  *total = warp_sums[31];
  __syncthreads();  // warp_sums is rewritten by the next call
  return out;
}

__global__ void __launch_bounds__(TILE_THREADS) tiled_insert_tiles_kernel(
    const long long* __restrict__ sg, const long long* __restrict__ order,
    int32_t* __restrict__ rows_base, const float* __restrict__ pts,
    const float* __restrict__ voxel_size, int B, long long D, int T, int32_t empty,
    int32_t* __restrict__ dir_check, int32_t* __restrict__ dir_slot,
    int32_t* __restrict__ slot_key, const int32_t* __restrict__ n_alloc,
    const int32_t* __restrict__ n_dropped, int32_t* __restrict__ n_alloc_out,
    int32_t* __restrict__ n_dropped_out) {
  __shared__ int warp_sums[32];
  const Rows rows = rows_of(rows_base, B);
  // the tile heads, in sorted order, against the directory before any write
  for (int r = threadIdx.x; r < B; r += TILE_THREADS) {
    const long long sdir = sg[r] >> 40;
    if (sdir < D && (r == 0 || (sg[r - 1] >> 40) != sdir)) {
      const int row = (int)order[r];
      rows.flag[row] = dir_check[rows.dir[row]] != empty ? 1 : 2;
    }
  }
  __syncthreads();  // the flags written, every directory read done

  // the rows in their original order: fresh heads ranked, heads written
  const int32_t base = n_alloc[0];
  const float vs = voxel_size[0];
  int carry = 0;
  for (int c0 = 0; c0 < B; c0 += TILE_THREADS) {  // block-uniform
    const int i = c0 + threadIdx.x;
    const int f = i < B ? rows.flag[i] : 0;
    int chunk;
    const int incl = block_scan(f == 2, warp_sums, &chunk);
    if (f) {
      const int32_t dir = rows.dir[i];
      const int32_t new_slot = base + (carry + incl - 1);
      const bool overflow = f == 2 && new_slot >= T;
      const int32_t slot_w = f == 1 ? dir_slot[dir] : new_slot;
      if (!overflow) {
        dir_check[dir] = rows.chk[i];
        dir_slot[dir] = slot_w;
        float p[3];
        int32_t k[3];
        voxel_of(pts, i, vs, p, k);
        if (slot_w >= 0 && slot_w < T)
#pragma unroll
          for (int a = 0; a < 3; ++a) slot_key[3 * (size_t)slot_w + a] = k[a] >> 3;
      }
    }
    carry += chunk;
  }
  if (threadIdx.x == 0) {
    const int32_t n = base + carry;
    n_alloc_out[0] = n < T ? n : T;
    n_dropped_out[0] = n_dropped[0];
  }
}

// valid, and its directory entry holds its tile (after the tiles pass)
__device__ __forceinline__ bool row_ok(const Rows& rows, const bool* __restrict__ valid,
                                       const int32_t* __restrict__ dir_check, int row) {
  return valid[row] && dir_check[rows.dir[row]] == rows.chk[row];
}

__global__ void __launch_bounds__(THREADS) tiled_insert_cells_kernel(
    const long long* __restrict__ sg, const long long* __restrict__ order,
    const int32_t* __restrict__ rows_base, const float* __restrict__ pts,
    const bool* __restrict__ valid, const float* __restrict__ voxel_size, int B, long long D,
    int T, const int32_t* __restrict__ dir_check, const int32_t* __restrict__ dir_slot,
    int32_t* __restrict__ cell_check, float* __restrict__ pool,
    int32_t* __restrict__ n_dropped_out) {
  __shared__ int warp_drops[THREADS / 32];
  const Rows rows = rows_of(const_cast<int32_t*>(rows_base), B);
  const int r = blockIdx.x * THREADS + threadIdx.x;
  int dropped = 0;
  if (r < B) {
    const int row = (int)order[r];
    dropped = valid[row] && !row_ok(rows, valid, dir_check, row);
    const long long scell = sg[r] >> 31;
    if ((sg[r] >> 40) < D && (r == 0 || (sg[r - 1] >> 31) != scell)) {
      // the run's first ok row in sorted (distance) order
      int w = -1;
      for (int q = r; q < B && (sg[q] >> 31) == scell; ++q) {
        const int rq = q == r ? row : (int)order[q];
        if (row_ok(rows, valid, dir_check, rq)) {
          w = rq;
          break;
        }
      }
      if (w >= 0) {
        const int32_t chk = rows.chk[w];
        int32_t slot = dir_slot[rows.dir[w]];
        slot = slot < 0 ? 0 : (slot > T - 1 ? T - 1 : slot);
        const size_t cell = (size_t)(slot * TC + rows.cofs[w]);
        float p[3];
        int32_t k[3];
        const float vs = voxel_size[0];
        voxel_of(pts, w, vs, p, k);
        float es[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) es[a] = pool[3 * cell + a] - ((float)k[a] + 0.5f) * vs;
        const float stored_d2c = (es[0] * es[0] + es[1] * es[1]) + es[2] * es[2];
        if (cell_check[cell] != chk || __int_as_float(rows.d2c[w]) < stored_d2c) {
          cell_check[cell] = chk;
#pragma unroll
          for (int a = 0; a < 3; ++a) pool[3 * cell + a] = p[a];
        }
      }
    }
  }
  // the block's dropped rows, one atomic
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dropped += __shfl_down_sync(FULL, dropped, o);
  if ((threadIdx.x & 31) == 0) warp_drops[threadIdx.x >> 5] = dropped;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < THREADS / 32; ++w) s += warp_drops[w];
    if (s) atomicAdd(n_dropped_out, s);
  }
}

int blocks_of(int n) { return (n + THREADS - 1) / THREADS; }

}  // namespace

// C interface for ctypes. Every pointer is to contiguous device memory;
// each function returns the launch's cudaError_t (0 = cudaSuccess).
//
// pts (B, 3) f32, valid (B,) bool, voxel_size () f32, log2_dims (3,)
// int32; writes gkey (B,) int64 and rows (5, B) int32. B = 0 launches
// nothing.
extern "C" int tiled_insert_keys_launch(const void* pts, const void* valid,
                                        const void* voxel_size, const void* log2_dims,
                                        void* gkey, void* rows, int B, long long D,
                                        void* stream) {
  if (B <= 0) return 0;
  tiled_insert_keys_kernel<<<blocks_of(B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const bool*>(valid),
      static_cast<const float*>(voxel_size), static_cast<const int32_t*>(log2_dims), B, D,
      static_cast<long long*>(gkey), static_cast<int32_t*>(rows));
  return static_cast<int>(cudaGetLastError());
}

// sg, order (B,) int64 (torch.sort's values and indices of gkey), rows
// (5, B) int32 (its flags written), pts, voxel_size as above; the map's
// dir_check, dir_slot (D,) int32 and slot_key (T, 3) int32 written in
// place; n_alloc, n_dropped () int32 read; n_alloc_out, n_dropped_out ()
// int32 written. One block, also at B = 0.
extern "C" int tiled_insert_tiles_launch(const void* sg, const void* order, void* rows,
                                         const void* pts, const void* voxel_size,
                                         void* dir_check, void* dir_slot, void* slot_key,
                                         const void* n_alloc, const void* n_dropped,
                                         void* n_alloc_out, void* n_dropped_out, int B,
                                         long long D, int T, int empty_check, void* stream) {
  if (B < 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  tiled_insert_tiles_kernel<<<1, TILE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(sg), static_cast<const long long*>(order),
      static_cast<int32_t*>(rows), static_cast<const float*>(pts),
      static_cast<const float*>(voxel_size), B, D, T, (int32_t)empty_check,
      static_cast<int32_t*>(dir_check), static_cast<int32_t*>(dir_slot),
      static_cast<int32_t*>(slot_key), static_cast<const int32_t*>(n_alloc),
      static_cast<const int32_t*>(n_dropped), static_cast<int32_t*>(n_alloc_out),
      static_cast<int32_t*>(n_dropped_out));
  return static_cast<int>(cudaGetLastError());
}

// sg, order, rows, pts, valid, voxel_size as above; the directory read;
// the map's cell_check (T * 512,) int32 and pts (T * 512, 3) f32 written
// in place; n_dropped_out () int32 added to. B = 0 launches nothing.
extern "C" int tiled_insert_cells_launch(const void* sg, const void* order, const void* rows,
                                         const void* pts, const void* valid,
                                         const void* voxel_size, const void* dir_check,
                                         const void* dir_slot, void* cell_check, void* pool,
                                         void* n_dropped_out, int B, long long D, int T,
                                         void* stream) {
  if (B <= 0) return 0;
  if (T <= 0) return static_cast<int>(cudaErrorInvalidValue);
  tiled_insert_cells_kernel<<<blocks_of(B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(sg), static_cast<const long long*>(order),
      static_cast<const int32_t*>(rows), static_cast<const float*>(pts),
      static_cast<const bool*>(valid), static_cast<const float*>(voxel_size), B, D, T,
      static_cast<const int32_t*>(dir_check), static_cast<const int32_t*>(dir_slot),
      static_cast<int32_t*>(cell_check), static_cast<float*>(pool),
      static_cast<int32_t*>(n_dropped_out));
  return static_cast<int>(cudaGetLastError());
}
