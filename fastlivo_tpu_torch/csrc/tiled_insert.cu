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
//   tiled_insert_tiles  one ordinary launch of 2 ceil(B / 1024) blocks,
//                       taking 1024-row tiles by an int ticket: the first
//                       half mark the tile heads (where the key's dir_idx
//                       changes, below D) among their sorted positions,
//                       each head's row aliased or fresh from the
//                       directory as it was before any write; the second
//                       half wait until every tile is marked, then take
//                       the rows in their original order: a block scan and
//                       a decoupled look-back give each fresh head its
//                       allocation rank (the plain version's cumsum over
//                       row order), and every head that does not overflow
//                       the pool writes its directory entry and its slot's
//                       key. Sets n_alloc (clamped at T) and copies
//                       n_dropped;
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
// row, then the directory, then the pool cell). The tiles pass spreads
// its head tests and its scan over the card's SMs; its rank stays an
// exact int prefix through the decoupled look-back that
// csrc/voxel_centroids.cu uses too (lookback.cuh), with no grid barrier
// and no device query. chip_smoke.py counts each pass's bound from its
// inputs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_mix.cuh"
#include "lookback.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE_ROWS = 1024;  // rows a tiles-pass block marks, and ranks
constexpr int TILE_THREADS = 256;
constexpr int TILE_WARPS = TILE_THREADS / 32;
constexpr int RPT = TILE_ROWS / TILE_THREADS;  // rows a thread
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

// The tiles pass's scratch: [ticket, tiles marked, blocks done, status of
// each row tile], all 0 before a launch and after it.
struct TilesArgs {
  const long long* sg;     // (B,) sorted keys
  const long long* order;  // (B,) the stable sort's permutation
  int32_t* rows;           // (5, B)
  const float* pts;        // (B, 3)
  const float* voxel_size;
  int32_t* dir_check;      // (D,)
  int32_t* dir_slot;       // (D,)
  int32_t* slot_key;       // (T, 3)
  const int32_t* n_alloc;
  const int32_t* n_dropped;
  int32_t* n_alloc_out;
  int32_t* n_dropped_out;
  unsigned* scratch;
  int B, T, nt;
  long long D;
  int32_t empty;
};

// Tickets 0 .. nt - 1 mark: each block takes TILE_ROWS sorted positions (a
// thread every TILE_THREADS-th, so the key and order loads coalesce) and
// flags each tile head's row, aliased (1) or fresh (2), from the directory
// entry its key names, as it stood before any write; it fences and counts
// itself marked.
// Tickets nt .. 2 nt - 1 rank: each block takes TILE_ROWS rows in their
// original order (RPT consecutive rows a thread), gathers their directory
// index, check, point and current slot while the marking runs, waits until
// every tile is marked (those blocks hold earlier tickets, so they are
// running), reads its flags and counts its fresh heads with a block scan,
// publishes the count in its status word and finds its exclusive prefix by
// decoupled look-back (lookback.cuh). A fresh head's rank is then n_alloc +
// prefix + its in-tile inclusive count - 1: the plain version's cumsum
// over row order. Every head that does not overflow the pool writes its
// directory entry and its slot's key (an aliased head keeps its entry's
// slot, which only it writes). The last row tile writes n_alloc (clamped
// at T) and copies n_dropped; the last block to finish sets the scratch
// back to 0.
__global__ void __launch_bounds__(TILE_THREADS) tiled_insert_tiles_kernel(TilesArgs a) {
  __shared__ int s_ticket, s_excl, s_last;
  __shared__ int s_warp[TILE_WARPS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned* ticket = a.scratch;
  unsigned* marked = a.scratch + 1;
  unsigned* done = a.scratch + 2;
  unsigned* status = a.scratch + 3;
  const Rows rows = rows_of(a.rows, a.B);
  if (t == 0) s_ticket = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  const int tk = s_ticket;

  if (tk < a.nt) {
    // the tile heads among this tile's sorted positions: all loads in flight
    const int r0 = tk * TILE_ROWS;
    long long sk[RPT], sp[RPT], o[RPT];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int r = r0 + q * TILE_THREADS + t;
      sk[q] = a.D << 40;
      sp[q] = -1;  // no key before row 0
      o[q] = 0;
      if (r < a.B) {
        sk[q] = a.sg[r];
        if (r > 0) sp[q] = a.sg[r - 1];
        o[q] = a.order[r];
      }
    }
    bool head[RPT];
    int32_t dir[RPT];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      // a valid row's key holds its directory index: no gather of the row
      const long long sdir = sk[q] >> 40;
      head[q] = sdir < a.D && (sp[q] >> 40) != sdir;
      dir[q] = head[q] ? static_cast<int32_t>(sdir) : 0;
    }
    int32_t cur[RPT];
#pragma unroll
    for (int q = 0; q < RPT; ++q) cur[q] = head[q] ? a.dir_check[dir[q]] : 0;
#pragma unroll
    for (int q = 0; q < RPT; ++q)
      if (head[q]) rows.flag[o[q]] = cur[q] != a.empty ? 1 : 2;
    __threadfence();  // the flags before the count of marked tiles
    __syncthreads();
    if (t == 0) atomicAdd(marked, 1u);
  } else {
    const int j = tk - a.nt;  // the row tile
    const int i0 = j * TILE_ROWS + t * RPT;
    const float vs = a.voxel_size[0];
    // the rows' values, gathered while the tiles are marked
    int32_t dir[RPT], chk[RPT], dslot[RPT], kt[RPT][3];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int i = i0 + q;
      dir[q] = chk[q] = dslot[q] = kt[q][0] = kt[q][1] = kt[q][2] = 0;
      if (i < a.B) {
        dir[q] = rows.dir[i];
        chk[q] = rows.chk[i];
        float p[3];
        voxel_of(a.pts, i, vs, p, kt[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < RPT; ++q)
      // read for every row: only an aliased head uses it, and only that
      // head writes its entry
      if (i0 + q < a.B) dslot[q] = a.dir_slot[dir[q]];

    if (t == 0) {
      while (lookback::load_status(marked) < static_cast<unsigned>(a.nt)) {
      }
      __threadfence();
    }
    __syncthreads();
    int f[RPT], nf = 0;
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      f[q] = i0 + q < a.B ? __ldcg(rows.flag + i0 + q) : 0;  // written in this launch
      nf += f[q] == 2;
    }
    // the block's fresh heads: inclusive scan of the threads' counts
    int incl = nf;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = incl - nf, H = 0;
#pragma unroll
    for (int w = 0; w < TILE_WARPS; ++w) {
      if (w < warp) before += s_warp[w];
      H += s_warp[w];
    }
    if (t == 0)
      lookback::store_status(status + j, (j == 0 ? lookback::FLAG_P : lookback::FLAG_A)
                                             | static_cast<unsigned>(H));
    if (warp == 0) {
      const int excl = j ? lookback::count_before(status, j) : 0;
      if (lane == 0) {
        s_excl = excl;
        if (j) lookback::store_status(status + j, lookback::FLAG_P | static_cast<unsigned>(excl + H));
      }
    }
    __syncthreads();
    const int32_t base = a.n_alloc[0];
    int rank = s_excl + before;  // fresh heads before this thread's rows
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      if (!f[q]) continue;
      rank += f[q] == 2;
      const int32_t new_slot = base + (rank - 1);
      if (f[q] == 2 && new_slot >= a.T) continue;  // the pool overflows
      const int32_t slot_w = f[q] == 1 ? dslot[q] : new_slot;
      a.dir_check[dir[q]] = chk[q];
      a.dir_slot[dir[q]] = slot_w;
      if (slot_w >= 0 && slot_w < a.T)
#pragma unroll
        for (int c = 0; c < 3; ++c) a.slot_key[3 * (size_t)slot_w + c] = kt[q][c] >> 3;
    }
    if (j == a.nt - 1 && t == 0) {
      const int32_t n = base + (s_excl + H);
      a.n_alloc_out[0] = n < a.T ? n : a.T;
      a.n_dropped_out[0] = a.n_dropped[0];
    }
  }

  // the last block to finish leaves the scratch at 0 for the next launch
  __syncthreads();
  if (t == 0) s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (s_last) {
    __threadfence();
    for (int k = t; k < a.nt; k += TILE_THREADS) status[k] = 0u;
    if (t == 0) {
      *ticket = 0u;
      *marked = 0u;
      *done = 0u;
    }
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

// the tiles pass's row tiles: at least one, so B = 0 still writes the counts
int tiles_of(int B) { return B > TILE_ROWS ? (B + TILE_ROWS - 1) / TILE_ROWS : 1; }

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

// The scratch a tiles pass over B rows takes: ints, zeroed once by the
// caller; every launch leaves them at 0. -1: B >= 2^30 (the status words
// count rows in 30 bits).
extern "C" int tiled_insert_tiles_scratch_ints(int B) {
  if (B < 0 || static_cast<unsigned>(B) > lookback::VALUE) return -1;
  return 3 + tiles_of(B);
}

// sg, order (B,) int64 (torch.sort's values and indices of gkey), rows
// (5, B) int32 (its flags written), pts, voxel_size as above; the map's
// dir_check, dir_slot (D,) int32 and slot_key (T, 3) int32 written in
// place; n_alloc, n_dropped () int32 read; n_alloc_out, n_dropped_out ()
// int32 written; scratch tiled_insert_tiles_scratch_ints(B) int32, all 0
// (left at 0). One ordinary launch of 2 ceil(B / 1024) blocks (2 at B =
// 0); writes the block count to *grid_out.
extern "C" int tiled_insert_tiles_launch(const void* sg, const void* order, void* rows,
                                         const void* pts, const void* voxel_size,
                                         void* dir_check, void* dir_slot, void* slot_key,
                                         const void* n_alloc, const void* n_dropped,
                                         void* n_alloc_out, void* n_dropped_out, void* scratch,
                                         int B, long long D, int T, int empty_check,
                                         int* grid_out, void* stream) {
  *grid_out = 0;
  if (B < 0 || static_cast<unsigned>(B) > lookback::VALUE || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = tiles_of(B);
  TilesArgs a{static_cast<const long long*>(sg), static_cast<const long long*>(order),
              static_cast<int32_t*>(rows), static_cast<const float*>(pts),
              static_cast<const float*>(voxel_size), static_cast<int32_t*>(dir_check),
              static_cast<int32_t*>(dir_slot), static_cast<int32_t*>(slot_key),
              static_cast<const int32_t*>(n_alloc), static_cast<const int32_t*>(n_dropped),
              static_cast<int32_t*>(n_alloc_out), static_cast<int32_t*>(n_dropped_out),
              static_cast<unsigned*>(scratch), B, T, nt, D, (int32_t)empty_check};
  *grid_out = 2 * nt;
  tiled_insert_tiles_kernel<<<2 * nt, TILE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
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
