// The tiled map's insert around its one sort, for Hopper: two launches.
//
// Replaces no TPU kernel: it is the port of the jitted XLA code of
// fastlivo_tpu/ops/tiled_map.py::insert (:107-200), whose torch version
// ops/tiled_map.py::insert_plain is some 200 small torch ops (the murmur
// mix in int64, fixed-shape masked scatters, cumsums, segmented minima
// and inverse-permutation scatters). ops/tiled_map.py::insert on a CUDA
// map runs
//
//   tiled_insert_sort   one cooperative launch: each row's values and
//                       32-bit sort key (row_key, the device function of
//                       the key pass below): the voxel (a true division by
//                       the device voxel size, then floor), the tile and
//                       its wrapped directory index, the tile's 31-bit
//                       check (hash_mix.cuh), the in-tile cell, the
//                       squared distance to the voxel centre summed
//                       ((e0 e0 + e1 e1) + e2 e2), and the key
//                       (dir_idx << 9 | cell) - 2^31, negative for every
//                       valid row at every directory up to 2^22 entries,
//                       0 for an invalid row; the row's [dir_idx, check,
//                       cell, distance bits, flag 0] written; each
//                       directory field's min and max over the valid rows
//                       by integer atomics into the stream's scratch; each
//                       tile ranked by pass 0's digit, the key's cell byte
//                       (the rank's low byte), and the block's count
//                       published; a grid barrier; then the stable 8-bit
//                       LSD radix passes of csrc/radix_passes.cuh (shared
//                       with the voxel filter's sort, csrc/voxel_keys.cu)
//                       over a compact rank of the key (below), as many as
//                       its bit length needs, decided on the card. Writes the
//                       sorted keys and `order` (int64): torch.sort(
//                       stable=True)'s outputs on the keys, bit for bit,
//                       each (dir_idx, cell) run in row order;
//   tiled_insert_tiles  one ordinary launch of 3 ceil(B / 1024) blocks,
//                       taking 1024-position tiles by an int ticket:
//                       tickets 0 .. nt - 1 mark, in sorted positions, each
//                       directory group's tile winner, the least (distance
//                       bits, row) of the group's first cell run, aliased
//                       or fresh from the directory as it was before any
//                       write; tickets nt .. 2 nt - 1 wait until every tile
//                       is marked, then take the rows in their original
//                       order: a block scan and a decoupled look-back give
//                       each fresh winner its allocation rank (the plain
//                       version's cumsum over row order), and every winner
//                       that does not overflow the pool writes its
//                       directory entry and its slot's key, then counts
//                       its block ranked; tickets 2 nt .. 3 nt - 1 (the
//                       cells pass, `tiled_insert_cells` on the kernel line
//                       of chip_smoke.py) gather their sorted positions'
//                       checks, distance bits and points while the others
//                       run, wait until every row tile is ranked, read the
//                       directory entry of each (dir_idx, cell) run they
//                       head, and find the run's winner, the least
//                       (distance bits, row) of its rows that the entry now
//                       holds (ok rows), in shared memory (a run that
//                       crosses the block's end is finished by its head,
//                       reading on past the end). The winner replaces the
//                       stored cell when that cell is dead or farther from
//                       the voxel centre. The valid rows that are not ok
//                       add to n_dropped (one int atomic a block). Sets
//                       n_alloc (clamped at T).
//
// tiled_insert_keys, the key pass alone (a thread a row: the key and the
// row's values), is on no path since the sort's launch took its place.
//
// Every index a kernel writes is written by one row only (one winner a
// directory entry, one slot a winner, one winner a cell), so the writes
// need no atomics and every launch gives the same bits as the plain
// version. Built with -fmad=false: each product and sum rounds as its
// torch op does.
//
// Bound on an H100: a few tens of bytes and about a hundred integer and
// float operations a row; at the LIO frame's 16384 rows that is ~0.2 us
// of memory traffic a pass, far below a launch, so each pass is held by
// its launch and its chain of dependent loads. The 32-bit key halves the
// sort's radix passes against the 64-bit key that the JAX package packs
// with the distance bits; the winners' distance order moves from the sort
// into the marking and cells tickets, which read it from shared memory.
// The sort's compact rank: with the directory index split into its three
// wrapped tile fields (dir_idx = fx << (l1 + l2) | fy << l2 | fz), a valid
// row's rank is
//   r = ((g_x(fx) R_y + g_y(fy)) R_z + g_z(fz)) 512 + cell,
// g_q(f) the count of the batch's occupied values of field q below f (the
// field's occupancy bitmap, set by integer atomicOr, and its prefix
// popcounts; for a field of more than 8192 values f - min), R_q the count
// of occupied values (max - min + 1), and an invalid row's rank R_x R_y R_z
// 512, above every valid rank. g_q is increasing in f, and the fields and
// the cell do not overlap in the key, so r orders and ties the rows
// exactly as the key does, and a stable sort's permutation is unique: the
// outputs are torch.sort's. A scan's batch spans a few tiles a side but,
// about the world origin where the map starts, straddles the directory's
// wrap (tile -1 is field value dim - 1): its range min .. max then spans
// whole fields (29 bits at the shipped 128 x 128 x 64 directory, 4 passes
// of 8, as many as the key's own), its occupied values a few (the LIO
// path's batches 4 x 4 x 2 tiles: 14 bits, 2 passes). The sort is bound
// by its bytes (each row's point and mask read, 13 B; its sorted key,
// order and row values written, 32 B) and held by its passes' barriers
// and chains, as the voxel filter's sort is. Since 512 divides every rank
// but the cell, pass 0's digit is the key's cell byte, known before the
// extremes are: the keys phase ranks its tiles by it and publishes the
// counts, so pass 0 follows the first barrier with no round of its own.
// The cells pass shares the tiles pass's launch and gathers its rows and
// the stored cells at the entries' slots ahead of its wait, so after the
// directory writes its chain is one round trip, the runs' directory
// entries (two for a run of a fresh tile: then its stored cell).
// The rank stays an exact int prefix through the decoupled look-back that
// csrc/voxel_centroids.cu uses too (lookback.cuh), with no grid barrier
// and no device query. chip_smoke.py counts each pass's bound from its
// inputs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hash_mix.cuh"
#include "lookback.cuh"
#include "phase_stamps.cuh"
#include "radix_passes.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int TILE_ROWS = 1024;  // positions or rows a block of the second launch takes
constexpr int TILE_THREADS = 256;
constexpr int TILE_WARPS = TILE_THREADS / 32;
constexpr int RPT = TILE_ROWS / TILE_THREADS;  // positions or rows a thread
constexpr int TC = 512;  // cells a tile
constexpr unsigned FULL = 0xffffffffu;
constexpr uint32_t KEY_BIAS = 0x80000000u;  // 2^31: key = (dir_idx << 9 | cell) - 2^31

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

__device__ __forceinline__ void voxel_of_point(const float p[3], float vs, int32_t k[3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a) k[a] = (int32_t)floorf(p[a] / vs);
}

// a sorted key's row is valid, and its dir_idx << 9 | cell
__device__ __forceinline__ bool key_valid(int32_t key) { return key < 0; }
__device__ __forceinline__ uint32_t key_cell(int32_t key) {
  return static_cast<uint32_t>(key) ^ KEY_BIAS;
}

__device__ __forceinline__ int32_t clamp_slot(int32_t slot, int T) {
  return slot < 0 ? 0 : (slot > T - 1 ? T - 1 : slot);
}

// the pool cell of a valid key's voxel in a slot
__device__ __forceinline__ size_t cell_of(int32_t slot, int32_t key) {
  return (size_t)slot * TC + (key_cell(key) & (TC - 1));
}

// the rows' shared per-row values, (5, B) int32
struct Rows {
  int32_t* dir;    // wrapped directory index
  int32_t* chk;    // the tile's check
  int32_t* cofs;   // in-tile cell
  int32_t* d2c;    // the distance to the voxel centre, its f32 bits
  int32_t* flag;   // 1 an aliased tile winner, 2 a fresh one, else 0
};

__device__ __forceinline__ Rows rows_of(int32_t* base, int B) {
  return Rows{base, base + B, base + 2 * (size_t)B, base + 3 * (size_t)B, base + 4 * (size_t)B};
}

// A row's values and its sort key, from its point (the first phase of
// both tiled_insert_keys and tiled_insert_sort): the wrapped directory
// index, the tile's check, the in-tile cell, the distance to the voxel
// centre's f32 bits; the key (dir_idx << 9 | cell) - 2^31, or 0 for an
// invalid row.
struct RowVals {
  int32_t dir, chk, cofs, bits;
};

__device__ __forceinline__ int32_t row_key(const float* __restrict__ pts,
                                           const bool* __restrict__ valid, float vs, int l0,
                                           int l1, int l2, int i, RowVals& v) {
  float p[3];
  int32_t k[3];
  voxel_of(pts, i, vs, p, k);
  const int32_t tx = k[0] >> 3, ty = k[1] >> 3, tz = k[2] >> 3;
  v.cofs = ((k[0] & 7) << 6) | ((k[1] & 7) << 3) | (k[2] & 7);
  v.dir = ((tx & ((1 << l0) - 1)) << (l1 + l2)) | ((ty & ((1 << l1) - 1)) << l2)
          | (tz & ((1 << l2) - 1));
  v.chk = check31(tx, ty, tz);
  float e[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) e[a] = p[a] - ((float)k[a] + 0.5f) * vs;
  const float d2c = (e[0] * e[0] + e[1] * e[1]) + e[2] * e[2];
  v.bits = __float_as_int(d2c);
  // dir_idx << 9 | cell < 2^31 at D <= 2^22: minus 2^31 flips the top bit
  const int32_t key = static_cast<int32_t>(((static_cast<uint32_t>(v.dir) << 9)
                                            | static_cast<uint32_t>(v.cofs)) ^ KEY_BIAS);
  return valid[i] ? key : 0;
}

__device__ __forceinline__ void write_row(const Rows& rows, int i, const RowVals& v) {
  rows.dir[i] = v.dir;
  rows.chk[i] = v.chk;
  rows.cofs[i] = v.cofs;
  rows.d2c[i] = v.bits;
  rows.flag[i] = 0;
}

__global__ void __launch_bounds__(THREADS) tiled_insert_keys_kernel(
    const float* __restrict__ pts, const bool* __restrict__ valid,
    const float* __restrict__ voxel_size, const int32_t* __restrict__ log2_dims, int B,
    int32_t* __restrict__ gkey, int32_t* __restrict__ rows_base) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= B) return;
  RowVals v;
  gkey[i] = row_key(pts, valid, voxel_size[0], log2_dims[0], log2_dims[1], log2_dims[2], i, v);
  write_row(rows_of(rows_base, B), i, v);
}

// The sort's first launch phase and pass 0 compute the keys from the rows.
struct KeySource {
  const float* pts;
  const bool* valid;
  float vs;
  int l0, l1, l2;
  __device__ __forceinline__ int32_t key(int i) const {
    RowVals v;
    return row_key(pts, valid, vs, l0, l1, l2, i, v);
  }
};

// The sort's fields: a field of at most DENSE_BITS directory values (the
// shipped 128 x 128 x 64 directory's three) ranks its values by their
// occupancy bitmap, wider ones by their offset from the batch's least.
constexpr int DENSE_BITS = 8192;
constexpr int DENSE_WORDS = DENSE_BITS / 32;
static_assert(DENSE_WORDS == radix::THREADS, "a thread a bitmap word of each field");
constexpr long long FIELD_OFF = 1LL << 22;  // above every directory field
constexpr int BITMAPS = radix::HEAD;  // the fields' bitmaps' first scratch word
constexpr int SORT_HEAD = BITMAPS + 3 * DENSE_WORDS;  // the sort's header words

// The compact rank of a key (see the top), the same in every thread after
// the first barrier.
struct Rank {
  const unsigned* bm;   // (3, DENSE_WORDS) the fields' occupancy bitmaps (shared)
  const unsigned* pre;  // (3, DENSE_WORDS) their exclusive prefix popcounts (shared)
  unsigned lo[3];       // a wide field's least value
  int dense;            // bit q: field q ranks by its bitmap
  unsigned long long ry, rz, rinv;  // R_y, R_z, R_x R_y R_z 512 (an invalid row's rank)
  int l1, l2;
  __device__ __forceinline__ unsigned field(int q, unsigned f) const {
    if (!((dense >> q) & 1)) return f - lo[q];
    const int w = q * DENSE_WORDS + static_cast<int>(f >> 5);
    return pre[w] + __popc(bm[w] & ((1u << (f & 31)) - 1u));
  }
  __device__ __forceinline__ unsigned long long operator()(int32_t key) const {
    if (!key_valid(key)) return rinv;
    const uint32_t c = key_cell(key), dir = c >> 9;
    const uint32_t fx = dir >> (l1 + l2), fy = (dir >> l2) & ((1u << l1) - 1u),
                   fz = dir & ((1u << l2) - 1u);
    return (((static_cast<unsigned long long>(field(0, fx)) * ry + field(1, fy)) * rz
             + field(2, fz)) << 9) + (c & (TC - 1));
  }
};

struct SortArgs {
  const float* pts;           // (B, 3)
  const bool* valid;          // (B,)
  const float* voxel_size;    // ()
  const int32_t* log2_dims;   // (3,)
  int32_t* rows;              // (5, B) out
  radix::Buffers<int32_t> out;
};

// At most 128 registers a thread (two blocks an SM), as the voxel filter's
// sort.
template <int ITEMS>
__global__ void __launch_bounds__(radix::THREADS, 2) tiled_insert_sort_kernel(SortArgs a) {
  __shared__ radix::Shared<int32_t, ITEMS> s;
  __shared__ unsigned s_bm[3 * DENSE_WORDS];   // the fields' occupancy bitmaps
  __shared__ unsigned s_pre[3 * DENSE_WORDS];  // their exclusive prefix popcounts
  __shared__ unsigned s_wpre[3][radix::WARPS];
  PHASE_STAMP_START();
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, b = blockIdx.x;
  const int n = a.out.n;
  const int ntiles = (n + radix::THREADS * ITEMS - 1) / (radix::THREADS * ITEMS);
  const int j0 = b * a.out.tiles, j1 = min(j0 + a.out.tiles, ntiles);  // this block's tiles
  const int l0 = a.log2_dims[0], l1 = a.log2_dims[1], l2 = a.log2_dims[2];
  const int dense = ((1 << l0) <= DENSE_BITS) | ((1 << l1) <= DENSE_BITS) << 1
                    | ((1 << l2) <= DENSE_BITS) << 2;
  const KeySource src{a.pts, a.valid, a.voxel_size[0], l0, l1, l2};
  const Rows rows = rows_of(a.rows, n);
  unsigned* gbm = a.out.ws + BITMAPS;

  // phase 1: the keys, the rows' values written, each field's extremes
  // and occupied values, and each tile ranked by pass 0's digit, the rank's
  // low byte, which is the key's cell byte (0 for an invalid row, whose
  // rank is a multiple of 512): the block's count published before the
  // barrier (the block's last tile's keys and ranking stay)
  if (t < radix::W_DONE) s.red[t] = 0;
#pragma unroll
  for (int q = 0; q < 3; ++q) s_bm[q * DENSE_WORDS + t] = 0;
  __syncthreads();
  int32_t key[ITEMS] = {};
  int row[ITEMS], digit[ITEMS];
  unsigned rnk[ITEMS], tcount = 0, count0 = 0;
  const auto digit0 = [](int32_t k) {
    return key_valid(k) ? static_cast<int>(key_cell(k) & 0xffu) : 0;
  };
  unsigned hi[3] = {0, 0, 0}, lo[3] = {0, 0, 0}, inv = 0;
  for (int j = j0; j < j1; ++j) {
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int pos = radix::position<ITEMS>(j, i);
      row[i] = pos;
      unsigned f[3] = {~0u, ~0u, ~0u};  // a valid row's fields
      if (pos < n) {
        RowVals v;
        key[i] = row_key(src.pts, src.valid, src.vs, l0, l1, l2, pos, v);
        write_row(rows, pos, v);
        if (key_valid(key[i])) {
          const unsigned d = static_cast<unsigned>(v.dir);
          f[0] = d >> (l1 + l2);
          f[1] = (d >> l2) & ((1u << l1) - 1u);
          f[2] = d & ((1u << l2) - 1u);
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            hi[q] = max(hi[q], f[q] + 1u);
            lo[q] = max(lo[q], static_cast<unsigned>(FIELD_OFF) - f[q]);
          }
        } else {
          inv = 1;
        }
      }
      // each value into the block's bitmap where it differs from the lane
      // before's (neighbouring rows mostly share their tiles)
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        if (!((dense >> q) & 1)) continue;
        const unsigned prev = __shfl_up_sync(radix::FULL, f[q], 1);
        if (f[q] != ~0u && (lane == 0 || prev != f[q]))
          atomicOr(&s_bm[q * DENSE_WORDS + (f[q] >> 5)], 1u << (f[q] & 31));
      }
    }
    tcount = radix::rank_tile<ITEMS>(digit0, j, n, key, digit, rnk, s.wcnt);
    count0 += tcount;
  }
  radix::publish_count(a.out, 0, count0);
  radix::reduce_extremes(hi, lo, inv, s, a.out.ws);  // (its __syncthreads orders the bitmaps)
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const unsigned w = s_bm[q * DENSE_WORDS + t];
    if (w) atomicOr(gbm + q * DENSE_WORDS + t, w);
  }
  PHASE_STAMP(1);
  grid.sync();  // every block's extremes and bitmaps in the header
  PHASE_STAMP(2);

  // each dense field's occupied values and their prefix counts: a thread a
  // word of each field, a block scan
  unsigned c[3], incl[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    s_bm[q * DENSE_WORDS + t] = __ldcg(gbm + q * DENSE_WORDS + t);
    c[q] = __popc(s_bm[q * DENSE_WORDS + t]);
    incl[q] = c[q];
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1)
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const unsigned v = __shfl_up_sync(radix::FULL, incl[q], o);
      if (lane >= o) incl[q] += v;
    }
  if (lane == 31)
#pragma unroll
    for (int q = 0; q < 3; ++q) s_wpre[q][warp] = incl[q];
  __syncthreads();
  unsigned count[3] = {0, 0, 0};  // each field's occupied values
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    unsigned before = incl[q] - c[q];
    for (int w = 0; w < radix::WARPS; ++w) {
      before += w < warp ? s_wpre[q][w] : 0u;
      count[q] += s_wpre[q][w];
    }
    s_pre[q * DENSE_WORDS + t] = before;
  }
  __syncthreads();

  const radix::Extent e = radix::extent_of(a.out.ws, FIELD_OFF);
  Rank rank;
  rank.bm = s_bm;
  rank.pre = s_pre;
  rank.dense = dense;
  unsigned long long r[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    rank.lo[q] = static_cast<unsigned>(e.lo[q]);
    r[q] = (dense >> q) & 1 ? count[q] : e.r[q];
  }
  rank.ry = r[1];
  rank.rz = r[2];
  rank.rinv = (r[0] * r[1] * r[2]) << 9;
  rank.l1 = l1;
  rank.l2 = l2;
  const unsigned long long rmax = !e.any ? 0ull : e.inv ? rank.rinv : rank.rinv - 1;
  radix::sort_passes<ITEMS>(grid, src, rank, radix::passes_for(rmax), a.out, s, key, row,
                            digit, rnk, tcount, true, a.out.tiles == 1);
}

// The second launch's scratch, in ints: the ticket, the tiles marked,
// the row tiles ranked, the blocks done, then the status of each row
// tile; all 0 before a launch and after.
constexpr int TICKET = 0, MARKED = 1, RANKED = 2, DONE = 3, STATUS = 4;
struct TilesArgs {
  const int32_t* sg;       // (B,) sorted keys
  const long long* order;  // (B,) the stable sort's permutation
  int32_t* rows;           // (5, B)
  const float* pts;        // (B, 3)
  const float* voxel_size;
  int32_t* dir_check;      // (D,)
  int32_t* dir_slot;       // (D,)
  int32_t* slot_key;       // (T, 3)
  int32_t* cell_check;     // (T * 512,)
  float* pool;             // (T * 512, 3)
  const int32_t* n_alloc;
  const int32_t* n_dropped;
  int32_t* n_alloc_out;
  int32_t* n_dropped_out;
  unsigned* scratch;
  int B, T, nt;
  int32_t empty;
};

// A marking block's sorted positions in shared memory.
struct MarkTile {
  int32_t key[TILE_ROWS];
  int32_t row[TILE_ROWS];
  int32_t bits[TILE_ROWS];
};

// A cells block's sorted positions in shared memory.
struct CellTile {
  int32_t key[TILE_ROWS];
  int32_t chk[TILE_ROWS];
  int32_t bits[TILE_ROWS];
  float p[TILE_ROWS][3];
};

// The least (distance bits, position) of a run: positions come in
// increasing order, so a strictly smaller distance replaces the best.
struct Least {
  int32_t bits = INT_MAX;
  int pos = -1;  // a position in the block's shared tile, or B + the row past its end
  __device__ __forceinline__ void take(int32_t b, int at) {
    if (pos < 0 || b < bits) {
      bits = b;
      pos = at;
    }
  }
};

// Tickets 0 .. nt - 1: each block takes TILE_ROWS sorted positions (a
// thread every TILE_THREADS-th, so the key and order loads coalesce),
// gathers their rows' distance bits into shared memory, and each thread
// at a directory group's first position walks the group's first cell run
// (on past the block's end if the run goes on) for its least (distance
// bits, position); it flags that row, aliased (1) or fresh (2), from the
// directory entry as it stood before any write. Then the block fences and
// counts itself marked.
__device__ void mark_tile(const TilesArgs& a, const Rows& rows, int tk, MarkTile& s) {
  const int t = threadIdx.x;
  const int r0 = tk * TILE_ROWS;
  const int n = min(TILE_ROWS, a.B - r0);  // <= 0 at B = 0
  int32_t key[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int x = q * TILE_THREADS + t;
    key[q] = 0;
    if (x < n) {
      key[q] = a.sg[r0 + x];
      s.key[x] = key[q];
      s.row[x] = static_cast<int32_t>(a.order[r0 + x]);
    }
  }
  // the keys before and past the block: a valid key before it or none
  // (invalid keys sort last)
  const int32_t prev0 = n > 0 && r0 ? a.sg[r0 - 1] : 0;
  const int32_t next = n > 0 && r0 + n < a.B ? a.sg[r0 + n] : 0;
  __syncthreads();
  bool head[RPT];
  int32_t cur[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int x = q * TILE_THREADS + t;
    head[q] = false;
    cur[q] = 0;
    if (x < n) {
      s.bits[x] = rows.d2c[s.row[x]];
      const int32_t prev = x ? s.key[x - 1] : prev0;
      head[q] = key_valid(key[q])
                && (!key_valid(prev) || (key_cell(prev) >> 9) != (key_cell(key[q]) >> 9));
      if (head[q]) cur[q] = a.dir_check[key_cell(key[q]) >> 9];
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    if (!head[q]) continue;
    const int x = q * TILE_THREADS + t;
    Least w;
    int y = x;
    for (; y < n && s.key[y] == key[q]; ++y) w.take(s.bits[y], y);
    int row = s.row[w.pos];
    if (y == n && next == key[q])  // the run goes on past the block's end
      for (int r = r0 + n; r < a.B && a.sg[r] == key[q]; ++r) {
        const int o = static_cast<int>(a.order[r]);
        const int32_t b = rows.d2c[o];
        if (b < w.bits) {
          w.bits = b;
          row = o;
        }
      }
    rows.flag[row] = cur[q] != a.empty ? 1 : 2;
  }
  __threadfence();  // the flags before the count of marked tiles
  __syncthreads();
  if (t == 0) atomicAdd(a.scratch + MARKED, 1u);
  PHASE_STAMP(1);  // the last marking block done
}

// Tickets nt .. 2 nt - 1: each block takes TILE_ROWS rows in their
// original order (RPT consecutive rows a thread), gathers their directory
// index, check, point and current slot while the marking runs, waits
// until every tile is marked (those blocks hold earlier tickets, so they
// are running), reads its flags and counts its fresh winners with a block
// scan, publishes the count in its status word and finds its exclusive
// prefix by decoupled look-back (lookback.cuh). A fresh winner's rank is
// then n_alloc + prefix + its in-tile inclusive count - 1: the plain
// version's cumsum over row order. Every winner that does not overflow
// the pool writes its directory entry and its slot's key (an aliased
// winner keeps its entry's slot, which only it writes). The last row tile
// writes n_alloc (clamped at T) and copies n_dropped; each block then
// fences and counts itself ranked.
__device__ void rank_tile(const TilesArgs& a, const Rows& rows, int j, int* s_warp,
                          int& s_excl) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned* marked = a.scratch + MARKED;
  unsigned* status = a.scratch + STATUS;
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
    // read for every row: only an aliased winner uses it, and only that
    // winner writes its entry
    if (i0 + q < a.B) dslot[q] = a.dir_slot[dir[q]];

  if (t == 0) {
    while (lookback::load_status(marked) < static_cast<unsigned>(a.nt)) {
    }
    __threadfence();
  }
  __syncthreads();
  PHASE_STAMP(2);  // the last ranking block past its wait
  int f[RPT], nf = 0;
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    f[q] = i0 + q < a.B ? __ldcg(rows.flag + i0 + q) : 0;  // written in this launch
    nf += f[q] == 2;
  }
  // the block's fresh winners: inclusive scan of the threads' counts
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
  PHASE_STAMP(3);  // the last ranking block past its look-back
  const int32_t base = a.n_alloc[0];
  int rank = s_excl + before;  // fresh winners before this thread's rows
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
  __threadfence();  // the directory and the counts before the count of ranked tiles
  __syncthreads();
  if (t == 0) atomicAdd(a.scratch + RANKED, 1u);
  PHASE_STAMP(4);  // the last ranking block done
}

// Tickets 2 nt .. 3 nt - 1, the cells pass: each block takes TILE_ROWS
// sorted positions and, while the marking and ranking run (none of it
// depends on the directory writes), gathers their keys, checks, distance
// bits and points into shared memory and loads, for each (dir_idx, cell)
// run it heads, the stored cell and its check at the slot the run's entry
// holds before the writes. It waits until every row tile is ranked; each
// thread at a run's first position reads the run's directory entry (all
// heads at once) and walks the run for its least (distance bits,
// position) among the rows that entry holds (ok rows), on past the
// block's end if the run goes on. An entry that was live keeps its slot,
// so the stored cell is mostly loaded already (else it is loaded now);
// the winner replaces it where it is dead or farther from the voxel
// centre. The run's rows that are not ok are dropped: one int atomic a
// block adds them to n_dropped.
__device__ void cells_tile(const TilesArgs& a, const Rows& rows, int c, CellTile& s,
                           int* s_warp) {
  const int t = threadIdx.x;
  const unsigned* ranked = a.scratch + RANKED;
  const int r0 = c * TILE_ROWS;
  const int n = min(TILE_ROWS, a.B - r0);
  const float vs = a.voxel_size[0];
  int32_t key[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int x = q * TILE_THREADS + t;
    key[q] = 0;
    if (x < n) {
      key[q] = a.sg[r0 + x];
      s.key[x] = key[q];
      const int o = static_cast<int>(a.order[r0 + x]);
      s.chk[x] = rows.chk[o];
      s.bits[x] = rows.d2c[o];
#pragma unroll
      for (int d = 0; d < 3; ++d) s.p[x][d] = a.pts[3 * o + d];
    }
  }
  const int32_t prev0 = n > 0 && r0 ? a.sg[r0 - 1] : 0;  // the keys before and past it
  const int32_t next = n > 0 && r0 + n < a.B ? a.sg[r0 + n] : 0;
  __syncthreads();
  // the runs this block heads, and each one's stored cell as the directory
  // stands before the tiles pass's writes: an entry that was live keeps
  // its slot through them, so where the slot holds after the wait the
  // cell is already loaded (only this thread writes it)
  bool head[RPT];
  int32_t pre_slot[RPT], pre_chk[RPT];
  float pre_p[RPT][3];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int x = q * TILE_THREADS + t;
    head[q] = false;
    pre_slot[q] = -1;
    if (x < n) {
      const int32_t prev = x ? s.key[x - 1] : prev0;
      head[q] = key_valid(key[q]) && (x + r0 == 0 || prev != key[q]);
      if (head[q]) pre_slot[q] = clamp_slot(__ldcg(a.dir_slot + (key_cell(key[q]) >> 9)), a.T);
    }
  }
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    pre_chk[q] = 0;
#pragma unroll
    for (int d = 0; d < 3; ++d) pre_p[q][d] = 0.0f;
    if (!head[q]) continue;
    const size_t cell = cell_of(pre_slot[q], key[q]);
    pre_chk[q] = a.cell_check[cell];
#pragma unroll
    for (int d = 0; d < 3; ++d) pre_p[q][d] = a.pool[3 * cell + d];
  }
  PHASE_STAMP(5);  // the last cells block's rows gathered
  if (t == 0) {
    while (lookback::load_status(ranked) < static_cast<unsigned>(a.nt)) {
    }
    __threadfence();
  }
  __syncthreads();
  PHASE_STAMP(6);  // the last cells block past its wait
  // the runs' directory entries, written in this launch
  int32_t cur[RPT], slot[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    cur[q] = slot[q] = 0;
    if (!head[q]) continue;
    const uint32_t d = key_cell(key[q]) >> 9;
    cur[q] = __ldcg(a.dir_check + d);
    slot[q] = clamp_slot(__ldcg(a.dir_slot + d), a.T);
  }
  // each run's winner: its distance bits, point and pool cell
  int dropped = 0;
  bool win[RPT];
  int32_t wbits[RPT];
  float wp[RPT][3];
  size_t wcell[RPT];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    win[q] = false;
    wbits[q] = 0;
    wcell[q] = 0;
    if (!head[q]) continue;
    const int x = q * TILE_THREADS + t;
    Least w;
    int y = x;
    for (; y < n && s.key[y] == key[q]; ++y) {
      if (s.chk[y] == cur[q]) w.take(s.bits[y], y);
      else ++dropped;
    }
    if (w.pos >= 0)
#pragma unroll
      for (int d = 0; d < 3; ++d) wp[q][d] = s.p[w.pos][d];
    if (y == n && next == key[q])  // the run goes on past the block's end
      for (int r = r0 + n; r < a.B && a.sg[r] == key[q]; ++r) {
        const int o = static_cast<int>(a.order[r]);
        if (rows.chk[o] != cur[q]) {
          ++dropped;
          continue;
        }
        const int32_t b = rows.d2c[o];
        if (w.pos < 0 || b < w.bits) {
          w.bits = b;
          w.pos = a.B + o;
        }
      }
    if (w.pos < 0) continue;  // no row of the run holds its tile
    if (w.pos >= a.B)
#pragma unroll
      for (int d = 0; d < 3; ++d) wp[q][d] = a.pts[3 * (w.pos - a.B) + d];
    win[q] = true;
    wbits[q] = w.bits;
    wcell[q] = cell_of(slot[q], key[q]);
  }
  PHASE_STAMP(7);  // the last cells block's runs walked
  // the winners' stored cells: loaded before the wait where the slot held,
  // else now, all loads in flight before any write
  int32_t stored_chk[RPT];
  float stored[RPT][3];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    stored_chk[q] = pre_chk[q];
#pragma unroll
    for (int d = 0; d < 3; ++d) stored[q][d] = pre_p[q][d];
    if (!win[q] || slot[q] == pre_slot[q]) continue;
    stored_chk[q] = a.cell_check[wcell[q]];
#pragma unroll
    for (int d = 0; d < 3; ++d) stored[q][d] = a.pool[3 * wcell[q] + d];
  }
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    if (!win[q]) continue;
    int32_t k[3];
    voxel_of_point(wp[q], vs, k);
    float es[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) es[d] = stored[q][d] - ((float)k[d] + 0.5f) * vs;
    const float stored_d2c = (es[0] * es[0] + es[1] * es[1]) + es[2] * es[2];
    if (stored_chk[q] != cur[q] || __int_as_float(wbits[q]) < stored_d2c) {
      a.cell_check[wcell[q]] = cur[q];
#pragma unroll
      for (int d = 0; d < 3; ++d) a.pool[3 * wcell[q] + d] = wp[q][d];
    }
  }
  PHASE_STAMP(8);  // the last cells block's cells written
  // the block's dropped rows, one atomic
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dropped += __shfl_down_sync(FULL, dropped, o);
  if ((t & 31) == 0) s_warp[t >> 5] = dropped;
  __syncthreads();
  if (t == 0) {
    int sum = 0;
    for (int w = 0; w < TILE_WARPS; ++w) sum += s_warp[w];
    if (sum) atomicAdd(a.n_dropped_out, sum);
  }
}

__global__ void __launch_bounds__(TILE_THREADS) tiled_insert_tiles_kernel(TilesArgs a) {
  __shared__ int s_ticket, s_excl, s_last;
  __shared__ int s_warp[TILE_WARPS];
  __shared__ union {
    MarkTile mark;
    CellTile cells;
  } s;
  const int t = threadIdx.x;

  const Rows rows = rows_of(a.rows, a.B);
  PHASE_STAMP_START();
  if (t == 0) s_ticket = static_cast<int>(atomicAdd(a.scratch + TICKET, 1u));
  __syncthreads();
  const int tk = s_ticket;
  if (tk < a.nt)
    mark_tile(a, rows, tk, s.mark);
  else if (tk < 2 * a.nt)
    rank_tile(a, rows, tk - a.nt, s_warp, s_excl);
  else
    cells_tile(a, rows, tk - 2 * a.nt, s.cells, s_warp);

  // the last block to finish leaves the scratch at 0 for the next launch
  __syncthreads();
  if (t == 0) s_last = atomicAdd(a.scratch + DONE, 1u) == gridDim.x - 1;
  __syncthreads();
  if (s_last) {
    __threadfence();
    for (int k = t; k < a.nt; k += TILE_THREADS) a.scratch[STATUS + k] = 0u;
    if (t == 0) a.scratch[TICKET] = a.scratch[MARKED] = a.scratch[RANKED] = a.scratch[DONE] = 0u;
  }
  PHASE_STAMP(9);  // the last block done
}

int blocks_of(int n) { return (n + THREADS - 1) / THREADS; }

// the row tiles: at least one, so B = 0 still writes the counts
int tiles_of(int B) { return B > TILE_ROWS ? (B + TILE_ROWS - 1) / TILE_ROWS : 1; }

// rows a thread in a sort tile: tiles of 512 rows (32 blocks at the LIO
// path's 16384) measured faster than of 1024 (16 blocks) and as fast as of
// 256 (scripts/torch_vio_kernels_bench.py, PERF.md)
constexpr int SORT_ITEMS = 2;
constexpr int SORT_TILE = radix::THREADS * SORT_ITEMS;
int g_resident[radix::MAX_DEV];

}  // namespace

// C interface for ctypes. Every pointer is to contiguous device memory;
// each function returns the launch's cudaError_t (0 = cudaSuccess).
//
// pts (B, 3) f32, valid (B,) bool, voxel_size () f32, log2_dims (3,)
// int32 (a directory of at most 2^22 entries); writes gkey (B,) int32 and
// rows (5, B) int32. B = 0 launches nothing.
extern "C" int tiled_insert_keys_launch(const void* pts, const void* valid,
                                        const void* voxel_size, const void* log2_dims,
                                        void* gkey, void* rows, int B, void* stream) {
  if (B <= 0) return 0;
  tiled_insert_keys_kernel<<<blocks_of(B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const bool*>(valid),
      static_cast<const float*>(voxel_size), static_cast<const int32_t*>(log2_dims), B,
      static_cast<int32_t*>(gkey), static_cast<int32_t*>(rows));
  return static_cast<int>(cudaGetLastError());
}

// The scratch the sort of B rows takes: 32-bit words, zeroed once by the
// caller; every launch leaves them at 0. -1: B >= 2^30 (as the second
// launch).
extern "C" int tiled_insert_sort_scratch_ints(int B) {
  if (B < 0 || static_cast<unsigned>(B) > lookback::VALUE) return -1;
  return radix::scratch_ints(B, SORT_TILE, SORT_HEAD);
}

// pts, valid, voxel_size, log2_dims as tiled_insert_keys_launch; writes
// sg (B,) int32 (the keys in sorted order), order (B,) int64 (the stable
// sort's permutation) and rows (5, B) int32 (each row's values, flag 0):
// tiled_insert_keys' outputs and torch.sort(stable=True)'s of its keys.
// tmp_keys, tmp_rows (B,) int32: the passes' other buffer; ws
// tiled_insert_sort_scratch_ints(B) int32 zeros (left at 0). One
// cooperative launch; a block takes consecutive tiles of 512 rows, one
// while the tiles fit on the card at once. B = 0 launches nothing. Writes
// the grid's block count to *grid_out and the tiles a block to *tiles_out.
extern "C" int tiled_insert_sort_launch(const void* pts, const void* valid,
                                        const void* voxel_size, const void* log2_dims,
                                        void* sg, void* order, void* tmp_keys, void* tmp_rows,
                                        void* rows, void* ws, int B, int* grid_out,
                                        int* tiles_out, void* stream) {
  *grid_out = 0;
  *tiles_out = 0;
  if (tiled_insert_sort_scratch_ints(B) < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  const void* kernel = reinterpret_cast<const void*>(tiled_insert_sort_kernel<SORT_ITEMS>);
  int resident = 0;
  cudaError_t e = radix::resident_blocks(kernel, g_resident, &resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  int grid = 0, tiles = 0;
  radix::plan(B, SORT_TILE, resident, &grid, &tiles);
  SortArgs a{static_cast<const float*>(pts), static_cast<const bool*>(valid),
             static_cast<const float*>(voxel_size), static_cast<const int32_t*>(log2_dims),
             static_cast<int32_t*>(rows),
             radix::Buffers<int32_t>{static_cast<int32_t*>(sg), static_cast<long long*>(order),
                                     static_cast<int32_t*>(tmp_keys),
                                     static_cast<int*>(tmp_rows), static_cast<unsigned*>(ws),
                                     SORT_HEAD, B, tiles}};
  void* args[] = {&a};
  *grid_out = grid;
  *tiles_out = tiles;
  e = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(grid)),
                                  dim3(radix::THREADS), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The scratch the second launch over B rows takes: ints, zeroed once by
// the caller; every launch leaves them at 0. -1: B >= 2^30 (the status
// words count rows in 30 bits).
extern "C" int tiled_insert_tiles_scratch_ints(int B) {
  if (B < 0 || static_cast<unsigned>(B) > lookback::VALUE) return -1;
  return STATUS + tiles_of(B);
}

// sg (B,) int32, order (B,) int64 (torch.sort's values and indices of
// gkey), rows (5, B) int32 (its flags written), pts, voxel_size as above;
// the map's dir_check, dir_slot (D,) int32, slot_key (T, 3) int32,
// cell_check (T * 512,) int32 and pts (T * 512, 3) f32 written in place;
// n_alloc, n_dropped () int32 read; n_alloc_out, n_dropped_out () int32
// written; scratch tiled_insert_tiles_scratch_ints(B) int32, all 0 (left
// at 0). One ordinary launch of 3 ceil(B / 1024) blocks (3 at B = 0):
// the tiles pass and the cells pass; writes the block count to
// *grid_out.
extern "C" int tiled_insert_tiles_launch(const void* sg, const void* order, void* rows,
                                         const void* pts, const void* voxel_size,
                                         void* dir_check, void* dir_slot, void* slot_key,
                                         void* cell_check, void* pool, const void* n_alloc,
                                         const void* n_dropped, void* n_alloc_out,
                                         void* n_dropped_out, void* scratch, int B, int T,
                                         int empty_check, int* grid_out, void* stream) {
  *grid_out = 0;
  if (B < 0 || static_cast<unsigned>(B) > lookback::VALUE || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nt = tiles_of(B);
  TilesArgs a{static_cast<const int32_t*>(sg), static_cast<const long long*>(order),
              static_cast<int32_t*>(rows), static_cast<const float*>(pts),
              static_cast<const float*>(voxel_size), static_cast<int32_t*>(dir_check),
              static_cast<int32_t*>(dir_slot), static_cast<int32_t*>(slot_key),
              static_cast<int32_t*>(cell_check), static_cast<float*>(pool),
              static_cast<const int32_t*>(n_alloc), static_cast<const int32_t*>(n_dropped),
              static_cast<int32_t*>(n_alloc_out), static_cast<int32_t*>(n_dropped_out),
              static_cast<unsigned*>(scratch), B, T, nt, (int32_t)empty_check};
  *grid_out = 3 * nt;
  tiled_insert_tiles_kernel<<<3 * nt, TILE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

PHASE_STAMPS_EXPORT(tiled_insert)
