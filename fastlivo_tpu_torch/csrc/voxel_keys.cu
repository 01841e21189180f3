// The scan voxel filter's keys and their stable sort, for Hopper.
//
// Replaces no TPU kernel: it is the port of the jitted XLA code of
// fastlivo_tpu/ops/voxel_filter.py::voxel_downsample_device up to and with
// its argsort (:41-53: the finite test, floor(p / leaf), the cast to
// int64, the 3 x 20-bit packing, the invalid marker, the stable argsort of
// the packed keys), whose torch version is
// ops/voxel_filter.py::_sorted_keys_plain: voxel_keys_plain (~20 ops) and
// torch.sort(stable=True) (CUB's onesweep over all 64 bits: 8 digit
// launches, its histogram and memsets).
//
// The key (packed_key, one device function for both launches): row i of
// pts (n, c) f32 (its first three columns; rows c floats apart) with
// valid[i] u8 gets
//   ((kx + 2^19) & 0xFFFFF) << 40 | ((ky + 2^19) & 0xFFFFF) << 20
//   | ((kz + 2^19) & 0xFFFFF),   k = (int64) floor(p / leaf)
// (or floor(p * inv_leaf), the camera frame's form), in int64
// two's-complement arithmetic, so that a coordinate past +-2^19 voxels
// wraps as torch's ops wrap it; a row that is not valid or has a
// coordinate that is not finite gets the marker 2^62 (its coordinates
// never reach the cast). The division is IEEE f32 (no --use_fast_math,
// -prec-div at its default), floorf is exact, and the float -> int64 cast
// is cvt.rzi.s64.f32, the instruction torch's CUDA cast compiles to
// (saturating), so the keys are the plain version's bits on the card.
//
// voxel_keys_kernel: the keys alone, a thread a row (the `voxel_keys`
// wrapper; no path runs it since the sort below took its place).
//
// voxel_sort_kernel: the keys, their stable sort's permutation `order`
// and the keys in that order, bit-equal to torch.sort(voxel_keys_plain(..),
// stable=True), in one cooperative launch with no host read. A scan at 0.5
// m or a camera cloud at 0.2 m spans a few hundred voxels a side, so most
// of a key's 64 bits are constant; the launch sorts a compact rank
// instead:
//   r = ((fx - min_x) R_y + (fy - min_y)) R_z + (fz - min_z),
// f the key's three 20-bit fields, min and max over the valid rows, R =
// max - min + 1, and R_x R_y R_z for an invalid row. The fields do not
// overlap and the marker lies above them, so r orders and ties the rows
// exactly as the packed key does (a stable sort's permutation is unique,
// so the two sorts give the same permutation). The rows are cut into
// tiles of 1024 positions; a block takes consecutive tiles (one while the
// tiles fit on the card at once, as at the main path's 32768 rows: its
// rows then stay in registers from phase to phase; more past that, each
// computed or loaded again where it is used). Phase 1: each block computes
// its tiles' keys and reduces each field's min and max and a has-invalid
// flag into the scratch by integer atomics (max of f + 1 and of 2^20 - f:
// the scratch's 0 is "no row"). Grid barrier. Every thread reads them and
// derives R and the pass count ceil(bits(r_max) / 8) on the device (0
// where every rank is equal: the identity; up to 8 where the spread needs
// all 60 bits and the marker). Then stable LSD radix passes of 8 bits over
// (key, row), r recomputed from the key each pass: a warp holds 32 * 4
// positions of a tile, item i of lane l at position i * 32 + l (coalesced
// loads), and ranks its items in order by ballots on the digit's bits and
// a counter per warp and digit in shared memory; a thread a digit
// turns the counters into the warps' offsets and the tile's count. A
// digit's first position in a block is the exclusive scan over digits of
// every block's counts plus the same digit's count in the blocks before,
// read from the pass's histogram (G x 256 words), and moves on by each
// tile's count. A tile is put in its sorted order in shared memory first
// (each digit's rows from the digit's first place in the tile), then
// written out a thread a place, so that a warp writes runs of consecutive
// positions. Pass 0's histogram is each block's own count, stored and
// shared by a second grid barrier; pass p + 1's is accumulated during
// pass p's writes: each row adds one (an integer atomic) to the count of
// its next digit in the block its new position falls in, so the grid
// barrier that ends pass p also completes pass p + 1's histogram (one
// barrier a pass, passes + 1 in all). The histograms rotate through three
// buffers; a block zeroes its row of the buffer read two passes back, and
// the last block to finish zeroes the last pass's buffer and the header,
// so the scratch the wrapper zeroed once is back at 0 for the stream's
// next launch. The passes alternate between (tmp_keys, tmp_rows) and the
// outputs, the last pass writing keys and order (int64). Scratch written
// in the launch is read through L2 (__ldcg); integer atomics only: every
// launch gives the same bits.
//
// Bound on an H100: the sort reads 12 B of each row and its valid byte and
// writes 16 B (keys and order; ~0.3 us at the LIO scan's 32768 rows); its
// operations (the key's ~30 a row, ~20 a row and pass) are far below that.
// What holds it: the launch, its passes + 1 grid barriers (~1 us each on
// this card) and the chains inside a pass (a warp's items in order, the
// G-row histogram sum, the digit scan). Built with -DPHASE_STAMPS
// (csrc/phase_stamps.cuh) the launch stamps the keys, the first barrier,
// pass 0's count and second barrier, and each pass's offsets, ranking and
// scatter, and barrier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "phase_stamps.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr long long INVALID = 1LL << 62;
constexpr long long OFF = 1LL << 19;
constexpr long long MASK20 = 0xFFFFF;
constexpr unsigned FULL = 0xffffffffu;

// the sort's shape: 256 threads, one digit each in the offset phase
constexpr int SORT_THREADS = 256;
constexpr int WARPS = SORT_THREADS / 32;
constexpr int DIGIT_BITS = 8;
constexpr int DIGITS = 1 << DIGIT_BITS;
static_assert(DIGITS == SORT_THREADS, "a thread a digit");
// scratch header (32-bit words): each field's max + 1, each field's 2^20 -
// min, has-invalid, the count of finished blocks; the histograms follow
constexpr int W_HI = 0, W_LO = 3, W_INV = 6, W_DONE = 7, HEAD = 16;
constexpr int NBUF = 3;  // rotating histogram buffers

// The packed key of row i (see the top): the key pass of both launches.
__device__ __forceinline__ long long packed_key(const float* __restrict__ pts,
                                                const uint8_t* __restrict__ valid, float s,
                                                int divide, int i, int c) {
  const float* p = pts + static_cast<size_t>(i) * c;
  const float x = p[0], y = p[1], z = p[2];
  if (!(valid[i] && isfinite(x) && isfinite(y) && isfinite(z))) return INVALID;
  const long long kx = static_cast<long long>(floorf(divide ? x / s : x * s));
  const long long ky = static_cast<long long>(floorf(divide ? y / s : y * s));
  const long long kz = static_cast<long long>(floorf(divide ? z / s : z * s));
  return ((kx + OFF) & MASK20) << 40 | ((ky + OFF) & MASK20) << 20 | ((kz + OFF) & MASK20);
}

// divide: keys floor(p / scale) (the LIO scan's 0-d leaf), else floor(p *
// scale) (the camera cloud's f32 reciprocal of its leaf)
__global__ void __launch_bounds__(THREADS)
    voxel_keys_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ valid,
                      const float* __restrict__ scale, int divide, long long* __restrict__ out,
                      int n, int c) {
  PHASE_STAMP_START();
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < n) out[i] = packed_key(pts, valid, *scale, divide, i, c);
  PHASE_STAMP(1);
}

struct Sort {
  const float* pts;      // (n, c)
  const uint8_t* valid;  // (n,)
  const float* scale;    // ()
  long long* keys;       // (n,) out: the keys in sorted order
  long long* order;      // (n,) out: the stable sort's permutation
  long long* tmp_keys;   // (n,) the passes' other buffer
  int* tmp_rows;         // (n,)
  unsigned* ws;          // scratch: HEAD + NBUF G DIGITS words, zeros, left at 0
  int divide, n, c;
  int tiles;             // tiles a block (the last block may have fewer)
};

// The compact rank's parameters, the same in every thread after the first
// barrier.
struct Span {
  long long lo[3];
  unsigned long long ry, rz, rinv;  // R_y, R_z, R_x R_y R_z (an invalid row's rank)
  int passes;
};

__device__ __forceinline__ unsigned long long rank_of(long long key, const Span& s) {
  if (key == INVALID) return s.rinv;
  const long long fx = (key >> 40) & MASK20, fy = (key >> 20) & MASK20, fz = key & MASK20;
  return (static_cast<unsigned long long>(fx - s.lo[0]) * s.ry +
          static_cast<unsigned long long>(fy - s.lo[1])) * s.rz +
         static_cast<unsigned long long>(fz - s.lo[2]);
}

__device__ __forceinline__ int digit_of(long long key, const Span& s, int p) {
  return static_cast<int>((rank_of(key, s) >> (DIGIT_BITS * p)) & (DIGITS - 1));
}

// The lanes of `in` holding the same digit as this lane, by one ballot a
// digit bit.
__device__ __forceinline__ unsigned same_digit(int d, unsigned in) {
  unsigned peers = in;
#pragma unroll
  for (int bit = 0; bit < DIGIT_BITS; ++bit) {
    const unsigned bal = __ballot_sync(FULL, (d >> bit) & 1);
    peers &= (d >> bit) & 1 ? bal : ~bal;
  }
  return peers;
}

// A tile's elements, item i of the thread at position tile * TILE + warp *
// 32 * ITEMS + i * 32 + lane: pass 0 computes the keys of those rows, a
// later pass reads (key, row) where the pass before left them (the outputs
// when `from_out`, else the other buffer). Positions past n: INVALID.
template <int ITEMS>
__device__ __forceinline__ void load_tile(const Sort& a, int tile, int p, bool from_out,
                                          long long key[ITEMS], int row[ITEMS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int seg = tile * SORT_THREADS * ITEMS + warp * 32 * ITEMS;
  const float s = p == 0 ? *a.scale : 0.f;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int pos = seg + i * 32 + lane;
    key[i] = INVALID;
    row[i] = pos;
    if (pos < a.n) {
      if (p == 0) {
        key[i] = packed_key(a.pts, a.valid, s, a.divide, pos, a.c);
      } else {
        key[i] = from_out ? __ldcg(a.keys + pos) : __ldcg(a.tmp_keys + pos);
        row[i] = from_out ? static_cast<int>(__ldcg(a.order + pos)) : __ldcg(a.tmp_rows + pos);
      }
    }
  }
}

// A tile's ranking in pass p: each warp's items in order among its equal
// digits (rnk), then thread t turns the warps' counts of digit t into their
// offsets in s_wcnt and returns the tile's count of digit t.
template <int ITEMS>
__device__ __forceinline__ unsigned rank_tile(const Span& sp, int p, int tile, int n,
                                              const long long key[ITEMS], int digit[ITEMS],
                                              unsigned rnk[ITEMS],
                                              unsigned (*s_wcnt)[DIGITS]) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int seg = tile * SORT_THREADS * ITEMS + warp * 32 * ITEMS;
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int k = lane; k < DIGITS; k += 32) s_wcnt[warp][k] = 0;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const bool in = seg + i * 32 + lane < n;
    digit[i] = in ? digit_of(key[i], sp, p) : 0;
    const unsigned peers = same_digit(digit[i], __ballot_sync(FULL, in));
    unsigned before = 0;
    if (in) {
      before = s_wcnt[warp][digit[i]];
      rnk[i] = before + __popc(peers & lt);
    }
    __syncwarp();
    if (in && lane == __ffs(peers) - 1) s_wcnt[warp][digit[i]] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  unsigned count = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const unsigned c = s_wcnt[w][t];
    s_wcnt[w][t] = count;
    count += c;
  }
  __syncthreads();
  return count;
}

// At most 128 registers a thread (two blocks an SM): left to itself ptxas
// gave some builds of this kernel 64 and spills, and those ran 10-30%
// slower on the card (scripts/torch_vio_kernels_bench.py, PERF.md).
template <int ITEMS>
__global__ void __launch_bounds__(SORT_THREADS, 2) voxel_sort_kernel(Sort a) {
  constexpr int TILE = SORT_THREADS * ITEMS;
  __shared__ unsigned s_wcnt[WARPS][DIGITS];  // a warp's count, then offset, of each digit
  __shared__ unsigned s_base[DIGITS];         // each digit's next position in this block
  __shared__ unsigned s_tstart[DIGITS];       // each digit's first place in the tile's order
  __shared__ long long s_key[TILE];           // the tile in its sorted order
  __shared__ int s_row[TILE];
  __shared__ uint8_t s_dig[TILE];
  __shared__ unsigned s_red[W_DONE];          // the block's extremes and invalid flag
  __shared__ unsigned s_wsum[WARPS];
  __shared__ int s_last;
  PHASE_STAMP_START();
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, b = blockIdx.x, G = gridDim.x;
  const int n = a.n;
  const int ntiles = (n + TILE - 1) / TILE;
  const int j0 = b * a.tiles, j1 = min(j0 + a.tiles, ntiles);  // this block's tiles
  const bool one = a.tiles == 1;  // its one tile kept in registers from pass to pass
  const unsigned span = static_cast<unsigned>(a.tiles) * TILE;  // positions a block
  unsigned* hist = a.ws + HEAD;
  const size_t hsize = static_cast<size_t>(G) * DIGITS;

  // phase 1: the keys' extremes (the block's last tile's keys stay)
  if (t < W_DONE) s_red[t] = 0;
  __syncthreads();
  long long key[ITEMS];
  int row[ITEMS], digit[ITEMS];
  unsigned rnk[ITEMS];
  unsigned hi[3] = {0, 0, 0}, lo[3] = {0, 0, 0}, inv = 0;
  for (int j = j0; j < j1; ++j) {
    load_tile<ITEMS>(a, j, 0, false, key, row);
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (row[i] >= n) continue;
      if (key[i] == INVALID) {
        inv = 1;
        continue;
      }
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const unsigned f = static_cast<unsigned>((key[i] >> (40 - 20 * q)) & MASK20);
        hi[q] = max(hi[q], f + 1u);
        lo[q] = max(lo[q], (1u << 20) - f);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    hi[q] = __reduce_max_sync(FULL, hi[q]);
    lo[q] = __reduce_max_sync(FULL, lo[q]);
  }
  inv = __reduce_max_sync(FULL, inv);
  if (lane == 0) {
    for (int q = 0; q < 3; ++q) {
      atomicMax(&s_red[W_HI + q], hi[q]);
      atomicMax(&s_red[W_LO + q], lo[q]);
    }
    atomicMax(&s_red[W_INV], inv);
  }
  __syncthreads();
  if (t < W_DONE && s_red[t]) atomicMax(a.ws + t, s_red[t]);
  PHASE_STAMP(1);
  grid.sync();  // A: every block's extremes in the header
  PHASE_STAMP(2);

  Span sp;
  {
    unsigned w[W_DONE];
#pragma unroll
    for (int k = 0; k < W_DONE; ++k) w[k] = __ldcg(a.ws + k);
    unsigned long long rmax = 0;
    sp.ry = sp.rz = sp.rinv = 0;
    sp.lo[0] = sp.lo[1] = sp.lo[2] = 0;
    if (w[W_HI] != 0) {  // a valid row
      unsigned long long r[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        sp.lo[q] = (1LL << 20) - static_cast<long long>(w[W_LO + q]);
        r[q] = static_cast<unsigned long long>(static_cast<long long>(w[W_HI + q]) - sp.lo[q]);
      }
      sp.ry = r[1];
      sp.rz = r[2];
      sp.rinv = r[0] * r[1] * r[2];
      rmax = w[W_INV] ? sp.rinv : sp.rinv - 1;
    }
    sp.passes = rmax ? (64 - __clzll(static_cast<long long>(rmax)) + DIGIT_BITS - 1) / DIGIT_BITS
                     : 0;
  }

  if (sp.passes == 0) {  // every rank equal: the identity
    for (int j = j0; j < j1; ++j) {
      if (!one) load_tile<ITEMS>(a, j, 0, false, key, row);
#pragma unroll
      for (int i = 0; i < ITEMS; ++i)
        if (row[i] < n) {
          a.keys[row[i]] = key[i];
          a.order[row[i]] = row[i];
        }
    }
  }
  unsigned tcount = 0;  // the current tile's count of digit t
  if (sp.passes > 0) {  // pass 0's count of each digit in this block's tiles, for all blocks
    unsigned count = 0;
    for (int j = j0; j < j1; ++j) {
      if (!one) load_tile<ITEMS>(a, j, 0, false, key, row);
      tcount = rank_tile<ITEMS>(sp, 0, j, n, key, digit, rnk, s_wcnt);
      count += tcount;
    }
    hist[static_cast<size_t>(b) * DIGITS + t] = count;
    PHASE_STAMP_IT(0, 0);
    grid.sync();  // B: every block's pass-0 count
  }
  for (int p = 0; p < sp.passes; ++p) {
    PHASE_STAMP_IT(p, 1);
    const bool last = p == sp.passes - 1;
    const bool to_out = ((sp.passes - 1 - p) & 1) == 0;  // the last pass writes the outputs
    // the digit's count in the blocks before this one, and in all: the
    // column's words loaded 32 at a time, all in flight together
    const unsigned* H = hist + static_cast<size_t>(p % NBUF) * hsize;
    unsigned before = 0, total = 0;
    {
      const unsigned* col = H + t;
      int k = 0;
      for (; k + 32 <= G; k += 32) {
        unsigned v[32];
#pragma unroll
        for (int u = 0; u < 32; ++u) v[u] = __ldcg(col + static_cast<size_t>(k + u) * DIGITS);
#pragma unroll
        for (int u = 0; u < 32; ++u) {
          total += v[u];
          before += k + u < b ? v[u] : 0u;
        }
      }
      for (; k < G; ++k) {
        const unsigned v = __ldcg(col + static_cast<size_t>(k) * DIGITS);
        total += v;
        before += k < b ? v : 0u;
      }
    }
    // exclusive scan of the totals over the digits
    unsigned incl = total;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) s_wsum[warp] = incl;
    // this block's row of the histogram read two passes back, for pass p + 2
    if (p > 0)
      hist[static_cast<size_t>((p + 2) % NBUF) * hsize + static_cast<size_t>(b) * DIGITS + t] = 0;
    __syncthreads();
    unsigned off = incl - total + before;
    for (int w = 0; w < warp; ++w) off += s_wsum[w];
    s_base[t] = off;
    __syncthreads();
    PHASE_STAMP_IT(p, 2);
    // each tile in order: its ranking; the tile put in its sorted order in
    // shared memory (each digit's rows from its first place there), then
    // written out a thread a place, so that a warp's writes are contiguous
    // runs; the next pass's histogram by the blocks the rows land in
    unsigned* Hn = hist + static_cast<size_t>((p + 1) % NBUF) * hsize;
    for (int j = j0; j < j1; ++j) {
      if (!(one && p == 0)) {  // (pass 0's one tile is ranked already)
        load_tile<ITEMS>(a, j, p, !to_out, key, row);
        tcount = rank_tile<ITEMS>(sp, p, j, n, key, digit, rnk, s_wcnt);
      }
      unsigned inc = tcount;  // the exclusive scan of the tile's counts
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_up_sync(FULL, inc, o);
        if (lane >= o) inc += v;
      }
      if (lane == 31) s_wsum[warp] = inc;
      __syncthreads();
      unsigned tst = inc - tcount;
      for (int w = 0; w < warp; ++w) tst += s_wsum[w];
      s_tstart[t] = tst;
      __syncthreads();
      const int seg = j * TILE + warp * 32 * ITEMS;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i)
        if (seg + i * 32 + lane < n) {
          const unsigned place = s_tstart[digit[i]] + s_wcnt[warp][digit[i]] + rnk[i];
          s_key[place] = key[i];
          s_row[place] = row[i];
          s_dig[place] = static_cast<uint8_t>(digit[i]);
        }
      __syncthreads();
      const int tile_n = min(TILE, n - j * TILE);
#pragma unroll
      for (int m = 0; m < ITEMS; ++m) {
        const int place = m * SORT_THREADS + t;
        if (place >= tile_n) continue;
        const int d = s_dig[place];
        const long long k = s_key[place];
        const int r = s_row[place];
        const unsigned pos = s_base[d] + place - s_tstart[d];
        if (to_out) {
          a.keys[pos] = k;
          a.order[pos] = r;
        } else {
          a.tmp_keys[pos] = k;
          a.tmp_rows[pos] = r;
        }
        if (!last)
          atomicAdd(Hn + static_cast<size_t>(pos / span) * DIGITS + digit_of(k, sp, p + 1), 1u);
      }
      __syncthreads();  // the staged tile and s_base read before they change
      s_base[t] += tcount;  // the next tile's digits follow this one's
    }
    PHASE_STAMP_IT(p, 3);
    if (!last) grid.sync();  // pass p's elements and pass p + 1's histogram complete
    PHASE_STAMP_IT(p, 4);
  }

  // the last block to finish sets the scratch back to 0
  __syncthreads();
  if (t == 0) {
    __threadfence();
    s_last = atomicAdd(a.ws + W_DONE, 1u) == static_cast<unsigned>(G - 1);
  }
  __syncthreads();
  if (s_last) {
    __threadfence();
    if (sp.passes > 0) {
      unsigned* H = hist + static_cast<size_t>((sp.passes - 1) % NBUF) * hsize;
      for (size_t k = t; k < hsize; k += SORT_THREADS) H[k] = 0;
    }
    if (t < HEAD) a.ws[t] = 0;
  }
}

constexpr int ITEMS = 4;  // rows a thread in a tile
constexpr int TILE = SORT_THREADS * ITEMS;
constexpr int MAX_DEV = 64;
int g_resident[MAX_DEV];

}  // namespace

PHASE_STAMPS_EXPORT(voxel_keys)

// C interface for ctypes. pts (n, c) f32 with c >= 3, valid (n,) u8, scale
// () f32 (the leaf when divide != 0, else its reciprocal), out (n,) int64;
// all contiguous on the device. n = 0 launches nothing. Writes the grid's
// block count to *grid_out. Returns the launch's cudaError_t (0 =
// cudaSuccess).
extern "C" int voxel_keys_launch(const void* pts, const void* valid, const void* scale,
                                 int divide, void* out, int n, int c, int* grid_out,
                                 void* stream) {
  *grid_out = 0;
  if (n < 0 || c < 3) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int grid = (n + THREADS - 1) / THREADS;
  *grid_out = grid;
  voxel_keys_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(scale), divide, static_cast<long long*>(out), n, c);
  return static_cast<int>(cudaGetLastError());
}

// The scratch (32-bit words) a sort of n rows takes: the header and three
// histograms of one row of 256 words a block, at most a block a tile of
// 1024 rows; -1 for an n the launch does not take.
extern "C" int voxel_sort_scratch_ints(int n) {
  if (n < 0) return -1;
  const long long blocks = ((long long)n + TILE - 1) / TILE;
  const long long k = HEAD + NBUF * blocks * DIGITS;
  return k < (1LL << 31) ? static_cast<int>(k) : -1;
}

// C interface for ctypes: the keys as voxel_keys_launch, then their stable
// sort, in one cooperative launch. keys and order (n,) int64 (out), tmp_keys
// (n,) int64 and tmp_rows (n,) int32 (the passes' other buffer), ws
// voxel_sort_scratch_ints(n) int32 zeros (left at 0); all contiguous on the
// device. A block takes consecutive tiles of 1024 rows: one while the
// tiles fit on the card at once (its rows then stay in registers from pass
// to pass), else as many as spread them over the blocks it holds. n = 0
// launches nothing. Writes the grid's block count to *grid_out and the
// tiles a block to *tiles_out. Returns the launch's cudaError_t (0 =
// cudaSuccess).
extern "C" int voxel_sort_launch(const void* pts, const void* valid, const void* scale,
                                 int divide, void* keys, void* order, void* tmp_keys,
                                 void* tmp_rows, void* ws, int n, int c, int* grid_out,
                                 int* tiles_out, void* stream) {
  *grid_out = 0;
  *tiles_out = 0;
  if (n < 0 || c < 3 || voxel_sort_scratch_ints(n) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= MAX_DEV) return static_cast<int>(cudaErrorInvalidDevice);
  const void* kernel = reinterpret_cast<const void*>(voxel_sort_kernel<ITEMS>);
  if (g_resident[dev] == 0) {
    int sms = 0, coop = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, SORT_THREADS, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    g_resident[dev] = per_sm * sms;
  }
  const long long ntiles = ((long long)n + TILE - 1) / TILE;
  const long long tiles = (ntiles + g_resident[dev] - 1) / g_resident[dev];
  const long long grid = (ntiles + tiles - 1) / tiles;
  Sort a;
  a.pts = static_cast<const float*>(pts);
  a.valid = static_cast<const uint8_t*>(valid);
  a.scale = static_cast<const float*>(scale);
  a.keys = static_cast<long long*>(keys);
  a.order = static_cast<long long*>(order);
  a.tmp_keys = static_cast<long long*>(tmp_keys);
  a.tmp_rows = static_cast<int*>(tmp_rows);
  a.ws = static_cast<unsigned*>(ws);
  a.divide = divide;
  a.n = n;
  a.c = c;
  a.tiles = static_cast<int>(tiles);
  void* args[] = {&a};
  *grid_out = static_cast<int>(grid);
  *tiles_out = a.tiles;
  e = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(grid)), dim3(SORT_THREADS),
                                  args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
