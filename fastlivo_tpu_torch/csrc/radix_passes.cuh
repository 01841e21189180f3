// Stable LSD radix passes over a compact rank, inside one cooperative
// launch: the machinery that csrc/voxel_keys.cu (`voxel_sort`, the voxel
// filter's packed 64-bit keys) and csrc/tiled_insert.cu (`tiled_insert_sort`,
// the tiled insert's 32-bit keys) share. Each sort supplies its key type K,
// a source of pass 0's keys (`src.key(pos)`, computed from the kernel's
// inputs) and a rank functor (`rank(key)`, an unsigned 64-bit rank that
// orders and ties the keys as they order themselves), and reduces its own
// extremes into the scratch header before its first grid barrier; the
// header turns them into each field's base and range and the pass count.
//
// The rows are cut into tiles of THREADS * ITEMS positions; a block takes
// consecutive tiles (one while the tiles fit on the card at once: its rows
// then stay in registers from phase to phase; more past that, each
// computed or loaded again where it is used). Stable passes of 8 bits over
// (key, row), the rank recomputed from the key each pass: a warp holds 32 *
// ITEMS positions of a tile, item i of lane l at position i * 32 + l
// (coalesced loads), and ranks its items in order by ballots on the
// digit's bits and a counter per warp and digit in shared memory; a thread
// a digit turns the counters into the warps' offsets and the tile's count.
// A digit's first position in a block is the exclusive scan over digits of
// every block's counts plus the same digit's count in the blocks before,
// read from the pass's histogram (G x 256 words, up to 32 words in flight
// a thread), and moves on by each tile's count. A tile is put in its sorted
// order in shared memory first (each digit's rows from the digit's first
// place in the tile), then written out a thread a place, so that a warp
// writes runs of consecutive positions. Pass 0's histogram is each block's
// own count, stored and shared by a grid barrier; pass p + 1's is
// accumulated during pass p's writes: each row adds one (an integer atomic)
// to the count of its next digit in the block its new position falls in,
// so the grid barrier that ends pass p also completes pass p + 1's
// histogram (one barrier a pass, passes + 1 in all with the caller's
// first). The histograms rotate through three buffers; a block zeroes its
// row of the buffer read two passes back, and the last block to finish
// zeroes the last pass's buffer and the header, so the scratch the wrapper
// zeroed once is back at 0 for the stream's next launch. The passes
// alternate between (tmp_keys, tmp_rows) and the outputs, the last pass
// writing keys and order (int64); no pass (every rank equal) writes the
// identity. Scratch written in the launch is read through L2 (__ldcg);
// integer atomics only: every launch gives the same bits.
//
// One copy serves both sorts: the voxel filter's sort measured no slower
// on it than on its own copy (0.0280 -> 0.0270 ms at 32768 rows on an H100,
// scripts/torch_vio_kernels_bench.py; PERF.md), with the same 128
// registers and no spill. Built with -DPHASE_STAMPS (csrc/phase_stamps.cuh)
// it stamps pass 0's count and its barrier, and each pass's offsets,
// ranking and scatter, and barrier.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "phase_stamps.cuh"

namespace radix {

namespace cg = cooperative_groups;

constexpr int THREADS = 256;  // one digit each in the offset phase
constexpr int WARPS = THREADS / 32;
constexpr int DIGIT_BITS = 8;
constexpr int DIGITS = 1 << DIGIT_BITS;
static_assert(DIGITS == THREADS, "a thread a digit");
constexpr unsigned FULL = 0xffffffffu;
// scratch header (32-bit words): each field's max + 1, each field's OFF -
// min (0 is "no row"), has-invalid, the count of finished blocks, then
// whatever else a sort keeps there (Buffers::head words in all, at least
// HEAD); the histograms follow
constexpr int W_HI = 0, W_LO = 3, W_INV = 6, W_DONE = 7, HEAD = 16;
constexpr int NBUF = 3;  // rotating histogram buffers
constexpr int MAX_GRID = 1024;  // blocks a launch at most (the scratch's rows)

// The sort's outputs, buffers and shape.
template <class K>
struct Buffers {
  K* keys;             // (n,) out: the keys in sorted order
  long long* order;    // (n,) out: the stable sort's permutation
  K* tmp_keys;         // (n,) the passes' other buffer
  int* tmp_rows;       // (n,)
  unsigned* ws;        // scratch: head + NBUF G DIGITS words, zeros, left at 0
  int head;            // the header's words (>= HEAD)
  int n;
  int tiles;           // tiles a block (the last block may have fewer)
};

template <class K, int ITEMS>
struct Shared {
  unsigned wcnt[WARPS][DIGITS];  // a warp's count, then offset, of each digit
  unsigned base[DIGITS];         // each digit's next position in this block
  unsigned tstart[DIGITS];       // each digit's first place in the tile's order
  K key[THREADS * ITEMS];        // the tile in its sorted order
  int row[THREADS * ITEMS];
  uint8_t dig[THREADS * ITEMS];
  unsigned red[W_DONE];          // the block's extremes and invalid flag
  unsigned wsum[WARPS];
  int last;
};

// The position of item i of this thread in tile `tile`.
template <int ITEMS>
__device__ __forceinline__ int position(int tile, int i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return tile * THREADS * ITEMS + warp * 32 * ITEMS + i * 32 + lane;
}

// A tile's elements: pass 0 computes the keys of its rows (src.key), a
// later pass reads (key, row) where the pass before left them (the outputs
// when `from_out`, else the other buffer). Positions past n: row = the
// position, the key untouched.
template <int ITEMS, class K, class Src>
__device__ __forceinline__ void load_tile(const Src& src, const Buffers<K>& a, int tile, int p,
                                          bool from_out, K key[ITEMS], int row[ITEMS]) {
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int pos = position<ITEMS>(tile, i);
    row[i] = pos;
    if (pos < a.n) {
      if (p == 0) {
        key[i] = src.key(pos);
      } else {
        key[i] = from_out ? __ldcg(a.keys + pos) : __ldcg(a.tmp_keys + pos);
        row[i] = from_out ? static_cast<int>(__ldcg(a.order + pos)) : __ldcg(a.tmp_rows + pos);
      }
    }
  }
}

template <class K, class Rank>
__device__ __forceinline__ int digit_of(K key, const Rank& rank, int p) {
  return static_cast<int>((rank(key) >> (DIGIT_BITS * p)) & (DIGITS - 1));
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

// A tile's ranking in pass p: each warp's items in order among its equal
// digits (rnk), then thread t turns the warps' counts of digit t into their
// offsets in wcnt and returns the tile's count of digit t.
template <int ITEMS, class K, class Rank>
__device__ __forceinline__ unsigned rank_tile(const Rank& rank, int p, int tile, int n,
                                              const K key[ITEMS], int digit[ITEMS],
                                              unsigned rnk[ITEMS],
                                              unsigned (*wcnt)[DIGITS]) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int k = lane; k < DIGITS; k += 32) wcnt[warp][k] = 0;
  __syncwarp();
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const bool in = position<ITEMS>(tile, i) < n;
    digit[i] = in ? digit_of(key[i], rank, p) : 0;
    const unsigned peers = same_digit(digit[i], __ballot_sync(FULL, in));
    unsigned before = 0;
    if (in) {
      before = wcnt[warp][digit[i]];
      rnk[i] = before + __popc(peers & lt);
    }
    __syncwarp();
    if (in && lane == __ffs(peers) - 1) wcnt[warp][digit[i]] = before + __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  unsigned count = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const unsigned c = wcnt[w][t];
    wcnt[w][t] = count;
    count += c;
  }
  __syncthreads();
  return count;
}

// The block's three fields' maxima of f + 1 and of OFF - f and its
// invalid flag (each thread's, 0 for none) into the scratch header by
// integer atomics. s.red must be zeroed before the block's first use.
template <class K, int ITEMS>
__device__ __forceinline__ void reduce_extremes(unsigned hi[3], unsigned lo[3], unsigned inv,
                                                Shared<K, ITEMS>& s, unsigned* ws) {
  const int t = threadIdx.x, lane = t & 31;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    hi[q] = __reduce_max_sync(FULL, hi[q]);
    lo[q] = __reduce_max_sync(FULL, lo[q]);
  }
  inv = __reduce_max_sync(FULL, inv);
  if (lane == 0) {
    for (int q = 0; q < 3; ++q) {
      atomicMax(&s.red[W_HI + q], hi[q]);
      atomicMax(&s.red[W_LO + q], lo[q]);
    }
    atomicMax(&s.red[W_INV], inv);
  }
  __syncthreads();
  if (t < W_DONE && s.red[t]) atomicMax(ws + t, s.red[t]);
}

// Each field's base and range over the valid rows, read from the header
// after the first grid barrier (the same in every thread); any = 0 where
// no row is valid.
struct Extent {
  long long lo[3];
  unsigned long long r[3];
  bool any, inv;
};

__device__ __forceinline__ Extent extent_of(const unsigned* ws, long long off) {
  unsigned w[W_DONE];
#pragma unroll
  for (int k = 0; k < W_DONE; ++k) w[k] = __ldcg(ws + k);
  Extent e;
  e.any = w[W_HI] != 0;
  e.inv = w[W_INV] != 0;
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    e.lo[q] = e.any ? off - static_cast<long long>(w[W_LO + q]) : 0;
    e.r[q] = e.any ? static_cast<unsigned long long>(static_cast<long long>(w[W_HI + q]) - e.lo[q])
                   : 0;
  }
  return e;
}

// The passes that ranks up to rmax take: ceil(bits(rmax) / 8), 0 for
// rmax = 0.
__device__ __forceinline__ int passes_for(unsigned long long rmax) {
  return rmax ? (64 - __clzll(static_cast<long long>(rmax)) + DIGIT_BITS - 1) / DIGIT_BITS : 0;
}

// Everything after the first grid barrier: the identity where `passes` is
// 0, else pass 0's count, its barrier and the passes; then the last block
// sets the scratch back to 0. `one`: the block has one tile, whose keys
// and rows are in key / row already (loaded by the caller's first phase).
template <int ITEMS, class K, class Src, class Rank>
__device__ __forceinline__ void sort_passes(cg::grid_group& grid, const Src& src,
                                            const Rank& rank, int passes, const Buffers<K>& a,
                                            Shared<K, ITEMS>& s, K key[ITEMS], int row[ITEMS],
                                            bool one) {
  constexpr int TILE = THREADS * ITEMS;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, b = blockIdx.x, G = gridDim.x;
  const int n = a.n;
  const int ntiles = (n + TILE - 1) / TILE;
  const int j0 = b * a.tiles, j1 = min(j0 + a.tiles, ntiles);  // this block's tiles
  const unsigned span = static_cast<unsigned>(a.tiles) * TILE;  // positions a block
  unsigned* hist = a.ws + a.head;
  const size_t hsize = static_cast<size_t>(G) * DIGITS;
  int digit[ITEMS];
  unsigned rnk[ITEMS];

  if (passes == 0) {  // every rank equal: the identity
    for (int j = j0; j < j1; ++j) {
      if (!one) load_tile<ITEMS>(src, a, j, 0, false, key, row);
#pragma unroll
      for (int i = 0; i < ITEMS; ++i)
        if (row[i] < n) {
          a.keys[row[i]] = key[i];
          a.order[row[i]] = row[i];
        }
    }
  }
  unsigned tcount = 0;  // the current tile's count of digit t
  if (passes > 0) {  // pass 0's count of each digit in this block's tiles, for all blocks
    unsigned count = 0;
    for (int j = j0; j < j1; ++j) {
      if (!one) load_tile<ITEMS>(src, a, j, 0, false, key, row);
      tcount = rank_tile<ITEMS>(rank, 0, j, n, key, digit, rnk, s.wcnt);
      count += tcount;
    }
    hist[static_cast<size_t>(b) * DIGITS + t] = count;
    PHASE_STAMP_IT(0, 0);
    grid.sync();  // every block's pass-0 count
  }
  for (int p = 0; p < passes; ++p) {
    PHASE_STAMP_IT(p, 1);
    const bool last = p == passes - 1;
    const bool to_out = ((passes - 1 - p) & 1) == 0;  // the last pass writes the outputs
    // the digit's count in the blocks before this one, and in all: the
    // column's words loaded 32 at a time (the last group's predicated),
    // all in flight together
    const unsigned* H = hist + static_cast<size_t>(p % NBUF) * hsize;
    unsigned before = 0, total = 0;
    {
      const unsigned* col = H + t;
      for (int k = 0; k < G; k += 32) {
        unsigned v[32];
#pragma unroll
        for (int u = 0; u < 32; ++u)
          v[u] = k + u < G ? __ldcg(col + static_cast<size_t>(k + u) * DIGITS) : 0u;
#pragma unroll
        for (int u = 0; u < 32; ++u) {
          total += v[u];
          before += k + u < b ? v[u] : 0u;
        }
      }
    }
    // exclusive scan of the totals over the digits
    unsigned incl = total;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) s.wsum[warp] = incl;
    // this block's row of the histogram read two passes back, for pass p + 2
    if (p > 0)
      hist[static_cast<size_t>((p + 2) % NBUF) * hsize + static_cast<size_t>(b) * DIGITS + t] = 0;
    __syncthreads();
    unsigned off = incl - total + before;
    for (int w = 0; w < warp; ++w) off += s.wsum[w];
    s.base[t] = off;
    __syncthreads();
    PHASE_STAMP_IT(p, 2);
    // each tile in order: its ranking; the tile put in its sorted order in
    // shared memory (each digit's rows from its first place there), then
    // written out a thread a place, so that a warp's writes are contiguous
    // runs; the next pass's histogram by the blocks the rows land in
    unsigned* Hn = hist + static_cast<size_t>((p + 1) % NBUF) * hsize;
    for (int j = j0; j < j1; ++j) {
      if (!(one && p == 0)) {  // (pass 0's one tile is ranked already)
        load_tile<ITEMS>(src, a, j, p, !to_out, key, row);
        tcount = rank_tile<ITEMS>(rank, p, j, n, key, digit, rnk, s.wcnt);
      }
      unsigned inc = tcount;  // the exclusive scan of the tile's counts
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_up_sync(FULL, inc, o);
        if (lane >= o) inc += v;
      }
      if (lane == 31) s.wsum[warp] = inc;
      __syncthreads();
      unsigned tst = inc - tcount;
      for (int w = 0; w < warp; ++w) tst += s.wsum[w];
      s.tstart[t] = tst;
      __syncthreads();
#pragma unroll
      for (int i = 0; i < ITEMS; ++i)
        if (position<ITEMS>(j, i) < n) {
          const unsigned place = s.tstart[digit[i]] + s.wcnt[warp][digit[i]] + rnk[i];
          s.key[place] = key[i];
          s.row[place] = row[i];
          s.dig[place] = static_cast<uint8_t>(digit[i]);
        }
      __syncthreads();
      const int tile_n = min(TILE, n - j * TILE);
#pragma unroll
      for (int m = 0; m < ITEMS; ++m) {
        const int place = m * THREADS + t;
        if (place >= tile_n) continue;
        const int d = s.dig[place];
        const K k = s.key[place];
        const int r = s.row[place];
        const unsigned pos = s.base[d] + place - s.tstart[d];
        if (to_out) {
          a.keys[pos] = k;
          a.order[pos] = r;
        } else {
          a.tmp_keys[pos] = k;
          a.tmp_rows[pos] = r;
        }
        if (!last)
          atomicAdd(Hn + static_cast<size_t>(pos / span) * DIGITS + digit_of(k, rank, p + 1), 1u);
      }
      __syncthreads();  // the staged tile and s.base read before they change
      s.base[t] += tcount;  // the next tile's digits follow this one's
    }
    PHASE_STAMP_IT(p, 3);
    if (!last) grid.sync();  // pass p's elements and pass p + 1's histogram complete
    PHASE_STAMP_IT(p, 4);
  }

  // the last block to finish sets the scratch back to 0
  __syncthreads();
  if (t == 0) {
    __threadfence();
    s.last = atomicAdd(a.ws + W_DONE, 1u) == static_cast<unsigned>(G - 1);
  }
  __syncthreads();
  if (s.last) {
    __threadfence();
    if (passes > 0) {
      unsigned* H = hist + static_cast<size_t>((passes - 1) % NBUF) * hsize;
      for (size_t k = t; k < hsize; k += THREADS) H[k] = 0;
    }
    for (int k = t; k < a.head; k += THREADS) a.ws[k] = 0;
  }
}

// Host side: the scratch (32-bit words) a sort of n rows takes with tiles
// of `tile` rows and a header of `head` words, at most MAX_GRID blocks; -1
// for an n the launch does not take.
inline int scratch_ints(long long n, int tile, int head) {
  if (n < 0) return -1;
  long long blocks = (n + tile - 1) / tile;
  blocks = blocks < MAX_GRID ? blocks : MAX_GRID;
  const long long k = head + NBUF * blocks * DIGITS;
  return k < (1LL << 31) ? static_cast<int>(k) : -1;
}

// Host side: the blocks a launch resident on the card at once takes for n
// rows in tiles of `tile`, and the tiles a block: one while the tiles fit
// (resident blocks, at most MAX_GRID), else as many as spread them over
// those blocks.
inline void plan(long long n, int tile, int resident, int* grid, int* tiles) {
  resident = resident < MAX_GRID ? resident : MAX_GRID;
  const long long ntiles = (n + tile - 1) / tile;
  const long long per = (ntiles + resident - 1) / resident;
  *tiles = static_cast<int>(per);
  *grid = static_cast<int>((ntiles + per - 1) / per);
}

// Host side: the blocks of `kernel` (THREADS threads, no dynamic shared
// memory) resident on the current device at once, queried once a device
// into `cache` (MAX_DEV entries, 0 until queried). Returns a cudaError_t.
constexpr int MAX_DEV = 64;
inline cudaError_t resident_blocks(const void* kernel, int* cache, int* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= MAX_DEV) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int sms = 0, coop = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    cache[dev] = per_sm * sms;
  }
  *out = cache[dev];
  return cudaSuccess;
}

}  // namespace radix
