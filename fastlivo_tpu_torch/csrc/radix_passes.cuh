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
//
// A pass (one grid barrier after it, none after the last): each block
// ranks its tiles and publishes its count of each digit, as count + 1, in
// its row of the pass's histogram (G x 256 words; two buffers, pass p's
// the (p % 2)-th); with one tile it then puts the tile in its sorted order
// in shared memory (each digit's rows from the digit's first place in the
// tile) while the other blocks' counts land; a thread a digit then reads
// the digit's column, 32 words in flight, and reads again those still 0
// (their blocks have not published yet), all together, so the counts need
// no barrier of their own and no atomic. A digit's first position in the
// block is the exclusive scan over digits of the column sums plus the
// same digit's count in the blocks before, and moves on by each tile's
// count; the staged tile is written out a thread a place, so that a warp
// writes runs of consecutive positions. Where pass 0's digit is a function
// of the key alone (`counted`: the insert's low rank byte is its key's
// cell byte), the caller ranks its tiles by it and publishes the count in
// its first phase, before its first barrier; the voxel filter's low rank
// byte depends on the global minimum, so its pass 0 ranks after that
// barrier. A block zeroes its row of the buffer read one pass back (after
// the barrier that ends that pass, before the next that writes it) and
// the last block to finish zeroes the last pass's buffer and the header,
// so the scratch the wrapper zeroed once is back at 0 for the stream's
// next launch. The passes alternate between (tmp_keys, tmp_rows) and the
// outputs, the last pass writing keys and order (int64); no pass (every
// rank equal) writes the identity. Scratch written in the launch is read
// through L2 (__ldcg, volatile where it is waited on); integer arithmetic
// only: every launch gives the same bits.
//
// The form before this one counted pass 0 in a round of its own with a
// grid barrier after it, and built pass p + 1's histogram during pass p's
// writes with one L2 atomicAdd a row into the block each row landed in.
// On an H100, in turns, this form took 0.0188 ms against that form's
// 0.0215 on a 2-pass scan of the LIO path's shape, and 0.0177 against
// 0.0192 on the tiled insert's LIO batch; these passes with that
// histogram by atomics (pass 0's still published) took 0.0201 and 0.0184,
// with the atomics aggregated a warp by __match_any_sync 0.0199 and
// 0.0187; a first form of 11-bit digits (two passes where 8-bit ones take
// three, none fewer on the paths' 9-16-bit ranks) took 0.055-0.057 on
// every batch, its column read (a thread's eight digits, four blocks' rows
// a round) eight round trips where this form's is one
// (scripts/torch_vio_kernels_bench.py; PERF.md). Built with
// -DPHASE_STAMPS (csrc/phase_stamps.cuh) it stamps each pass's work before
// its column read, the column read and offsets, the scatter and the
// barrier.
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
constexpr int NBUF = 2;  // histogram buffers, pass p's the (p % NBUF)-th
constexpr int MAX_GRID = 1024;  // blocks a launch at most (the scratch's rows)
// reads of a histogram word still unpublished before the launch traps
// instead of hanging (2^24 L2 round trips: seconds; a block publishes
// within microseconds)
constexpr unsigned SPIN_LIMIT = 1u << 24;

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

// A tile's ranking by the digits dig(key) (a pass's: digit_of): each
// warp's items in order among its equal digits (rnk), then thread t turns
// the warps' counts of digit t into their offsets in wcnt and returns the
// tile's count of digit t.
template <int ITEMS, class K, class Dig>
__device__ __forceinline__ unsigned rank_tile(const Dig& dig, int tile, int n,
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
    digit[i] = in ? dig(key[i]) : 0;
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

// This block's count of digit t over its tiles in pass p, published in its
// row of the pass's histogram as count + 1 (0 stays "not yet"): pass 0's
// by the caller's first phase where the digit is the key's own, else by
// sort_passes. Thread t stores word t.
template <class K>
__device__ __forceinline__ void publish_count(const Buffers<K>& a, int p, unsigned count) {
  const size_t G = gridDim.x;
  unsigned* h = a.ws + a.head + static_cast<size_t>(p % NBUF) * G * DIGITS
                + static_cast<size_t>(blockIdx.x) * DIGITS + threadIdx.x;
  *reinterpret_cast<volatile unsigned*>(h) = count + 1u;
}

// A ranked tile put in its sorted order in shared memory: s.tstart the
// exclusive scan of the tile's counts (each digit's first place in the
// tile), each row at its digit's first place plus the warps' before it
// and its rank in its warp (s.key, s.row, s.dig).
template <int ITEMS, class K>
__device__ __forceinline__ void stage_tile(int tile, int n, const K key[ITEMS],
                                           const int row[ITEMS], const int digit[ITEMS],
                                           const unsigned rnk[ITEMS], unsigned tcount,
                                           Shared<K, ITEMS>& s) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned inc = tcount;
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
    if (position<ITEMS>(tile, i) < n) {
      const unsigned place = s.tstart[digit[i]] + s.wcnt[warp][digit[i]] + rnk[i];
      s.key[place] = key[i];
      s.row[place] = row[i];
      s.dig[place] = static_cast<uint8_t>(digit[i]);
    }
  __syncthreads();
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
// 0, else the passes; then the last block sets the scratch back to 0.
// `one`: the block has one tile, whose keys and rows are in key / row
// already (loaded by the caller's first phase). `counted`: the caller
// ranked its tiles by pass 0's digit and published the count before its
// first barrier (with `one`, the tile's digit, rnk, tcount and s.wcnt
// are that ranking's).
template <int ITEMS, class K, class Src, class Rank>
__device__ __forceinline__ void sort_passes(cg::grid_group& grid, const Src& src,
                                            const Rank& rank, int passes, const Buffers<K>& a,
                                            Shared<K, ITEMS>& s, K key[ITEMS], int row[ITEMS],
                                            int digit[ITEMS], unsigned rnk[ITEMS],
                                            unsigned tcount, bool counted, bool one) {
  constexpr int TILE = THREADS * ITEMS;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, b = blockIdx.x, G = gridDim.x;
  const int n = a.n;
  const int ntiles = (n + TILE - 1) / TILE;
  const int j0 = b * a.tiles, j1 = min(j0 + a.tiles, ntiles);  // this block's tiles
  unsigned* hist = a.ws + a.head;
  const size_t hsize = static_cast<size_t>(G) * DIGITS;
  unsigned* own = hist + static_cast<size_t>(b) * DIGITS + t;  // word t of this block's row

  if (passes == 0) {  // every rank equal: the identity
    if (counted) *own = 0;  // pass 0's count, published for nothing
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
  for (int p = 0; p < passes; ++p) {
    PHASE_STAMP_IT(p, 1);
    const bool last = p == passes - 1;
    const bool to_out = ((passes - 1 - p) & 1) == 0;  // the last pass writes the outputs
    const auto dig = [&](K k) { return digit_of(k, rank, p); };
    // this block's tiles ranked and its count published (pass 0's where
    // counted: already), then its row of the buffer read one pass back
    // zeroed for the pass after this one
    if (p > 0 || !counted) {
      unsigned count = 0;
      for (int j = j0; j < j1; ++j) {
        if (!(one && p == 0)) load_tile<ITEMS>(src, a, j, p, !to_out, key, row);
        tcount = rank_tile<ITEMS>(dig, j, n, key, digit, rnk, s.wcnt);
        count += tcount;
      }
      publish_count(a, p, count);
    }
    if (p > 0) own[static_cast<size_t>((p + 1) % NBUF) * hsize] = 0;
    // one tile: staged while the other blocks' counts land
    if (one) stage_tile<ITEMS>(j0, n, key, row, digit, rnk, tcount, s);
    PHASE_STAMP_IT(p, 2);
    // the digit's count in the blocks before this one, and in all: the
    // column's words loaded 32 at a time (the last group's predicated),
    // all in flight together; words still 0 (their blocks have not
    // published) loaded again, all together, until none is; then less the
    // 1 that marks a word published
    const unsigned* col = hist + static_cast<size_t>(p % NBUF) * hsize + t;
    unsigned before = 0, total = 0;
    for (int k = 0; k < G; k += 32) {
      unsigned v[32];
#pragma unroll
      for (int u = 0; u < 32; ++u)
        v[u] = k + u < G ? __ldcg(col + static_cast<size_t>(k + u) * DIGITS) : 1u;
      for (unsigned polls = 0;; ++polls) {
        bool pending = false;
#pragma unroll
        for (int u = 0; u < 32; ++u) pending |= v[u] == 0u;
        if (!pending) break;
        if (polls == SPIN_LIMIT) __trap();  // a block that never publishes: a fault
#pragma unroll
        for (int u = 0; u < 32; ++u)
          if (v[u] == 0u)
            v[u] = *reinterpret_cast<const volatile unsigned*>(
                col + static_cast<size_t>(k + u) * DIGITS);
      }
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        total += v[u] - 1u;
        before += k + u < b ? v[u] - 1u : 0u;
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
    __syncthreads();
    unsigned off = incl - total + before;
    for (int w = 0; w < warp; ++w) off += s.wsum[w];
    s.base[t] = off;
    __syncthreads();
    PHASE_STAMP_IT(p, 3);
    // each tile in order (with one tile: ranked and staged above): its
    // ranking and staging, then its rows written out a thread a place, so
    // that a warp's writes are contiguous runs
    for (int j = j0; j < j1; ++j) {
      if (!one) {
        load_tile<ITEMS>(src, a, j, p, !to_out, key, row);
        tcount = rank_tile<ITEMS>(dig, j, n, key, digit, rnk, s.wcnt);
        stage_tile<ITEMS>(j, n, key, row, digit, rnk, tcount, s);
      }
      const int tile_n = min(TILE, n - j * TILE);
#pragma unroll
      for (int m = 0; m < ITEMS; ++m) {
        const int place = m * THREADS + t;
        if (place >= tile_n) continue;
        const int d = s.dig[place];
        const unsigned pos = s.base[d] + place - s.tstart[d];
        if (to_out) {
          a.keys[pos] = s.key[place];
          a.order[pos] = s.row[place];
        } else {
          a.tmp_keys[pos] = s.key[place];
          a.tmp_rows[pos] = s.row[place];
        }
      }
      __syncthreads();  // the staged tile and s.base read before they change
      s.base[t] += tcount;  // the next tile's digits follow this one's
    }
    PHASE_STAMP_IT(p, 4);
    if (!last) grid.sync();  // pass p's elements complete
    PHASE_STAMP_IT(p, 5);
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
