// The scan voxel filter's segmented centroid after its sort, for Hopper.
//
// Replaces no TPU kernel: it is the port of the jitted XLA code of
// fastlivo_tpu/ops/voxel_filter.py::voxel_downsample_device after its
// argsort (:51-70: segment heads, a cumsum of heads, a scatter-add of the
// rows and of their count into max_out rows, the division, the mask),
// whose torch version ops/voxel_filter.py::voxel_centroids_plain is a
// gather, a cumsum, an index_add_ of the lengths and torch.segment_reduce.
// Input: the packed voxel keys (N,) int64 in sorted order (torch.sort's
// values; the invalid marker 2^62 where the row is invalid or not finite:
// every valid key is below 2^60, so the invalid rows sort last and a row
// is valid iff its key is not the marker), the stable sort's `order`
// (N,) int64 and the rows pts (N, C) f32 in their original order. Row r
// of the sorted order is a segment head when it is valid and its key
// differs from row r - 1's; segment g is the g-th head's run of equal
// keys. Output row g < max_out: the run's rows summed column by column in
// row order starting from +0.0f (as segment_reduce(..., initial=0.0) sums
// on the CPU, so a -0.0 coordinate sums to +0.0 and a NaN propagates),
// divided by the run's length with IEEE f32 division (no
// --use_fast_math), mask true; rows past the segments: zeros, mask false.
// Segments past max_out and the invalid rows are dropped. The sums then
// carry the CPU's bits.
//
// Bound on an H100: the work reads each row's key and order entry (16 B)
// and each valid row's C floats once, and writes max_out rows of C floats
// and a mask byte; a few operations a row. Bytes bind it (~0.3 us at the
// LIO scan's 32768 rows into 16384), far below a launch, so the kernel is
// held by its latencies: the dependent loads (the key and order, then the
// gathered row) and the longest run's chain of f32 adds, which row order
// forces to be serial (4 cycles an add). chip_smoke.py counts the bound
// from its inputs.
//
// Design: one ordinary launch, no grid barrier and no device query. The
// sorted rows are cut into tiles of TILE rows (1024 for C <= 9; fewer for
// wide rows, so that a tile's rows fit in shared memory); blocks take
// tiles in launch order from an int ticket. A tile's block reads its keys
// contiguously (no gather), finds its heads (one compare with the row
// before), counts them with a block scan and publishes the count in the
// tile's status word. The block gathers its valid rows through `order`
// (every load in flight at once) into shared memory, and warp 0 the 32
// rows after the tile that continue its last run. Then warp 0 finds the
// tile's first segment number by decoupled look-back over the earlier
// tiles' words (an aggregate or an inclusive prefix in each, 32 words a
// step; lookback.cuh) and publishes its inclusive prefix; tiles are
// handed out in launch order, so a look-back only waits on a tile that is
// already running.
// Meanwhile warps 1-7 sum the runs: a thread per run (per group of up to 4
// columns where C > 4), its columns' chains side by side in registers,
// each adding the staged rows in row order from +0.0. Not a warp or a
// quarter-warp per run: the runs are short (~10-14 rows on average in a
// LIO scan, ~2 in the camera cloud, the longest a few tens), the block
// has already loaded every row, and a thread per run keeps one chain of
// adds per column, as row order needs, with no lane idle in a shuffle.
// The sums do not wait for the prefix; only the write of row g = prefix +
// local rank does (g < max_out). A last run that goes on past the 32
// staged rows is continued by the whole block in spans of TILE + 32 rows
// (keys compared to find its end, the rows gathered, then one thread a
// column carrying the same accumulator on). The rows after the segments:
// the launch holds ceil(max_out / 1024) more blocks whose tickets follow
// every tile's; each learns the number of segments by looking back over
// all tiles (their counts are published before their sums) and zeroes its
// share of rows nseg .. max_out - 1. The last block to finish (a count of
// finished blocks; each tile fences its status words before it counts
// itself) sets the ticket, the count and the status words back to 0, so
// the scratch the wrapper zeroed once serves every launch on its stream.
// Int atomics only; every launch gives the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

namespace {

using lookback::FLAG_A;
using lookback::FLAG_P;
using lookback::VALUE;
using lookback::store_status;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_TILE = 1024;                 // sorted rows a tile at most
constexpr int RPT_MAX = MAX_TILE / THREADS;    // rows a thread at most
constexpr int EXT = 32;                        // rows staged past the tile's end
constexpr int STAGE_FLOATS = 10240;            // staged row values (40 KB)
constexpr int MAX_C = STAGE_FLOATS / (32 + EXT);
constexpr int FILL_ROWS = 1024;                // output rows a fill block
constexpr int CG = 4;                          // columns a thread sums side by side
constexpr long long INVALID = 1LL << 62;
constexpr unsigned FULL = 0xffffffffu;

// the tile's rows for C columns: the largest power of two <= MAX_TILE (at
// least 32) whose rows and EXT more fit in the staging buffer
int tile_rows(int c) {
  int t = MAX_TILE;
  while (t > 32 && (t + EXT) * c > STAGE_FLOATS) t >>= 1;
  return t;
}

struct Args {
  const long long* keys;   // (n,) sorted
  const long long* order;  // (n,) the stable sort's permutation
  const float* pts;        // (n, c) original order
  float* out;              // (max_out, c)
  uint8_t* mask;           // (max_out,)
  unsigned* scratch;       // [ticket, blocks done, status of each tile], all 0
  int n, c, max_out, tile, ntiles, nfill;
};

// CC: the column count when fixed at compile time (3), else 0 (a.c)
template <int CC>
__global__ void __launch_bounds__(THREADS) voxel_centroids_kernel(Args a) {
  __shared__ float s_pts[STAGE_FLOATS];  // staged rows, C floats each
  __shared__ int s_head[MAX_TILE + 1];   // tile-relative row of head h; [H]: the last run's end
  __shared__ float s_acc[MAX_C];         // the continued last run's sums
  __shared__ int s_warp[2][WARPS];
  __shared__ long long s_lastkey;
  __shared__ int s_ticket, s_excl, s_nseg, s_more, s_cnt, s_end, s_last;

  const int C = CC ? CC : a.c;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  unsigned* ticket = a.scratch;
  unsigned* done = a.scratch + 1;
  unsigned* status = a.scratch + 2;
  if (t == 0) s_ticket = static_cast<int>(atomicAdd(ticket, 1u));
  __syncthreads();
  const int tile = s_ticket;

  if (tile < a.ntiles) {
    const int T_R = a.tile, N = a.n;
    const int r0 = tile * T_R, rows = min(T_R, N - r0);
    const int rpt = T_R >= THREADS ? T_R / THREADS : 1;
    const int q0 = t * rpt;  // this thread's first tile row
    const bool tail = r0 + T_R < N;  // rows follow the tile

    // keys and order entries, contiguous: all loads in flight
    long long k[RPT_MAX], o[RPT_MAX];
#pragma unroll
    for (int i = 0; i < RPT_MAX; ++i) {
      k[i] = INVALID;
      o[i] = 0;
      if (i < rpt && q0 + i < rows) {
        k[i] = a.keys[r0 + q0 + i];
        o[i] = a.order[r0 + q0 + i];
      }
    }
    long long kprev = -1;  // no valid key: row 0 of the scan heads its run
    if (q0 < rows && r0 + q0 > 0) kprev = a.keys[r0 + q0 - 1];
    long long ke = INVALID, oe = 0;  // warp 0: the EXT rows after the tile
    if (warp == 0 && tail && r0 + T_R + lane < N) {
      ke = a.keys[r0 + T_R + lane];
      oe = a.order[r0 + T_R + lane];
    }

    // heads and valid rows; their block scan
    int nh = 0, nv = 0;
    bool head[RPT_MAX];
#pragma unroll
    for (int i = 0; i < RPT_MAX; ++i) {
      const bool valid = k[i] != INVALID;
      head[i] = valid && k[i] != (i ? k[i - 1] : kprev);
      nh += head[i];
      nv += valid;
    }
    int incl = nh;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += y;
    }
    for (int d = 16; d; d >>= 1) nv += __shfl_xor_sync(FULL, nv, d);
    if (lane == 31) s_warp[0][warp] = incl;
    if (lane == 0) s_warp[1][warp] = nv;
    __syncthreads();
    int rank = incl - nh, H = 0, nvalid = 0;
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) rank += s_warp[0][w];
      H += s_warp[0][w];
      nvalid += s_warp[1][w];
    }
    if (t == 0) store_status(status + tile, (tile == 0 ? FLAG_P : FLAG_A) | static_cast<unsigned>(H));
#pragma unroll
    for (int i = 0; i < RPT_MAX; ++i)
      if (head[i]) s_head[rank++] = q0 + i;

    // the valid rows, gathered through order
#pragma unroll
    for (int i = 0; i < RPT_MAX; ++i)
      if (k[i] != INVALID)
        for (int c = 0; c < C; ++c) s_pts[(q0 + i) * C + c] = a.pts[o[i] * C + c];
    // the last run's end: the leading EXT rows that keep the tile's last key
    if (warp == 0) {
      const long long last = tail ? a.keys[r0 + T_R - 1] : INVALID;
      const unsigned m = __ballot_sync(FULL, H > 0 && last != INVALID && ke == last);
      const int n_ext = ~m ? __ffs(~m) - 1 : 32;
      if (lane < n_ext)
        for (int c = 0; c < C; ++c) s_pts[(T_R + lane) * C + c] = a.pts[oe * C + c];
      if (lane == 0) {
        s_head[H] = n_ext ? T_R + n_ext : nvalid;
        s_more = n_ext == EXT && r0 + T_R + EXT < N;
        s_lastkey = last;
      }
    }
    __syncthreads();

    // warp 0 looks back while warps 1-7 sum their first run. An item is a
    // run and a group of up to CG columns (for C <= CG: the run), its
    // columns' add chains side by side in registers
    const int G = (C + CG - 1) / CG, items = H * G;
    float acc[CG];
    auto sum_item = [&](int it) {
      const int h = it / G, c0 = (it - h * G) * CG;
#pragma unroll
      for (int j = 0; j < CG; ++j) acc[j] = 0.0f;
      for (int r = s_head[h]; r < s_head[h + 1]; ++r)
#pragma unroll
        for (int j = 0; j < CG; ++j)
          if (c0 + j < C) acc[j] = acc[j] + s_pts[r * C + c0 + j];
    };
    if (warp == 0) {
      const int excl = tile ? lookback::count_before(status, tile) : 0;
      if (lane == 0) {
        s_excl = excl;
        if (tile) store_status(status + tile, FLAG_P | static_cast<unsigned>(excl + H));
        __threadfence();  // this block's status words before its count of finished blocks
      }
    } else if (t - 32 < items) {
      sum_item(t - 32);
    }
    __syncthreads();
    const int excl = s_excl;
    const bool more = s_more;
    if (warp > 0) {
      for (int it = t - 32; it < items; it += THREADS - 32) {
        const int h = it / G, c0 = (it - h * G) * CG;
        const int g = excl + h;
        if (g >= a.max_out) break;  // h only grows: every later run is dropped
        if (it != t - 32) sum_item(it);
        const int n = s_head[h + 1] - s_head[h];
        if (h == H - 1 && more) {  // continued below
#pragma unroll
          for (int j = 0; j < CG; ++j)
            if (c0 + j < C) s_acc[c0 + j] = acc[j];
          if (c0 == 0) s_cnt = n;
          continue;
        }
#pragma unroll
        for (int j = 0; j < CG; ++j)
          if (c0 + j < C)
            a.out[static_cast<size_t>(g) * C + c0 + j] = acc[j] / static_cast<float>(n);
        if (c0 == 0) a.mask[g] = 1;
      }
    }

    // a last run past the EXT rows: the whole block, a span at a time
    if (more && excl + H - 1 < a.max_out) {
      __syncthreads();  // s_acc, s_cnt; the staged rows read
      const long long key = s_lastkey;
      const int span = T_R + EXT;
      int r = r0 + T_R + EXT, cnt = s_cnt;
      for (;;) {
        if (t == 0) s_end = min(N, r + span);
        __syncthreads();
        for (int j = t; j < span && r + j < N; j += THREADS)
          if (a.keys[r + j] != key) atomicMin(&s_end, r + j);  // sorted: the first differing row
        __syncthreads();
        const int e = s_end;
        for (int j = t; r + j < e; j += THREADS) {
          const long long oj = a.order[r + j];
          for (int c = 0; c < C; ++c) s_pts[j * C + c] = a.pts[oj * C + c];
        }
        __syncthreads();
        for (int c = t; c < C; c += THREADS) {
          float v = s_acc[c];
          for (int j = 0; j < e - r; ++j) v = v + s_pts[j * C + c];
          s_acc[c] = v;
        }
        cnt += e - r;
        const bool on = e == r + span && e < N;
        __syncthreads();
        if (!on) break;
        r = e;
      }
      const int g = excl + H - 1;
      for (int c = t; c < C; c += THREADS)
        a.out[static_cast<size_t>(g) * C + c] = s_acc[c] / static_cast<float>(cnt);
      if (t == 0) a.mask[g] = 1;
    }
  } else {
    // a fill block: its share of the rows nseg .. max_out - 1
    if (warp == 0) {
      const int nseg = lookback::count_before(status, a.ntiles);
      if (lane == 0) s_nseg = nseg;
    }
    __syncthreads();
    const int g0 = min(s_nseg, a.max_out), per = (a.max_out - g0 + a.nfill - 1) / a.nfill;
    const int lo = g0 + (tile - a.ntiles) * per, hi = min(a.max_out, lo + per);
    for (size_t i = static_cast<size_t>(lo) * C + t; i < static_cast<size_t>(hi) * C; i += THREADS)
      a.out[i] = 0.0f;
    for (int g = lo + t; g < hi; g += THREADS) a.mask[g] = 0;
  }

  // the last block to finish leaves the scratch at 0 for the next launch
  // (a tile's status words are fenced where written)
  __syncthreads();
  if (t == 0) s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (s_last) {
    __threadfence();
    for (int i = t; i < a.ntiles; i += THREADS) status[i] = 0u;
    if (t == 0) {
      *ticket = 0u;
      *done = 0u;
    }
  }
}

}  // namespace

// The scratch a launch of n rows of c columns takes: ints, zeroed once by
// the caller; every launch leaves them at 0. -1: the kernel does not take
// such rows (n >= 2^30: the status words count rows in 30 bits; c > 160:
// a tile's rows and 32 more no longer fit in shared memory).
extern "C" int voxel_centroids_scratch_ints(int n, int c) {
  if (n < 0 || static_cast<unsigned>(n) > VALUE || c < 1 || c > MAX_C) return -1;
  const int tile = tile_rows(c);
  return 2 + (n + tile - 1) / tile;
}

// C interface for ctypes. keys (n,) int64 sorted, order (n,) int64, pts
// (n, c) f32; out (max_out, c) f32, mask (max_out,) u8; scratch
// voxel_centroids_scratch_ints(n, c) int32, all 0 (left at 0); all
// contiguous on the device, and n < 2^30, c <= 160. Writes the grid's block
// count to *grid_out. Returns the launch's cudaError_t (0 = cudaSuccess);
// max_out = 0 launches nothing.
extern "C" int voxel_centroids_launch(const void* keys, const void* order, const void* pts,
                                      void* out, void* mask, void* scratch, int n, int c,
                                      int max_out, int* grid_out, void* stream) {
  *grid_out = 0;
  if (max_out <= 0) return 0;
  if (n < 0 || static_cast<unsigned>(n) > VALUE || c < 1 || c > MAX_C)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tile = tile_rows(c);
  const int ntiles = (n + tile - 1) / tile, nfill = (max_out + FILL_ROWS - 1) / FILL_ROWS;
  Args a{static_cast<const long long*>(keys), static_cast<const long long*>(order),
         static_cast<const float*>(pts), static_cast<float*>(out),
         static_cast<uint8_t*>(mask), static_cast<unsigned*>(scratch),
         n, c, max_out, tile, ntiles, nfill};
  const int grid = ntiles + nfill;
  *grid_out = grid;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c == 3)
    voxel_centroids_kernel<3><<<grid, THREADS, 0, s>>>(a);
  else
    voxel_centroids_kernel<0><<<grid, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
