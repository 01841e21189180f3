// The scan voxel filter's segmented centroid after its sort, for Hopper.
//
// Replaces no TPU kernel: it is the port of the jitted XLA code of
// fastlivo_tpu/ops/voxel_filter.py::voxel_downsample_device after its
// argsort (:51-70: segment heads, a cumsum of heads, a scatter-add of the
// rows and of their count into max_out rows, the division, the mask),
// whose torch version ops/voxel_filter.py::voxel_centroids_plain is a
// chain of gathers, a cumsum, an index_add_ of the lengths and
// torch.segment_reduce. Input: the rows' packed voxel keys (N,) int64 in
// row order, the invalid marker 2^62 where the row is invalid or not
// finite (every valid key is below 2^60, so a row is valid iff its key is
// not the marker: the keys carry the valid mask); the stable argsort
// `order` (N,) int64 of the keys; the rows pts (N, C) f32. In sorted
// order, row r is a segment head when it is valid and its key differs
// from row r - 1's; segment g is the g-th head's run of equal keys.
// Output row g < max_out: the run's rows summed column by column in row
// order starting from +0.0f (as segment_reduce(..., initial=0.0) sums on
// the CPU, so a -0.0 coordinate sums to +0.0), divided by the run's
// length with IEEE f32 division (no --use_fast_math), mask true; rows
// past the segments: zeros, mask false. Segments past max_out and the
// invalid rows (all sorted after the valid ones) are dropped. The sums
// then carry the CPU's bits.
//
// Design: one cooperative launch of G <= ceil(N / 256) co-resident
// 256-thread blocks, block b owning a contiguous range of sorted rows.
// Phase 1: each block counts its heads and valid rows (__syncthreads_count
// over tiles of 256 rows) into counts[b], counts[G + b]. Grid barrier.
// Phase 2: each block's first segment number is the sum of the earlier
// blocks' head counts; a ballot and a scan of the warps' counts number
// each tile's heads in order, and head g <= max_out writes its sorted row
// into start[g]. Grid barrier. Phase 3: a thread per output row g sums
// rows start[g] .. start[g + 1] (or the number of valid rows, for the
// last segment) through `order`. No atomics: every launch gives the same
// bits, for any N (no cap: the blocks loop over their rows).
//
// Bound on an H100: the work reads each row's order entry (8 B), its key
// (8 B) and its C floats once and writes max_out rows of C floats and a
// mask byte; a few operations a row. Bytes bound it; chip_smoke.py counts
// them from its inputs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr long long INVALID = 1LL << 62;

struct Args {
  const long long* packed;  // (n,) row order
  const long long* order;   // (n,) the stable argsort of packed
  const float* pts;         // (n, c)
  float* out;               // (max_out, c)
  uint8_t* mask;            // (max_out,)
  int32_t* start;           // (max_out + 1,) scratch: the sorted row of head g
  int32_t* counts;          // (2 * grid,) scratch: heads, valid rows per block
  int n, c, max_out, rows_per_block;
};

__device__ __forceinline__ long long sorted_key(const Args& a, int r) {
  return a.packed[a.order[r]];
}

// row r (sorted order, r < n): (valid, head)
__device__ __forceinline__ void classify(const Args& a, int r, bool& valid, bool& head) {
  const long long k = sorted_key(a, r);
  valid = k != INVALID;
  head = valid && (r == 0 || sorted_key(a, r - 1) != k);
}

__global__ void __launch_bounds__(THREADS) voxel_centroids_kernel(Args a) {
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, b = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int r0 = b * a.rows_per_block;
  const int r1 = min(a.n, r0 + a.rows_per_block);

  // phase 1: this block's heads and valid rows
  int heads = 0, valid_rows = 0;
  for (int base = r0; base < r1; base += THREADS) {
    const int r = base + t;
    bool v = false, h = false;
    if (r < r1) classify(a, r, v, h);
    heads += __syncthreads_count(h);
    valid_rows += __syncthreads_count(v);
  }
  if (t == 0) {
    a.counts[b] = heads;
    a.counts[G + b] = valid_rows;
  }
  grid.sync();

  // every block: the segments before it, all segments, all valid rows
  __shared__ int s_red[3][WARPS];
  __shared__ int s_warp[WARPS];
  int before = 0, nseg = 0, nvalid = 0;
  for (int i = t; i < G; i += THREADS) {
    const int h = a.counts[i];
    nseg += h;
    nvalid += a.counts[G + i];
    if (i < b) before += h;
  }
  for (int o = 16; o; o >>= 1) {
    before += __shfl_xor_sync(0xffffffffu, before, o);
    nseg += __shfl_xor_sync(0xffffffffu, nseg, o);
    nvalid += __shfl_xor_sync(0xffffffffu, nvalid, o);
  }
  if (lane == 0) {
    s_red[0][warp] = before;
    s_red[1][warp] = nseg;
    s_red[2][warp] = nvalid;
  }
  __syncthreads();
  before = nseg = nvalid = 0;
  for (int w = 0; w < WARPS; ++w) {
    before += s_red[0][w];
    nseg += s_red[1][w];
    nvalid += s_red[2][w];
  }

  // phase 2: number this block's heads in row order; head g <= max_out
  // records its row (start[max_out] ends segment max_out - 1)
  int seg = before;  // the number of the tile's first head
  for (int base = r0; base < r1; base += THREADS) {
    const int r = base + t;
    bool v = false, h = false;
    if (r < r1) classify(a, r, v, h);
    const uint32_t bal = __ballot_sync(0xffffffffu, h);
    if (lane == 0) s_warp[warp] = __popc(bal);
    __syncthreads();
    int ex = seg, total = 0;
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) ex += s_warp[w];
      total += s_warp[w];
    }
    ex += __popc(bal & ((1u << lane) - 1u));
    if (h && ex <= a.max_out) a.start[ex] = r;
    seg += total;
    __syncthreads();  // s_warp is rewritten by the next tile
  }
  grid.sync();

  // phase 3: a thread per output row, each run summed in row order
  const int nout = min(nseg, a.max_out);
  for (int g = b * THREADS + t; g < a.max_out; g += G * THREADS) {
    float* o = a.out + (size_t)g * a.c;
    if (g < nout) {
      const int s0 = a.start[g];
      const int s1 = g + 1 < nseg ? a.start[g + 1] : nvalid;
      const float cnt = (float)(s1 - s0);
      for (int col = 0; col < a.c; ++col) {
        float s = 0.0f;
        for (int r = s0; r < s1; ++r) s = s + a.pts[(size_t)a.order[r] * a.c + col];
        o[col] = s / cnt;
      }
      a.mask[g] = 1;
    } else {
      for (int col = 0; col < a.c; ++col) o[col] = 0.0f;
      a.mask[g] = 0;
    }
  }
}

}  // namespace

// C interface for ctypes. packed (n,) int64, order (n,) int64, pts (n, c)
// f32; out (max_out, c) f32, mask (max_out,) u8; scratch start (max_out +
// 1,) int32 and counts (2 * ceil(max(n, 1) / 256),) int32; all contiguous
// on the device. Writes the grid's block count to *grid_out. Returns the
// launch's cudaError_t (0 = cudaSuccess); max_out = 0 launches nothing.
extern "C" int voxel_centroids_launch(const void* packed, const void* order, const void* pts,
                                      void* out, void* mask, void* start, void* counts, int n,
                                      int c, int max_out, int* grid_out, void* stream) {
  *grid_out = 0;
  if (max_out <= 0) return 0;
  if (n < 0 || c < 1) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, voxel_centroids_kernel, THREADS,
                                                      0);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int want = n < 1 ? 1 : (n + THREADS - 1) / THREADS;
  const int grid = want < per_sm * sms ? want : per_sm * sms;
  Args a{static_cast<const long long*>(packed), static_cast<const long long*>(order),
         static_cast<const float*>(pts), static_cast<float*>(out),
         static_cast<uint8_t*>(mask), static_cast<int32_t*>(start),
         static_cast<int32_t*>(counts), n, c, max_out,
         // whole tiles per block, so a tile's rows lie in one block
         ((n + grid - 1) / grid + THREADS - 1) / THREADS * THREADS};
  *grid_out = grid;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel((const void*)voxel_centroids_kernel, dim3(grid),
                                  dim3(THREADS), args, 0, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
