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
// so the two sorts give the same permutation). Phase 1: each block
// computes its tiles' keys and reduces each field's min and max and a
// has-invalid flag into the scratch by integer atomics (max of f + 1 and of
// 2^20 - f: the scratch's 0 is "no row"). Grid barrier. Every thread reads
// them and derives R and the pass count ceil(bits(r_max) / 8) on the
// device (0 where every rank is equal: the identity; up to 8 where the
// spread needs all 60 bits and the marker). Then the stable LSD radix
// passes of csrc/radix_passes.cuh over (key, row), shared with the tiled
// insert's sort (csrc/tiled_insert.cu): tiles of 1024 positions, a block
// their consecutive run, each block's digit counts published in the pass's
// histogram row and read by the others without a barrier of their own, one
// grid barrier after each pass but the last, two histogram buffers left at
// 0. Pass 0 ranks after the first barrier: the rank's low byte is (fz -
// min_z) mixed with the fields above it, which needs the global minimum.
// A rank whose z field starts at a multiple of 256 would make that byte
// the key's own (fz & 255) and let the keys phase count it, but it takes
// up to 8 more bits, a third pass on the LIO path's 2-pass scans
// (`aligned_sort_bits_passes` in the shape line of
// scripts/torch_vio_kernels_bench.py), so the rank stays compact.
//
// Bound on an H100: the sort reads 12 B of each row and its valid byte and
// writes 16 B (keys and order; ~0.3 us at the LIO scan's 32768 rows); its
// operations (the key's ~30 a row, ~20 a row and pass) are far below that.
// What holds it: the launch, its grid barriers (the first and one between
// passes, ~1 us each on this card) and the chains inside a pass (a
// warp's items in order, the wait on the G-row column, the digit scan).
// Built with -DPHASE_STAMPS (csrc/phase_stamps.cuh) the launch stamps the keys and the first
// barrier, and the passes theirs (radix_passes.cuh).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "phase_stamps.cuh"
#include "radix_passes.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr long long INVALID = 1LL << 62;
constexpr long long OFF = 1LL << 19;
constexpr long long MASK20 = 0xFFFFF;

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
  radix::Buffers<long long> out;
  int divide, c;
};

// Pass 0's keys: computed from the rows.
struct KeySource {
  const float* pts;
  const uint8_t* valid;
  float s;
  int divide, c;
  __device__ __forceinline__ long long key(int i) const {
    return packed_key(pts, valid, s, divide, i, c);
  }
};

// The compact rank (see the top), the same in every thread after the
// first barrier.
struct Rank {
  long long lo[3];
  unsigned long long ry, rz, rinv;  // R_y, R_z, R_x R_y R_z (an invalid row's rank)
  __device__ __forceinline__ unsigned long long operator()(long long key) const {
    if (key == INVALID) return rinv;
    const long long fx = (key >> 40) & MASK20, fy = (key >> 20) & MASK20, fz = key & MASK20;
    return (static_cast<unsigned long long>(fx - lo[0]) * ry +
            static_cast<unsigned long long>(fy - lo[1])) * rz +
           static_cast<unsigned long long>(fz - lo[2]);
  }
};

// At most 128 registers a thread (two blocks an SM): left to itself ptxas
// gave some builds of this kernel 64 and spills, and those ran 10-30%
// slower on the card (scripts/torch_vio_kernels_bench.py, PERF.md).
template <int ITEMS>
__global__ void __launch_bounds__(radix::THREADS, 2) voxel_sort_kernel(Sort a) {
  __shared__ radix::Shared<long long, ITEMS> s;
  PHASE_STAMP_START();
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x, b = blockIdx.x;
  const int n = a.out.n;
  const int ntiles = (n + radix::THREADS * ITEMS - 1) / (radix::THREADS * ITEMS);
  const int j0 = b * a.out.tiles, j1 = min(j0 + a.out.tiles, ntiles);  // this block's tiles
  const KeySource src{a.pts, a.valid, *a.scale, a.divide, a.c};

  // phase 1: the keys' extremes (the block's last tile's keys stay)
  if (t < radix::W_DONE) s.red[t] = 0;
  __syncthreads();
  long long key[ITEMS] = {};
  int row[ITEMS];
  unsigned hi[3] = {0, 0, 0}, lo[3] = {0, 0, 0}, inv = 0;
  for (int j = j0; j < j1; ++j) {
    radix::load_tile<ITEMS>(src, a.out, j, 0, false, key, row);
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
  radix::reduce_extremes(hi, lo, inv, s, a.out.ws);
  PHASE_STAMP(1);
  grid.sync();  // every block's extremes in the header
  PHASE_STAMP(2);

  const radix::Extent e = radix::extent_of(a.out.ws, 1LL << 20);
  int digit[ITEMS];
  unsigned rnk[ITEMS];
  Rank rank;
#pragma unroll
  for (int q = 0; q < 3; ++q) rank.lo[q] = e.lo[q];
  rank.ry = e.r[1];
  rank.rz = e.r[2];
  rank.rinv = e.r[0] * e.r[1] * e.r[2];
  const unsigned long long rmax = !e.any ? 0ull : e.inv ? rank.rinv : rank.rinv - 1;
  radix::sort_passes<ITEMS>(grid, src, rank, radix::passes_for(rmax), a.out, s, key, row,
                            digit, rnk, 0u, false, a.out.tiles == 1);
}

constexpr int ITEMS = 4;  // rows a thread in a tile
constexpr int TILE = radix::THREADS * ITEMS;
int g_resident[radix::MAX_DEV];

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

// The scratch (32-bit words) a sort of n rows takes: the header and two
// histograms of one row of 256 words a block, a block a tile of 1024 rows
// at most and at most radix::MAX_GRID blocks; -1 for an n the launch does
// not take.
extern "C" int voxel_sort_scratch_ints(int n) {
  return radix::scratch_ints(n, TILE, radix::HEAD);
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
  const void* kernel = reinterpret_cast<const void*>(voxel_sort_kernel<ITEMS>);
  int resident = 0;
  cudaError_t e = radix::resident_blocks(kernel, g_resident, &resident);
  if (e != cudaSuccess) return static_cast<int>(e);
  int grid = 0, tiles = 0;
  radix::plan(n, TILE, resident, &grid, &tiles);
  Sort a;
  a.pts = static_cast<const float*>(pts);
  a.valid = static_cast<const uint8_t*>(valid);
  a.scale = static_cast<const float*>(scale);
  a.out = radix::Buffers<long long>{static_cast<long long*>(keys), static_cast<long long*>(order),
                                    static_cast<long long*>(tmp_keys),
                                    static_cast<int*>(tmp_rows), static_cast<unsigned*>(ws),
                                    radix::HEAD, n, tiles};
  a.divide = divide;
  a.c = c;
  void* args[] = {&a};
  *grid_out = grid;
  *tiles_out = tiles;
  e = cudaLaunchCooperativeKernel(kernel, dim3(static_cast<unsigned>(grid)),
                                  dim3(radix::THREADS), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
