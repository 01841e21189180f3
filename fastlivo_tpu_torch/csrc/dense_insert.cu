// The dense grid's insert (`map_backend: dense`, ops/dense_map.py) for
// Hopper: one cooperative launch, the grid written in place, no host read.
//
// Replaces no TPU kernel: it is the port of the jitted XLA code of
// fastlivo_tpu/ops/dense_map.py::insert (:70-114), whose torch version
// ops/dense_map.py::insert_plain fills a new (G + 1,) int64 array every
// frame (33.5 MB at 256 x 256 x 64 cells), scatter-mins into it and writes
// through `torch.nonzero`, which sizes its result on the host: a
// synchronising call every frame.
//
// Phase 1, a thread a row: the voxel k = floor(p / vs) as int32, its
// wrapped cell (dense_map._cell_check: each axis & (dim - 1), two's
// complement for negative k) and 31-bit check (csrc/hash_mix.cuh), the
// distance to the voxel centre x*x + y*y + z*z, and packed = (bits(d2c) <<
// 24) | row. A valid row takes part in its cell's minimum: atomicMax of
// 2^56 - packed (never 0, so the scratch of G int64 zeros stays the
// stream's zeroed scratch) into a persistent per-device scratch. Grid
// barrier. Phase 2, the same rows: a row is its cell's winner if the
// scratch holds its own value; the winner puts the word back at 0 (a later
// reader sees 0, never its own value), reads the cell's check and point
// (no other row writes that cell) and writes its check and point where
// the cell is empty, holds another voxel (aliased: evicted) or holds its
// voxel farther from the centre. count_out = count + the winners that
// filled an empty cell, by integer atomics.
//
// Bound on an H100: the bytes (each row's point and mask, the winners'
// cells read and the written cells, once each), ~1 us at the main path's
// 16384 rows; the launch, its barrier and the dependent reads of a winner
// hold it above that.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_mix.cuh"
#include "flat_map.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr long long TOP = 1LL << 56;  // above every packed value

struct Dense {
  const float* pts;      // (B, 3)
  const uint8_t* valid;  // (B,)
  const float* voxel_size;
  const int32_t* log2_dims;  // (3,)
  int32_t* check;            // (G,) in place
  float* mpts;               // (G, 3) in place
  const int32_t* count_in;
  int32_t* count_out;
  long long* scratch;  // (G,) zeros, left at 0
  int B;
  int32_t empty;
};

struct Row {
  int cell;
  int32_t check;
  float d2c, c[3];
  long long value;  // TOP - packed
};

__device__ __forceinline__ Row row_of(const Dense& a, int i, float vs, int lx, int ly, int lz) {
  Row w;
  int32_t k[3];
  float e[3];
  for (int q = 0; q < 3; ++q) {
    const float p = a.pts[3 * (size_t)i + q];
    k[q] = flat::voxel(p, vs);
    w.c[q] = flat::centre(k[q], vs);
    e[q] = p - w.c[q];
  }
  const int32_t kx = k[0] & ((1 << lx) - 1), ky = k[1] & ((1 << ly) - 1),
                kz = k[2] & ((1 << lz) - 1);
  w.cell = (kx << (ly + lz)) | (ky << lz) | kz;
  w.check = check31(k[0], k[1], k[2]);
  w.d2c = flat::sq3(e[0], e[1], e[2]);
  // (int64(bits) << 24) | row, the bits sign-extended as the torch code's
  const long long packed = (long long)__float_as_int(w.d2c) * (1LL << 24) + i;
  w.value = TOP - packed;
  return w;
}

__global__ void __launch_bounds__(THREADS) dense_insert_kernel(Dense a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_warp[THREADS / 32];
  const float vs = a.voxel_size[0];
  const int lx = a.log2_dims[0], ly = a.log2_dims[1], lz = a.log2_dims[2];
  const int stride = gridDim.x * THREADS;
  const int first = blockIdx.x * THREADS + threadIdx.x;
  if (first == 0) *a.count_out = *a.count_in;
  for (int i = first; i < a.B; i += stride) {
    if (!a.valid[i]) continue;
    const Row w = row_of(a, i, vs, lx, ly, lz);
    atomicMax(a.scratch + w.cell, w.value);
  }
  grid.sync();
  int gained = 0;
  for (int i = first; i < a.B; i += stride) {
    if (!a.valid[i]) continue;
    const Row w = row_of(a, i, vs, lx, ly, lz);
    if (__ldcg(a.scratch + w.cell) != w.value) continue;
    a.scratch[w.cell] = 0;
    const int32_t cur = a.check[w.cell];
    float* sp = a.mpts + 3 * (size_t)w.cell;
    const float stored = flat::sq3(sp[0] - w.c[0], sp[1] - w.c[1], sp[2] - w.c[2]);
    const bool empty = cur == a.empty, mine = cur == w.check;
    if (empty || !mine || w.d2c < stored) {  // empty, aliased, or its voxel farther
      a.check[w.cell] = w.check;
      for (int q = 0; q < 3; ++q) sp[q] = a.pts[3 * (size_t)i + q];
      gained += empty;
    }
  }
  const int s = flat::block_sum(gained, s_warp);
  if (threadIdx.x == 0 && s) atomicAdd(a.count_out, s);
}

int g_resident[flat::MAX_DEV];

}  // namespace

// C interface for ctypes, all pointers contiguous on the device: pts (B,
// 3) f32, valid (B,) bool, voxel_size () f32, log2_dims (3,) int32; the
// grid's check (G,) int32 and mpts (G, 3) f32, written in place; count_in
// () int32; count_out () int32 (written); scratch G int64 zeros (8-byte
// aligned, left at 0). B < 2^24 (the packed row). Launches also at B = 0
// (count_out = count_in). Writes the grid's block count to *grid_out.
extern "C" int dense_insert_launch(const void* pts, const void* valid, const void* voxel_size,
                                   const void* log2_dims, void* check, void* mpts,
                                   const void* count_in, void* count_out, void* scratch, int B,
                                   int empty_check, int* grid_out, void* stream) {
  *grid_out = 0;
  if (B < 0 || B >= (1 << 24) || (reinterpret_cast<uintptr_t>(scratch) & 7))
    return static_cast<int>(cudaErrorInvalidValue);
  Dense a;
  a.pts = static_cast<const float*>(pts);
  a.valid = static_cast<const uint8_t*>(valid);
  a.voxel_size = static_cast<const float*>(voxel_size);
  a.log2_dims = static_cast<const int32_t*>(log2_dims);
  a.check = static_cast<int32_t*>(check);
  a.mpts = static_cast<float*>(mpts);
  a.count_in = static_cast<const int32_t*>(count_in);
  a.count_out = static_cast<int32_t*>(count_out);
  a.scratch = static_cast<long long*>(scratch);
  a.B = B;
  a.empty = (int32_t)empty_check;
  void* args[] = {&a};
  return flat::coop_launch((const void*)dense_insert_kernel, THREADS,
                           ((long long)B + THREADS - 1) / THREADS, args, g_resident, grid_out,
                           static_cast<cudaStream_t>(stream));
}
