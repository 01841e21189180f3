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
// Phase 1, each valid row once: the voxel k = floor(p / vs) as int32, its
// wrapped cell (dense_map._cell_check: each axis & (dim - 1), two's
// complement for negative k) and 31-bit check (csrc/hash_mix.cuh), the
// distance to the voxel centre x*x + y*y + z*z, and packed = (bits(d2c) <<
// 24) | row. The row takes part in its cell's minimum: atomicMax of 2^56 -
// packed (never 0, so the scratch of G int64 zeros stays the stream's
// zeroed scratch) into a persistent per-device scratch. Invalid rows take
// no part. Grid barrier. Phase 2: a row is its cell's winner if the
// scratch holds its own value (one read); the winner puts the word back at
// 0 (a later reader sees 0, never its own value), reads its cell (no other
// row writes that cell) and writes its check and point where the cell is
// empty, holds another voxel (aliased: evicted) or holds its voxel
// farther from the centre. count_out = count + the winners that filled an
// empty cell, by integer atomics.
//
// Bound on an H100: the bytes (each row's point and mask, the winners'
// cells read and the written cells, once each), ~0.1 us at the main path's
// 16384 rows; what is left is the launch, the barrier and the chains
// around it. Design: a thread a row over a co-resident grid (64 blocks of
// 256 threads at 16384 rows); a thread keeps its row in registers across
// the barrier (its cell, value, check, centre and point), so that phase 2
// reads no pts or valid and computes no row again; every load that waits
// on no other (the row's point and mask, the constants, the count) is
// issued first, and phase 2 reads its scratch word, then a winner its
// cell. Rows past one a thread (B > 270336: the grid is capped at the
// blocks the card holds at once) are computed again after the barrier.
// Two designs with one cluster's hardware barrier in place of the grid's
// were slower on the card, and are not kept: 8 blocks of 1024 threads
// 5.23 us, 16 blocks 5.79, against this launch's 3.52 and the first
// version's 4.35 (PERF.md, PR 27, call 4). The cluster barrier took 0.78
// us against the grid barrier's 0.99, but the cluster puts the batch on 8
// or 16 SMs, where each phase's random atomics and cell reads queue: phase
// 1 1.66 us against 0.70, phase 2 1.81 against 0.83. Reading every row's
// cell before the barrier (so that phase 2 would read nothing but the
// scratch word) was slower still, 8.27 us on 8 SMs (four uncoalesced loads
// a row where ~1400 of 16384 rows win, call 3). Built with -DPHASE_STAMPS (csrc/phase_stamps.cuh;
// scripts/torch_lidar_frame_ab.py --stamps) the launch stamps the end of
// phase 1, of the barrier, of phase 2 and of its count.
//
// Ordering: the atomics are device-scope read-modify-writes, performed in
// L2; grid.sync() fences before it arrives, so every atomic and the
// count's initial store (thread 0) are visible after it, and phase 2
// reads the scratch in L2 (__ldcg), where the atomics were performed. A
// card test holds 16384 rows in one cell and in 16384 distinct cells.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flat_map.cuh"
#include "hash_mix.cuh"
#include "phase_stamps.cuh"

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

__device__ __forceinline__ Row row_of(const float p[3], int i, float vs, int lx, int ly,
                                      int lz) {
  Row w;
  int32_t k[3];
  float e[3];
  for (int q = 0; q < 3; ++q) {
    k[q] = flat::voxel(p[q], vs);
    w.c[q] = flat::centre(k[q], vs);
    e[q] = p[q] - w.c[q];
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

// The winner of its cell: puts the scratch word back at 0, reads the cell
// (no other row writes it) and writes its check and point where the cell
// is empty, aliased (another voxel) or holds its voxel farther from the
// centre. Returns 1 where it filled an empty cell.
__device__ __forceinline__ int settle(const Dense& a, const Row& w, const float p[3]) {
  a.scratch[w.cell] = 0;
  const int32_t cur = a.check[w.cell];
  float* sp = a.mpts + 3 * (size_t)w.cell;
  const float stored = flat::sq3(sp[0] - w.c[0], sp[1] - w.c[1], sp[2] - w.c[2]);
  const bool empty = cur == a.empty, mine = cur == w.check;
  if (!(empty || !mine || w.d2c < stored)) return 0;
  a.check[w.cell] = w.check;
  for (int q = 0; q < 3; ++q) sp[q] = p[q];
  return empty;
}

__global__ void __launch_bounds__(THREADS) dense_insert_kernel(Dense a) {
  __shared__ int s_warp[THREADS / 32];
  PHASE_STAMP_START();
  const int stride = gridDim.x * THREADS;
  const int i0 = blockIdx.x * THREADS + threadIdx.x;
  // every load that waits on no other issued first: the thread's row's
  // point and mask (an invalid row's point is read and its row computed,
  // and nothing of it used), the constants, the count
  const bool valid = i0 < a.B && a.valid[i0];
  float p[3];
  for (int q = 0; q < 3; ++q) p[q] = i0 < a.B ? a.pts[3 * (size_t)i0 + q] : 0.f;
  const float vs = a.voxel_size[0];
  const int lx = a.log2_dims[0], ly = a.log2_dims[1], lz = a.log2_dims[2];
  const int32_t count_in = i0 == 0 ? *a.count_in : 0;
  const Row w = row_of(p, i0, vs, lx, ly, lz);  // kept across the barrier
  if (valid) atomicMax(a.scratch + w.cell, w.value);
  for (int i = i0 + stride; i < a.B; i += stride) {  // rows past the grid's threads
    if (!a.valid[i]) continue;
    const float q[3] = {a.pts[3 * (size_t)i], a.pts[3 * (size_t)i + 1],
                        a.pts[3 * (size_t)i + 2]};
    const Row x = row_of(q, i, vs, lx, ly, lz);
    atomicMax(a.scratch + x.cell, x.value);
  }
  if (i0 == 0) *a.count_out = count_in;
  PHASE_STAMP(1);
  cg::this_grid().sync();  // every row's atomicMax before any winner's test
  PHASE_STAMP(2);
  int gained = valid && __ldcg(a.scratch + w.cell) == w.value ? settle(a, w, p) : 0;
  for (int i = i0 + stride; i < a.B; i += stride) {  // computed again
    if (!a.valid[i]) continue;
    const float q[3] = {a.pts[3 * (size_t)i], a.pts[3 * (size_t)i + 1],
                        a.pts[3 * (size_t)i + 2]};
    const Row x = row_of(q, i, vs, lx, ly, lz);
    if (__ldcg(a.scratch + x.cell) == x.value) gained += settle(a, x, q);
  }
  PHASE_STAMP(3);
  const int s = flat::block_sum(gained, s_warp);
  if (threadIdx.x == 0 && s) atomicAdd(a.count_out, s);
  PHASE_STAMP(4);
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

PHASE_STAMPS_EXPORT(dense_insert)
