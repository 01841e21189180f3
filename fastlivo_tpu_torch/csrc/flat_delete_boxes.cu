// The sliding window's box delete on the flat maps, for Hopper: one launch
// for the hash map (ops/voxel_map.py) and the dense grid
// (ops/dense_map.py), which share the layout check (T,) int32, pts (T, 3)
// f32, count () int32, voxel_size () f32.
//
// Replaces no TPU kernel: it is the port of the jitted XLA code of
// fastlivo_tpu/ops/voxel_map.py::delete_boxes (:268-286) and
// fastlivo_tpu/ops/dense_map.py::delete_boxes (:141-157), whose torch
// version ops/voxel_map.py::delete_boxes_plain (`in_boxes`) computes the
// voxel centre of every slot, occupied or not, then makes two
// all-reductions per box over them and a masked fill: 0.93 ms of device
// time a frame on the dense grid's 2^22 cells. For each occupied slot
// (check != EMPTY) the centre per axis (float(floor(p / vs)) + 0.5f) * vs
// (a true f32 division; built with -fmad=false, so the add and the
// multiply round as the two torch ops do), and the slot's check set to
// EMPTY where any box holds the centre on every axis (lo <= c <= hi; a box
// with lo > hi, or a NaN bound, holds nothing). Every other slot is left
// unwritten (masked-fill semantics). count_out = count - killed, an
// integer sum.
//
// Bound on an H100: the bytes, and of those the check table: every slot's
// check (4 B), each occupied slot's point (12 B), the boxes once and 4 B
// per killed slot. A window's map is mostly empty slots (the smoke run's
// maps: 2496 occupied of 2^20 and 2^22), so the launch is a scan of 4.2
// MB (hash) or 16.8 MB (dense) of checks: ~1.3 and ~5 us at 3.35 TB/s.
// A scan reaches that rate only with ~2-3 MB of loads in flight, and a
// launch this short is also held by its chain of dependent memory
// round trips.
//
// Design: one pass, no thread loops over the table. The body (from the
// first 16-byte-aligned check on) is cut into 4-slot groups, one 16-byte
// load each; a warp owns 512 consecutive slots and each lane four groups
// of them, lane, lane + 32, lane + 64 and lane + 96, so that each of its
// four loads is one coalesced 512-byte row of the warp and all four are
// issued before any is used: the grid holds the whole table in flight
// (256 blocks of 256 threads at 2^20 slots, 1024 at 2^22). The head
// (up to 3 slots before the first aligned check) and the tail (up to 3
// past the last whole group) take a thread a slot past the body's
// threads. Every load that waits on no other (the checks, the voxel size,
// the first 256 boxes, the count) is issued at the start, so the chain is
// three round trips: the checks, the occupied slots' points, the count's
// atomic. A block's occupied slots go into one queue in shared memory,
// and every thread reads and tests its share of it (4 slots' points in
// flight at once): a lane that found 16 occupied slots would otherwise
// test them one after another while the rest of the block idles, and a
// thread needs no registers for points it does not hold. A slot's point
// is read only where it is occupied. The boxes are staged in shared
// memory, 256 at a time, in turns past that (every thread takes part in
// every turn; a turn re-reads the points of the slots not yet killed). A
// kill is a scalar store of the slot's check. The count: a block sum
// each, then one 64-bit atomic a block on the stream's scratch that adds
// the sum and ticks the block off; the block that takes the last tick
// writes count_out and puts the word back at 0.
// tests/test_torch_flat_map_kernels.py holds a numpy model of the
// partition (each slot once, for every power-of-two T and base offset).
// Built with -DPHASE_STAMPS (csrc/phase_stamps.cuh;
// scripts/torch_lidar_frame_ab.py --stamps) the launch stamps the end of
// its loads, its queue and tests, its block sums and its count.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flat_map.cuh"
#include "phase_stamps.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int GROUPS = 4;                 // 4-slot groups a lane: four 16-byte loads
constexpr int WARP_GROUPS = 32 * GROUPS;  // a warp's 512 consecutive slots
constexpr int LANE_STRIDE = 4 * 32;       // slots from one of a lane's groups to the next
constexpr int BOX_CAP = 256;              // boxes staged at once
constexpr int QUEUE = THREADS * 4 * GROUPS;  // a block's slots
constexpr int UNROLL = 4;                 // queued slots a thread reads at once

struct Scan {
  int32_t* check;
  const float* pts;
  const float* voxel_size;
  const float* lo;
  const float* hi;
  const int32_t* count_in;
  int32_t* count_out;
  unsigned long long* scratch;  // (blocks done << 32) + slots killed, left at 0
  int n_boxes;
  int head;          // scalar slots before the body, [0, head)
  int groups;        // the body's 4-slot groups, slots [head, head + 4 groups)
  int tail;          // scalar slots past it
  int body_threads;  // 32 per 128 groups
  int32_t empty;
};

__device__ __forceinline__ bool in_any(const float c[3], const float* s_lo, const float* s_hi,
                                       int nb) {
  for (int b = 0; b < nb; ++b) {
    bool in = true;
#pragma unroll
    for (int q = 0; q < 3; ++q) in &= c[q] >= s_lo[3 * b + q] && c[q] <= s_hi[3 * b + q];
    if (in) return true;
  }
  return false;
}

__device__ __forceinline__ void stage(const Scan& a, int b0, int nb, float* s_lo, float* s_hi) {
  for (int k = threadIdx.x; k < 3 * nb; k += THREADS) {
    s_lo[k] = a.lo[3 * b0 + k];
    s_hi[k] = a.hi[3 * b0 + k];
  }
}

__global__ void __launch_bounds__(THREADS) flat_delete_boxes_kernel(Scan a) {
  __shared__ float s_lo[3 * BOX_CAP], s_hi[3 * BOX_CAP];
  __shared__ int s_queue[QUEUE];  // the block's occupied slots; -1 once killed
  __shared__ int s_n, s_warp[THREADS / 32];
  PHASE_STAMP_START();
  const int t = threadIdx.x;
  const int gid = blockIdx.x * THREADS + t;
  const bool body = gid < a.body_threads;
  // a body lane's slots: base + 128 j + e (group j < 4, e < 4); a head or
  // tail thread's one slot: base (bit 0)
  const int g0 = (gid >> 5) * WARP_GROUPS + (gid & 31);
  const int s = gid - a.body_threads;
  const int base = body ? a.head + 4 * g0
                        : s < a.head ? s : a.head + 4 * a.groups + (s - a.head);
  // every load that waits on no other issued first: the checks, the voxel
  // size, the first boxes, the count
  int4 v[GROUPS];
  const int4* words = reinterpret_cast<const int4*>(a.check + a.head);
#pragma unroll
  for (int j = 0; j < GROUPS; ++j) {
    const int g = g0 + 32 * j;
    v[j] = body && g < a.groups ? words[g] : make_int4(a.empty, a.empty, a.empty, a.empty);
  }
  const bool one = !body && s < a.head + a.tail;
  const int32_t c1 = one ? a.check[base] : a.empty;
  const float vs = a.voxel_size[0];
  const int32_t count_in = t == 0 ? *a.count_in : 0;
  int nb = min(BOX_CAP, a.n_boxes);
  stage(a, 0, nb, s_lo, s_hi);
  if (t == 0) s_n = 0;
  unsigned occ = c1 != a.empty;
#pragma unroll
  for (int j = 0; j < GROUPS; ++j)
    occ |= ((unsigned)(v[j].x != a.empty) | (unsigned)(v[j].y != a.empty) << 1
            | (unsigned)(v[j].z != a.empty) << 2 | (unsigned)(v[j].w != a.empty) << 3)
           << (4 * j);
  __syncthreads();
  PHASE_STAMP(1);
  // the block's occupied slots into one queue, so that their points are
  // read and tested by every thread at once, whichever lane found them
  if (occ) {
    int at = atomicAdd(&s_n, __popc(occ));
    for (unsigned m = occ; m; m &= m - 1) {
      const int k = __ffs(m) - 1;
      s_queue[at++] = base + LANE_STRIDE * (k >> 2) + (k & 3);
    }
  }
  __syncthreads();
  const int n = s_n;
  int killed = 0;
  for (int b0 = 0; b0 < a.n_boxes; b0 += BOX_CAP) {  // block-uniform turns of 256 boxes
    if (b0) {
      nb = min(BOX_CAP, a.n_boxes - b0);
      __syncthreads();  // the last turn's boxes read, its kills marked
      stage(a, b0, nb, s_lo, s_hi);
      __syncthreads();
    }
    for (int k0 = t; k0 < n; k0 += UNROLL * THREADS) {
      int slot[UNROLL];
      float p[UNROLL][3];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {  // the points' loads issued together
        const int k = k0 + u * THREADS;
        slot[u] = k < n ? s_queue[k] : -1;
        for (int q = 0; q < 3; ++q) p[u][q] = slot[u] >= 0 ? a.pts[3 * (size_t)slot[u] + q] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (slot[u] < 0) continue;  // none, or killed in an earlier turn
        float c[3];
        for (int q = 0; q < 3; ++q) c[q] = flat::centre(flat::voxel(p[u][q], vs), vs);
        if (in_any(c, s_lo, s_hi, nb)) {
          a.check[slot[u]] = a.empty;
          s_queue[k0 + u * THREADS] = -1;
          ++killed;
        }
      }
    }
  }
  PHASE_STAMP(2);
  // the count: a block sum each, then one 64-bit atomic a block that adds
  // the sum and ticks the blocks done; the last block writes count_out
  const int sum = flat::block_sum(killed, s_warp);
  PHASE_STAMP(3);
  if (t == 0) {
    const unsigned long long old = atomicAdd(a.scratch, (1ull << 32) + (unsigned)sum);
    if ((unsigned)(old >> 32) == gridDim.x - 1) {  // every other block's sum is in
      const uint32_t total = (uint32_t)old + (uint32_t)sum;
      *a.scratch = 0;  // no atomic of this launch is left
      *a.count_out = (int32_t)((uint32_t)count_in - total);  // int32 wrap, as torch's
    }
  }
  PHASE_STAMP(4);
}

}  // namespace

// C interface for ctypes. check (T,) int32 (written in place; any 4-byte
// aligned base), pts (T, 3) f32 (4-byte aligned), voxel_size () f32, the
// boxes lo, hi (n_boxes, 3) f32, count_in () int32, count_out () int32
// (written), scratch 2 int32 zeros, 8-byte aligned (left at 0); all
// contiguous on the device. Writes the grid's block count to *grid_out.
// Returns the launch's cudaError_t (0 = cudaSuccess); T = 0 or n_boxes = 0
// launches nothing and writes no count.
extern "C" int flat_delete_boxes_launch(void* check, const void* pts, const void* voxel_size,
                                        const void* lo, const void* hi, const void* count_in,
                                        void* count_out, void* scratch, int n_boxes, int T,
                                        int empty_check, int* grid_out, void* stream) {
  *grid_out = 0;
  if (T <= 0 || n_boxes <= 0) return 0;
  const uintptr_t c = reinterpret_cast<uintptr_t>(check), p = reinterpret_cast<uintptr_t>(pts);
  if ((c | p) & 3 || reinterpret_cast<uintptr_t>(scratch) & 7)
    return static_cast<int>(cudaErrorInvalidValue);
  Scan a;
  a.check = static_cast<int32_t*>(check);
  a.pts = static_cast<const float*>(pts);
  a.voxel_size = static_cast<const float*>(voxel_size);
  a.lo = static_cast<const float*>(lo);
  a.hi = static_cast<const float*>(hi);
  a.count_in = static_cast<const int32_t*>(count_in);
  a.count_out = static_cast<int32_t*>(count_out);
  a.scratch = static_cast<unsigned long long*>(scratch);
  a.n_boxes = n_boxes;
  a.head = (int)(((16 - (c & 15)) & 15) >> 2);
  if (a.head > T) a.head = T;
  a.groups = (T - a.head) >> 2;
  a.tail = (T - a.head) & 3;
  a.body_threads = (a.groups + WARP_GROUPS - 1) / WARP_GROUPS * 32;
  a.empty = (int32_t)empty_check;
  const long long threads = (long long)a.body_threads + a.head + a.tail;
  const int blocks = (int)((threads + THREADS - 1) / THREADS);
  *grid_out = blocks;
  flat_delete_boxes_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

PHASE_STAMPS_EXPORT(flat_delete_boxes)
