// The sliding window's box delete on the tiled map, for Hopper.
//
// Replaces no TPU kernel: it is the port of the jitted XLA code of
// fastlivo_tpu/ops/tiled_map.py::delete_boxes (:246-260), whose torch
// version ops/tiled_map.py::delete_boxes_plain materialises every pool
// cell's voxel coordinate (T * 512 x 3 int32, 100 MB at the shipped 16384
// slots) and its f32 centre, and makes two all-reductions per box over
// them. For each pool cell of each slot 0..T-1 (allocated or not: after
// `compact` the slots past n_alloc keep stale keys and cells, and the
// torch code clears those too), the voxel v = slot_key * 8 + in-tile
// offset per axis (int32 wrap, as the torch code's int32 product and
// sum), its centre (float(v) + 0.5f) * voxel_size (two roundings: built
// with -fmad=false, so the add and the multiply round as the two torch
// ops do), and the cell's check set to EMPTY where any box holds the
// centre on every axis (lo <= c <= hi; a NaN bound holds nothing). Every
// other cell is left untouched (masked-fill semantics).
//
// Bound on an H100: the work reads slot_key (12 B a slot) and the boxes
// and writes 4 B per killed cell; by the per-axis split below it needs 24
// axis centres a slot (3 operations each) and two compares of each
// against each box, (3 + 2 B) x 24 operations a slot. At the shipped
// 16384 slots the bytes bind for a few boxes (~0.06 us), far below one
// launch, so the kernel is held by its launch and by the latency of its
// chain: a slot's key, then its centres, then the boxes. chip_smoke.py
// counts the bound from its inputs.
//
// Design: one wave of 128-thread blocks (at most the SM count x 8, the
// blocks an SM holds at these launch bounds), striding over the slots 32
// at a time (512 blocks at the shipped 16384 slots). Each block copies the
// boxes (up to 256 at a time; more go in turns) and the voxel size into
// shared memory once. A cell (i, j, k) of a tile lies in box b iff offset
// i's centre lies in b on x, j's on y and k's on z. The test: warp 0 takes
// 32 slots, a lane per slot; each lane loads its slot's key (coalesced, 12
// B a slot), computes its 24 per-axis centres in registers and, box by
// box, whether each axis has an offset inside (the three 8-bit axis masks
// being non-zero); a slot that some box holds on all three axes is hit.
// The test is exact, cell for cell, and needs no monotonicity of the
// centre in v. A ballot lists the hit slots in shared memory, and the
// block's four warps clear them, a slot a warp in turn: lanes 0-23 take
// the slot's 24 centres, one ballot a box gives the box's three axis
// masks, and lane l writes EMPTY into each of its cells l + 32 r (r =
// 0..15: i = r / 2, j = l / 8 + 4 (r % 2), k = l % 8) that a box holds:
// coalesced 4-byte stores of the killed cells only. A slot no box holds is
// neither read nor written past its key. Why four warps for the writes of
// 32 slots: a box over the origin's tile hits every slot no insert has
// taken (their keys are 0), and each such slot's 512 cells are written
// (EMPTY over EMPTY, as the torch code's masked fill writes them): 33.5
// MB at 16384 slots. A warp clearing its own 32 hit slots in turn left
// the stores too few to fill the card's memory rate; shared by a block's
// four warps (8 slots each at most) they reach it, while the test keeps a
// lane a slot.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int SLOTS = 32;          // slots a block tests at a time: warp 0's lanes
constexpr int BLOCKS_PER_SM = 8;   // held by the launch bounds (64 registers)
constexpr int BOX_CAP = 256;       // boxes staged at once
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float centre(int32_t key, int ofs, float vs) {
  const int32_t v = (int32_t)((uint32_t)key * 8u + (uint32_t)ofs);
  return ((float)v + 0.5f) * vs;
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) tiled_delete_boxes_kernel(
    const int32_t* __restrict__ slot_key, const float* __restrict__ voxel_size,
    const float* __restrict__ lo, const float* __restrict__ hi, int n_boxes, int T,
    int32_t empty_check, int32_t* __restrict__ cell_check) {
  __shared__ float s_lo[3 * BOX_CAP], s_hi[3 * BOX_CAP];
  __shared__ float s_vs;
  __shared__ int s_slot[SLOTS];        // the hit slots, in slot order
  __shared__ int32_t s_key[SLOTS][3];  // and their keys
  __shared__ int s_nhit;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool staged = n_boxes <= BOX_CAP;  // all boxes in shared memory for the launch
  if (t == 0) s_vs = voxel_size[0];
  if (staged)
    for (int i = t; i < 3 * n_boxes; i += THREADS) {
      s_lo[i] = lo[i];
      s_hi[i] = hi[i];
    }
  __syncthreads();
  const float vs = s_vs;
  const int axis = lane >> 3, ofs = lane & 7;  // the write pass: lane l < 24's centre
  const int j0 = lane >> 3, k = lane & 7;      // and its cells

  for (int base = blockIdx.x * SLOTS; base < T; base += gridDim.x * SLOTS) {  // block-uniform
    // the test, warp 0 a lane per slot: a box holds a cell of the slot iff
    // each of its axis masks is non-zero
    const int slot = base + lane;
    int32_t key[3] = {0, 0, 0};
    float c[3][8];
    if (warp == 0 && slot < T)
      for (int a = 0; a < 3; ++a) key[a] = slot_key[3 * slot + a];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int o = 0; o < 8; ++o) c[a][o] = centre(key[a], o, vs);
    bool hit = false;
    for (int b0 = 0; b0 < n_boxes; b0 += BOX_CAP) {
      const int nb = min(BOX_CAP, n_boxes - b0);
      if (!staged) {
        __syncthreads();
        for (int i = t; i < 3 * nb; i += THREADS) {
          s_lo[i] = lo[3 * b0 + i];
          s_hi[i] = hi[3 * b0 + i];
        }
        __syncthreads();
      }
      for (int b = 0; warp == 0 && b < nb && !hit; ++b) {
        bool all = true;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float l = s_lo[3 * b + a], h = s_hi[3 * b + a];
          bool any = false;
#pragma unroll
          for (int o = 0; o < 8; ++o) any |= c[a][o] >= l && c[a][o] <= h;
          all &= any;
        }
        hit = all;
      }
    }
    if (warp == 0) {
      hit = hit && slot < T;
      const unsigned m = __ballot_sync(FULL, hit);
      if (hit) {
        const int i = __popc(m & ((1u << lane) - 1u));
        s_slot[i] = slot;
        for (int a = 0; a < 3; ++a) s_key[i][a] = key[a];
      }
      if (lane == 0) s_nhit = __popc(m);
    }
    __syncthreads();

    // the write pass: the block's warps share the hit slots. Lanes 0-23
    // take the slot's 24 centres; one ballot a box gives its axis masks
    const int nhit = s_nhit;
    for (int i = warp; i < nhit; i += WARPS) {
      const float cc = centre(s_key[i][axis < 3 ? axis : 2], ofs, vs);
      uint32_t kill = 0;  // bit r: the lane's cell lane + 32 r
      for (int b = 0; b < n_boxes; ++b) {
        bool in = false;
        if (lane < 24) {
          const int q = 3 * b + axis;
          const float l = staged ? s_lo[q] : lo[q], h = staged ? s_hi[q] : hi[q];
          in = cc >= l && cc <= h;
        }
        const uint32_t mb = __ballot_sync(FULL, in);
        const uint32_t mx = mb & 0xffu, my = (mb >> 8) & 0xffu, mz = (mb >> 16) & 0xffu;
        if (!mx || !my || !mz || !((mz >> k) & 1u)) continue;  // no cell of this lane
        const uint32_t y0 = (my >> j0) & 1u, y1 = (my >> (j0 + 4)) & 1u;
#pragma unroll
        for (int x8 = 0; x8 < 8; ++x8) {
          const uint32_t x = (mx >> x8) & 1u;
          kill |= (x & y0) << (2 * x8);
          kill |= (x & y1) << (2 * x8 + 1);
        }
      }
      int32_t* cells = cell_check + (size_t)s_slot[i] * 512;
#pragma unroll
      for (int r = 0; r < 16; ++r)
        if ((kill >> r) & 1u) cells[lane + 32 * r] = empty_check;
    }
    __syncthreads();  // s_slot, s_key and s_nhit are rewritten next
  }
}

}  // namespace

// C interface for ctypes. slot_key (T, 3) int32, voxel_size () f32, the
// boxes lo, hi (n_boxes, 3) f32 and cell_check (T * 512,) int32, written
// in place; all contiguous on the device; sms the device's SM count.
// Writes the grid's block count to *grid_out. Returns the launch's
// cudaError_t (0 = cudaSuccess); T = 0 or n_boxes = 0 launches nothing.
extern "C" int tiled_delete_boxes_launch(const void* slot_key, const void* voxel_size,
                                         const void* lo, const void* hi, void* cell_check,
                                         int n_boxes, int T, int empty_check, int sms,
                                         int* grid_out, void* stream) {
  *grid_out = 0;
  if (T <= 0 || n_boxes <= 0) return 0;
  if (sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int want = (T + SLOTS - 1) / SLOTS;
  const int blocks = want < sms * BLOCKS_PER_SM ? want : sms * BLOCKS_PER_SM;
  *grid_out = blocks;
  tiled_delete_boxes_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(slot_key), static_cast<const float*>(voxel_size),
      static_cast<const float*>(lo), static_cast<const float*>(hi), n_boxes, T,
      (int32_t)empty_check, static_cast<int32_t*>(cell_check));
  return static_cast<int>(cudaGetLastError());
}
