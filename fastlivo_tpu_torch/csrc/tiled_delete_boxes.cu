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
// offset per axis, its centre (float(v) + 0.5f) * voxel_size (two
// roundings: built with -fmad=false, so the add and the multiply round
// as the two torch ops do), and the cell's check set to EMPTY where any
// box holds the centre on every axis (lo <= c <= hi; a NaN bound holds
// nothing). Every other cell is left untouched (masked-fill semantics).
//
// Design: a warp per slot. The cell (i, j, k) of a tile lies in box b iff
// offset i's centre lies in b on x, j's on y and k's on z, so lanes 0-23
// compute the 24 per-axis centres of the tile (8 offsets x 3 axes) and
// test them against box b's bound on their axis; one ballot gives the
// box's three 8-bit axis masks. A box with an empty axis mask holds no
// cell of the tile, and a tile that no box holds is done after B ballots:
// the cells are neither read nor written. Otherwise lane l owns cells
// l + 32 r (r = 0..15), that is i = r / 2, j = l / 8 + 4 (r % 2), k =
// l % 8, and writes EMPTY into each of them that a box holds: coalesced
// 4-byte stores of the killed cells only. The per-axis test is exact,
// cell for cell, and needs no monotonicity of the centre in v.
//
// Bound on an H100: the work reads slot_key (12 B a slot) and the boxes
// and writes 4 B per killed cell; by the per-axis split it needs 24 axis
// centres a slot (3 operations each) and two compares of each against
// each box, (3 + 2 B) x 24 operations a slot. At the shipped 16384 slots
// the bytes bind for a few boxes (~0.06 us), far below one launch, so the
// kernel is bound by its launch and the latency of one slot's warp.
// chip_smoke.py counts both from its inputs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // slots per 256-thread block

__global__ void __launch_bounds__(32 * WARPS) tiled_delete_boxes_kernel(
    const int32_t* __restrict__ slot_key, const float* __restrict__ voxel_size,
    const float* __restrict__ lo, const float* __restrict__ hi, int n_boxes, int T,
    int32_t empty_check, int32_t* __restrict__ cell_check) {
  const int lane = threadIdx.x & 31;
  const int slot = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (slot >= T) return;  // warp-uniform
  const int axis = lane >> 3, ofs = lane & 7;
  float c = 0.0f;
  if (lane < 24) {
    // int32 wrap as the torch code's int32 product and sum
    const int32_t v = (int32_t)((uint32_t)slot_key[3 * slot + axis] * 8u + (uint32_t)ofs);
    c = ((float)v + 0.5f) * voxel_size[0];
  }
  const int j0 = lane >> 3, k = lane & 7;
  uint32_t kill = 0;  // bit r: the lane's cell lane + 32 r
  for (int b = 0; b < n_boxes; ++b) {
    bool in = false;
    if (lane < 24) in = c >= lo[3 * b + axis] && c <= hi[3 * b + axis];
    const uint32_t m = __ballot_sync(0xffffffffu, in);
    const uint32_t mx = m & 0xffu, my = (m >> 8) & 0xffu, mz = (m >> 16) & 0xffu;
    if (!mx || !my || !mz || !((mz >> k) & 1u)) continue;  // no cell of this lane
    const uint32_t y0 = (my >> j0) & 1u, y1 = (my >> (j0 + 4)) & 1u;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t x = (mx >> i) & 1u;
      kill |= (x & y0) << (2 * i);
      kill |= (x & y1) << (2 * i + 1);
    }
  }
  if (!kill) return;
  int32_t* cells = cell_check + (size_t)slot * 512;
#pragma unroll
  for (int r = 0; r < 16; ++r)
    if ((kill >> r) & 1u) cells[lane + 32 * r] = empty_check;
}

}  // namespace

// C interface for ctypes. slot_key (T, 3) int32, voxel_size () f32, the
// boxes lo, hi (n_boxes, 3) f32 and cell_check (T * 512,) int32, written
// in place; all contiguous on the device. Returns the launch's
// cudaError_t (0 = cudaSuccess); T = 0 or n_boxes = 0 launches nothing.
extern "C" int tiled_delete_boxes_launch(const void* slot_key, const void* voxel_size,
                                         const void* lo, const void* hi, void* cell_check,
                                         int n_boxes, int T, int empty_check, void* stream) {
  if (T <= 0 || n_boxes <= 0) return 0;
  const int blocks = (T + WARPS - 1) / WARPS;
  tiled_delete_boxes_kernel<<<blocks, 32 * WARPS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(slot_key), static_cast<const float*>(voxel_size),
      static_cast<const float*>(lo), static_cast<const float*>(hi), n_boxes, T,
      (int32_t)empty_check, static_cast<int32_t*>(cell_check));
  return static_cast<int>(cudaGetLastError());
}
