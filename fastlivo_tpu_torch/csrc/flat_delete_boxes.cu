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
// integer sum: each block adds its count to a scratch word and the last
// block to finish (an int ticket) writes the result and puts both words
// back at 0.
//
// Bound on an H100: the bytes. Every slot's check (4 B), each occupied
// slot's point (12 B), the boxes once and 4 B per killed slot: ~5 us at
// 2^20 slots, ~20 us at 2^22 cells, against ~3 + 6 B operations per
// occupied slot. Design: a wave of 256-thread blocks (at most the SM count
// x 8) striding over the slots, a thread a slot: coalesced check reads,
// a point read only where the slot is occupied. The boxes (up to 256 at a
// time, more in turns) are staged in shared memory. csrc/tiled_delete_boxes
// .cu's box test does not carry over: it tests a tile's 8 offsets an axis
// at once, a flat slot holds one centre.

#include <cuda_runtime.h>
#include <stdint.h>

#include "flat_map.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;
constexpr int BOX_CAP = 256;  // boxes staged at once

__global__ void __launch_bounds__(THREADS) flat_delete_boxes_kernel(
    int32_t* __restrict__ check, const float* __restrict__ pts,
    const float* __restrict__ voxel_size, const float* __restrict__ lo,
    const float* __restrict__ hi, const int32_t* __restrict__ count_in,
    int32_t* __restrict__ count_out, int* __restrict__ scratch, int n_boxes, int T,
    int32_t empty) {
  __shared__ float s_lo[3 * BOX_CAP], s_hi[3 * BOX_CAP];
  __shared__ int s_warp[THREADS / 32];
  const int t = threadIdx.x;
  const bool staged = n_boxes <= BOX_CAP;  // all boxes in shared memory for the launch
  const float vs = voxel_size[0];
  if (staged)
    for (int i = t; i < 3 * n_boxes; i += THREADS) {
      s_lo[i] = lo[i];
      s_hi[i] = hi[i];
    }
  __syncthreads();
  int killed = 0;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long base = (long long)blockIdx.x * THREADS; base < T; base += stride) {
    const long long i = base + t;  // block-uniform loop: every thread takes part
    const bool occupied = i < T && check[i] != empty;
    float c[3] = {0.f, 0.f, 0.f};
    if (occupied)
      for (int a = 0; a < 3; ++a) c[a] = flat::centre(flat::voxel(pts[3 * i + a], vs), vs);
    bool kill = false;
    for (int b0 = 0; b0 < n_boxes; b0 += BOX_CAP) {
      const int nb = min(BOX_CAP, n_boxes - b0);
      if (!staged) {
        __syncthreads();
        for (int k = t; k < 3 * nb; k += THREADS) {
          s_lo[k] = lo[3 * b0 + k];
          s_hi[k] = hi[3 * b0 + k];
        }
        __syncthreads();
      }
      for (int b = 0; occupied && !kill && b < nb; ++b) {
        bool in = true;
#pragma unroll
        for (int a = 0; a < 3; ++a) in &= c[a] >= s_lo[3 * b + a] && c[a] <= s_hi[3 * b + a];
        kill = in;
      }
    }
    if (kill) {
      check[i] = empty;
      ++killed;
    }
  }
  // the count: a block sum each; the last block to finish writes count_out
  const int s = flat::block_sum(killed, s_warp);
  if (t == 0) {
    if (s) atomicAdd(&scratch[0], s);
    __threadfence();
    if (atomicAdd(&scratch[1], 1) == (int)gridDim.x - 1) {
      const int total = atomicExch(&scratch[0], 0);
      scratch[1] = 0;
      *count_out = (int32_t)((uint32_t)*count_in - (uint32_t)total);  // int32 wrap, as torch's
    }
  }
}

}  // namespace

// C interface for ctypes. check (T,) int32 (written in place), pts (T, 3)
// f32, voxel_size () f32, the boxes lo, hi (n_boxes, 3) f32, count_in ()
// int32, count_out () int32 (written), scratch 2 int32 zeros (left at 0);
// all contiguous on the device; sms the device's SM count. Writes the
// grid's block count to *grid_out. Returns the launch's cudaError_t (0 =
// cudaSuccess); T = 0 or n_boxes = 0 launches nothing and writes no count.
extern "C" int flat_delete_boxes_launch(void* check, const void* pts, const void* voxel_size,
                                        const void* lo, const void* hi, const void* count_in,
                                        void* count_out, void* scratch, int n_boxes, int T,
                                        int empty_check, int sms, int* grid_out, void* stream) {
  *grid_out = 0;
  if (T <= 0 || n_boxes <= 0) return 0;
  if (sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long want = ((long long)T + THREADS - 1) / THREADS;
  const int blocks = (int)(want < (long long)sms * BLOCKS_PER_SM ? want : sms * BLOCKS_PER_SM);
  *grid_out = blocks;
  flat_delete_boxes_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(check), static_cast<const float*>(pts),
      static_cast<const float*>(voxel_size), static_cast<const float*>(lo),
      static_cast<const float*>(hi), static_cast<const int32_t*>(count_in),
      static_cast<int32_t*>(count_out), static_cast<int*>(scratch), n_boxes, T,
      (int32_t)empty_check);
  return static_cast<int>(cudaGetLastError());
}
