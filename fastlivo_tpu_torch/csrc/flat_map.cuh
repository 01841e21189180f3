// What the flat maps' write kernels share (csrc/hash_insert.cu,
// csrc/dense_insert.cu, csrc/flat_delete_boxes.cu): the hash map
// (ops/voxel_map.py) and the dense grid (ops/dense_map.py) hold one point a
// slot in the same layout, check (T,) int32 and pts (T, 3) f32. The float
// expressions follow the plain versions' op order, one rounding an op (the
// kernels are built with -fmad=false): a voxel is floor(p / vs) as int32
// (voxel_map.voxel_of: a true division by the device's voxel size), its
// centre (float(k) + 0.5f) * vs, a squared distance x*x + y*y + z*z
// (voxel_map._sq3). Counts are reduced with integer atomics only, so every
// launch gives the same bits. The cooperative launch helper sizes a grid
// that is co-resident, so that grid.sync() is a grid barrier.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace flat {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int32_t voxel(float p, float vs) {
  return (int32_t)floorf(p / vs);  // cvt.rzi.s32.f32, as torch's .to(int32)
}

__device__ __forceinline__ float centre(int32_t k, float vs) {
  return ((float)k + 0.5f) * vs;
}

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return x * x + y * y + z * z;
}

// The block's sum of `v` (blockDim.x a multiple of 32, at most 1024),
// valid in thread 0; every thread of the block must call it.
__device__ __forceinline__ int block_sum(int v, int* s_warp) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // s_warp may still be read from a previous call
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  int s = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += s_warp[w];
  return s;
}

constexpr int MAX_DEV = 64;

// A cooperative launch of `kernel` (args as for cudaLaunchCooperativeKernel)
// with `threads` a block over `want` blocks, capped at the blocks the
// device holds at once (at least one). `resident` caches that cap per
// device (MAX_DEV entries, 0 until queried), one array per kernel. The
// grid size goes to *grid_out.
inline int coop_launch(const void* kernel, int threads, long long want, void** args,
                       int* resident, int* grid_out, cudaStream_t stream) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= MAX_DEV) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    int sms = 0, coop = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    resident[dev] = per_sm * sms;
  }
  const long long cap = resident[dev];
  const int grid = (int)(want < 1 ? 1 : want < cap ? want : cap);
  *grid_out = grid;
  e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(threads), args, 0, stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flat
