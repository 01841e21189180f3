// Phase stamps of the camera frame's kernels (csrc/vio_select.cu,
// csrc/vio_observations.cu), for measurement only: compiled in with
// -DVIO_PHASE_STAMPS (scripts/torch_vio_kernels_bench.py builds such a
// variant); without it every macro is empty and the kernels are the main
// path's. A stamped kernel records, in a small device array, the earliest
// block start (slot 0, the minimum of %globaltimer over the blocks) and,
// at each phase boundary k >= 1, the time the last block crossed it (the
// maximum over the blocks, taken by each block's thread 0 after a
// __syncthreads). The library then exports `<name>_stamps(host, n)`,
// which copies the n stamps of the last launch (ns) to the host and
// resets them. Every VIO_STAMP must stand where the whole block passes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifdef VIO_PHASE_STAMPS

namespace vio {

constexpr int NSTAMPS = 16;
__device__ unsigned long long stamp_buf[NSTAMPS];

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

}  // namespace vio

#define VIO_STAMP_START()                                                    \
  do {                                                                       \
    if (threadIdx.x == 0) atomicMin(&vio::stamp_buf[0], vio::globaltimer()); \
  } while (0)
#define VIO_STAMP(k)                                                         \
  do {                                                                       \
    __syncthreads();                                                         \
    if (threadIdx.x == 0) atomicMax(&vio::stamp_buf[k], vio::globaltimer()); \
  } while (0)
// the exported reader: copies n stamps to `host` and resets them (slot 0
// to the largest value, the rest to 0); returns the cudaError_t
#define VIO_STAMPS_EXPORT(name)                                                        \
  extern "C" int name##_stamps(unsigned long long* host, int n) {                      \
    if (n < 1 || n > vio::NSTAMPS) return static_cast<int>(cudaErrorInvalidValue);     \
    cudaError_t e = cudaMemcpyFromSymbol(host, vio::stamp_buf, n * sizeof(long long)); \
    unsigned long long reset[vio::NSTAMPS] = {~0ull};                                  \
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(vio::stamp_buf, reset, sizeof(reset)); \
    return static_cast<int>(e);                                                        \
  }

#else

#define VIO_STAMP_START() \
  do {                    \
  } while (0)
#define VIO_STAMP(k) \
  do {               \
  } while (0)
#define VIO_STAMPS_EXPORT(name)

#endif
