// Phase stamps of the hand-written kernels (csrc/vio_select.cu,
// csrc/vio_observations.cu, csrc/photometric_cascade.cu,
// csrc/lio_cascade.cu), for measurement only: compiled in with
// -DPHASE_STAMPS (scripts/torch_vio_kernels_bench.py,
// scripts/torch_photometric_bench.py and scripts/torch_lio_cascade_bench.py
// build such a variant); without it every macro is empty and the kernels
// are the main path's. A stamped kernel records, in a small device array,
// the earliest block start (slot 0, the minimum of %globaltimer over the
// blocks) and, at each phase boundary k >= 1, the time the last block
// crossed it (the maximum over the blocks, taken by each block's thread 0
// after a __syncthreads). A cascade's iterations stamp their own slots
// (PHASE_STAMP_IT(it, k): boundary k < IT_NPH of iteration it < IT_MAX, at
// IT_BASE + it * IT_NPH + k; later iterations are not recorded), so that
// a reader can sum each phase over the iterations. The library then
// exports `<name>_stamps(host, n)`, which copies the first n stamps of the
// last launch (ns) to the host and resets them. Every stamp must stand
// where the whole block passes.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifdef PHASE_STAMPS

namespace stamps {

constexpr int IT_BASE = 16;  // one-shot boundaries before the iterations' slots
constexpr int IT_MAX = 64;
constexpr int IT_NPH = 8;
constexpr int NSTAMPS = IT_BASE + IT_MAX * IT_NPH;
__device__ unsigned long long stamp_buf[NSTAMPS];

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

}  // namespace stamps

#define PHASE_STAMP_START()                                                         \
  do {                                                                              \
    if (threadIdx.x == 0) atomicMin(&stamps::stamp_buf[0], stamps::globaltimer()); \
  } while (0)
#define PHASE_STAMP(k)                                                              \
  do {                                                                              \
    __syncthreads();                                                                \
    if (threadIdx.x == 0) atomicMax(&stamps::stamp_buf[k], stamps::globaltimer()); \
  } while (0)
#define PHASE_STAMP_IT(it, k)                                                        \
  do {                                                                               \
    __syncthreads();                                                                 \
    if (threadIdx.x == 0 && (it) < stamps::IT_MAX)                                   \
      atomicMax(&stamps::stamp_buf[stamps::IT_BASE + (it) * stamps::IT_NPH + (k)],   \
                stamps::globaltimer());                                              \
  } while (0)
// the exported reader: copies n stamps to `host` and resets them all
// (slot 0 to the largest value, the rest to 0); returns the cudaError_t
#define PHASE_STAMPS_EXPORT(name)                                                         \
  extern "C" int name##_stamps(unsigned long long* host, int n) {                         \
    if (n < 1 || n > stamps::NSTAMPS) return static_cast<int>(cudaErrorInvalidValue);     \
    cudaError_t e = cudaMemcpyFromSymbol(host, stamps::stamp_buf, n * sizeof(long long)); \
    static unsigned long long reset[stamps::NSTAMPS] = {~0ull};                           \
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(stamps::stamp_buf, reset, sizeof(reset)); \
    return static_cast<int>(e);                                                           \
  }

#else

#define PHASE_STAMP_START() \
  do {                      \
  } while (0)
#define PHASE_STAMP(k) \
  do {                 \
  } while (0)
#define PHASE_STAMP_IT(it, k) \
  do {                        \
  } while (0)
#define PHASE_STAMPS_EXPORT(name)

#endif
