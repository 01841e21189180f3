// The scan voxel filter's key pass, for Hopper.
//
// Replaces no TPU kernel: it is the port of the jitted XLA code of
// fastlivo_tpu/ops/voxel_filter.py::voxel_downsample_device before its
// argsort (:41-52: the finite test, floor(p / leaf), the cast to int64, the
// 3 x 20-bit packing and the invalid marker), whose torch version
// ops/voxel_filter.py::voxel_keys_plain is ~20 ops. One launch, a thread a
// row: row i of pts (n, c) f32 (its first three columns; rows c floats
// apart) with valid[i] u8 gets the packed key
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
// Bound on an H100: it reads 12 B of each row and its valid byte and
// writes 8 B (~0.2 us at the LIO scan's 32768 rows), ~30 integer and
// float operations a row; a launch's latency holds it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "phase_stamps.cuh"

namespace {

constexpr int THREADS = 256;
constexpr long long INVALID = 1LL << 62;
constexpr long long OFF = 1LL << 19;
constexpr long long MASK20 = 0xFFFFF;

// divide: keys floor(p / scale) (the LIO scan's 0-d leaf), else floor(p *
// scale) (the camera cloud's f32 reciprocal of its leaf)
__global__ void __launch_bounds__(THREADS)
    voxel_keys_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ valid,
                      const float* __restrict__ scale, int divide, long long* __restrict__ out,
                      int n, int c) {
  PHASE_STAMP_START();
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < n) {
    const float* p = pts + static_cast<size_t>(i) * c;
    const float x = p[0], y = p[1], z = p[2];
    long long key = INVALID;
    if (valid[i] && isfinite(x) && isfinite(y) && isfinite(z)) {
      const float s = *scale;
      const long long kx = static_cast<long long>(floorf(divide ? x / s : x * s));
      const long long ky = static_cast<long long>(floorf(divide ? y / s : y * s));
      const long long kz = static_cast<long long>(floorf(divide ? z / s : z * s));
      key = ((kx + OFF) & MASK20) << 40 | ((ky + OFF) & MASK20) << 20 | ((kz + OFF) & MASK20);
    }
    out[i] = key;
  }
  PHASE_STAMP(1);
}

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
