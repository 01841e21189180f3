// The camera frame's voxel dedup of its scan cloud, for Hopper.
//
// Replaces no TPU kernel: it is the port of the jitted XLA code of
// fastlivo_tpu/vio.py::_dedup_voxels (:735-780), whose torch version
// ops/vio_dedup.py::vio_dedup_plain is ~90 ops (four rounds of a
// scatter_reduce_ "amin", gathers and compares, then a cumsum compaction).
// Input: the filtered cloud pg (M, 3) f32 and its mask (M,) u8. Each row's
// 0.5 m voxel key is (int32) floor(p / 0.5) (exact; the cast is
// cvt.rzi.s32.f32, torch's), its hash h = (k0 * 73856093) ^ (k1 *
// 19349663) ^ (k2 * 83492791) in wrapping 32-bit products, masked to TB -
// 1 (TB = 1 << bit_length(M)). In round p = 0..3 every unresolved masked row
// takes the minimum of its row id at slot (h + p) & (TB - 1) of a table
// set to M; then, against the same round's winner w at its slot, a row
// with w == its id is a winner and resolved, one whose winner has the same
// key is resolved, one whose winner has another key contends again at the
// next slot. A masked row is kept if it won or never resolved (a leftover
// after four rounds, a possible duplicate, which the selection tolerates).
// The kept rows' keys are written in row order to vox (max_vox, 3) int32
// with vmask (max_vox,) u8 set, the rows past them zeros: the JAX
// package's bits, and the plain version's.
//
// Design: one block of 1024 threads, rows strided over them. The rows'
// keys (12 B a row), the table (TB ints) and a state byte a row (0
// contending, 1 resolved or masked out, 2 winner) stay in shared memory
// while they fit (M = 8192 shipped: 96 + 64 + 8 KB; up to SMEM_BYTES),
// past that in the stream's scratch (global memory, the same layout; the
// launch sets it back to 0 at its end). A round is three block barriers:
// the table re-set to M, the integer atomicMin of each contender, the
// reads of the winners. The compaction runs over the rows in tiles of 1024
// rows with a block scan of the keep flags (a ballot a warp, the warps'
// counts scanned by warp 0). Integer atomics only: every launch gives the
// same bits.
//
// Bound on an H100: it reads each row's 12 B and mask byte and writes
// max_vox rows of 13 B (~0.05 us at M = 8192); a few tens of integer
// operations a row and round. One SM's barriers and shared-memory round
// trips hold it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "phase_stamps.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int ROUNDS = 4;
constexpr int SMEM_BYTES = 220 * 1024;  // below the H100's 227 KB a block
constexpr uint8_t CONTEND = 0, RESOLVED = 1, WINNER = 2;

struct Args {
  const float* pg;        // (M, 3)
  const uint8_t* mask;    // (M,)
  int* vox;               // (max_vox, 3)
  uint8_t* vmask;         // (max_vox,)
  int* ws;                // scratch: scratch_ints(M) ints, all 0 (unused in shared memory)
  int M, TB, max_vox;
};

// the arrays' bytes: keys, table, state bytes rounded up to ints
__host__ __device__ long long layout_bytes(int M, int TB) {
  return 4LL * (3LL * M + TB + (M + 3) / 4);
}

__device__ __forceinline__ int hash_of(const int* k, int tb_mask) {
  const uint32_t h = static_cast<uint32_t>(k[0]) * 73856093u ^
                     static_cast<uint32_t>(k[1]) * 19349663u ^
                     static_cast<uint32_t>(k[2]) * 83492791u;
  return static_cast<int>(h & static_cast<uint32_t>(tb_mask));
}

template <bool SMEM>
__global__ void __launch_bounds__(THREADS) vio_dedup_kernel(Args a) {
  extern __shared__ int smem[];
  __shared__ int s_warp[WARPS];
  __shared__ int s_base, s_total;
  PHASE_STAMP_START();
  const int M = a.M, TB = a.TB, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int* keys = SMEM ? smem : a.ws;
  int* table = keys + 3 * M;
  uint8_t* st = reinterpret_cast<uint8_t*>(table + TB);

  for (int r = t; r < M; r += THREADS) {
    const float* p = a.pg + 3 * static_cast<size_t>(r);
    keys[3 * r] = static_cast<int>(floorf(p[0] / 0.5f));
    keys[3 * r + 1] = static_cast<int>(floorf(p[1] / 0.5f));
    keys[3 * r + 2] = static_cast<int>(floorf(p[2] / 0.5f));
    st[r] = a.mask[r] ? CONTEND : RESOLVED;
  }
  PHASE_STAMP(1);

  for (int p = 0; p < ROUNDS; ++p) {
    for (int s = t; s < TB; s += THREADS) table[s] = M;
    __syncthreads();
    for (int r = t; r < M; r += THREADS)
      if (st[r] == CONTEND) atomicMin(&table[(hash_of(keys + 3 * r, TB - 1) + p) & (TB - 1)], r);
    __syncthreads();
    for (int r = t; r < M; r += THREADS) {
      if (st[r] != CONTEND) continue;
      const int* k = keys + 3 * r;
      const int w = table[(hash_of(k, TB - 1) + p) & (TB - 1)];  // a contender: w <= r
      if (w == r)
        st[r] = WINNER;
      else if (keys[3 * w] == k[0] && keys[3 * w + 1] == k[1] && keys[3 * w + 2] == k[2])
        st[r] = RESOLVED;
    }
    __syncthreads();
  }
  PHASE_STAMP(2);

  // compaction in row order: tiles of THREADS rows, a block scan each
  if (t == 0) s_base = 0;
  __syncthreads();
  for (int r0 = 0; r0 < M; r0 += THREADS) {
    const int r = r0 + t;
    const bool keep = r < M && st[r] != RESOLVED;  // masked-out rows are RESOLVED
    const unsigned ballot = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {
      const int c = s_warp[lane];
      int incl = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      s_warp[lane] = incl - c;  // exclusive
      if (lane == 31) s_total = incl;
    }
    __syncthreads();
    if (keep) {
      const int rank = s_base + s_warp[warp] + __popc(ballot & ((1u << lane) - 1u));
      if (rank < a.max_vox) {
        a.vox[3 * rank] = keys[3 * r];
        a.vox[3 * rank + 1] = keys[3 * r + 1];
        a.vox[3 * rank + 2] = keys[3 * r + 2];
        a.vmask[rank] = 1;
      }
    }
    __syncthreads();  // every thread has read s_base and s_warp
    if (t == 0) s_base += s_total;
    __syncthreads();
  }
  // the rows past the survivors
  const int kept = min(s_base, a.max_vox);
  for (int r = kept + t; r < a.max_vox; r += THREADS) {
    a.vox[3 * r] = 0;
    a.vox[3 * r + 1] = 0;
    a.vox[3 * r + 2] = 0;
    a.vmask[r] = 0;
  }
  if (!SMEM) {  // the scratch back to 0 for the stream's next launch
    const int n = static_cast<int>(layout_bytes(M, TB) / 4);
    for (int i = t; i < n; i += THREADS) a.ws[i] = 0;
  }
  PHASE_STAMP(3);
}

struct DevInfo {
  int smem_set = -1;
};
constexpr int MAX_DEV = 64;
DevInfo g_dev[MAX_DEV];

}  // namespace

PHASE_STAMPS_EXPORT(vio_dedup)

// The scratch a launch over M rows takes, in int32: none while its arrays
// fit in shared memory, else theirs (keys, table, state bytes), zeroed
// once by the caller and left at 0; -1 for an M the kernel's int indices
// do not hold.
extern "C" int vio_dedup_scratch_ints(int M) {
  if (M < 0 || M >= (1 << 28)) return -1;
  const int TB = M == 0 ? 1 : 1 << (32 - __builtin_clz(static_cast<unsigned>(M)));
  const long long b = layout_bytes(M, TB);
  return b <= SMEM_BYTES ? 0 : static_cast<int>(b / 4);
}

// C interface for ctypes. pg (M, 3) f32, mask (M,) u8; outputs vox
// (max_vox, 3) int32 and vmask (max_vox,) u8; ws vio_dedup_scratch_ints(M)
// int32 zeros (none: may be null); all contiguous on the device. One
// block; max_vox = 0 launches nothing. Writes the grid's block count to
// *grid_out. Returns the launch's cudaError_t (0 = cudaSuccess).
extern "C" int vio_dedup_launch(const void* pg, const void* mask, void* vox, void* vmask,
                                void* ws, int M, int max_vox, int* grid_out, void* stream) {
  *grid_out = 0;
  const int k = vio_dedup_scratch_ints(M);
  if (k < 0 || max_vox < 0 || (k > 0 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (max_vox == 0) return 0;
  const int TB = M == 0 ? 1 : 1 << (32 - __builtin_clz(static_cast<unsigned>(M)));
  Args a{static_cast<const float*>(pg), static_cast<const uint8_t*>(mask),
         static_cast<int*>(vox), static_cast<uint8_t*>(vmask), static_cast<int*>(ws),
         M, TB, max_vox};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *grid_out = 1;
  if (k > 0) {
    vio_dedup_kernel<false><<<1, THREADS, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const int smem = static_cast<int>(layout_bytes(M, TB));
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= MAX_DEV) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > g_dev[dev].smem_set) {  // raised once per device to the largest asked
    e = cudaFuncSetAttribute(vio_dedup_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    g_dev[dev].smem_set = SMEM_BYTES;
  }
  vio_dedup_kernel<true><<<1, THREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
