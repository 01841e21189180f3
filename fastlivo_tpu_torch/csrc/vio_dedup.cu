// The camera frame's voxel dedup of its scan cloud, for Hopper.
//
// Replaces no TPU kernel: it is the port of the jitted XLA code of
// fastlivo_tpu/vio.py::_dedup_voxels (:735-780), whose torch version
// vio.py::_dedup_voxels_plain is ~90 ops (four rounds of a
// scatter_reduce_ "amin", gathers and compares, then a cumsum compaction).
// Input: the filtered cloud pg (M, 3) f32 and its mask (M,) u8. Each row's
// 0.5 m voxel key is (int32) floor(p / 0.5) (exact; the cast is
// cvt.rzi.s32.f32, torch's), its hash h = (k0 * 73856093) ^ (k1 *
// 19349663) ^ (k2 * 83492791) in wrapping 32-bit products, masked to TB -
// 1 (TB = 1 << bit_length(M)). In round p = 0..3 every unresolved masked row
// takes the minimum of its row id at slot (h + p) & (TB - 1); then, against
// the same round's winner w at its slot, a row with w == its id is a
// winner and resolved, one whose winner has the same key is resolved, one
// whose winner has another key contends again at the next slot. A masked
// row is kept if it won or never resolved (a leftover after four rounds, a
// possible duplicate, which the selection tolerates). The kept rows' keys
// are written in row order to vox (max_vox, 3) int32 with vmask (max_vox,)
// u8 set, the rows past them zeros: the JAX package's bits, and the plain
// version's.
//
// Design: one block of 1024 threads; thread t owns the rows k * 1024 + t
// (k < ceil(M / 1024)), so that a warp's loads of pg and of the keys are
// contiguous. The keys (12 B a row) and the table (TB words) stay in shared
// memory while they fit (M = 8192 shipped: 96 + 64 KB; up to SMEM_BYTES),
// past that in the stream's scratch (global memory, the same layout, the
// table read through L2; the launch sets it back to 0 at its end). A
// thread's row states are two bit words in registers, bit k for row k *
// 1024 + t (contending, winner); past 32 rows a thread, in the scratch.
// The table is set once: round p's contenders take atomicMax of ((p + 1)
// << 29) | (2^29 - 1 - row), so a round's entry beats every older one (and
// the table's 0), and among one round's the lowest row wins. Every
// contender wrote its own slot in its round, so it always reads a
// current-round entry: no reset is needed between rounds. A round is two
// block barriers (the atomics, then the reads; the second also asks
// whether any row still contends, and the rounds stop when none does).
// The compaction is one block scan: for each tile k of 1024 rows (row
// order: tile, warp, lane) a ballot gives each warp its kept rows, lane k
// of each warp stores the warp's count of tile k, warp 0 turns the (tile,
// warp) counts into row-order offsets (a lane a tile: the warps' running
// sum, then a shuffle scan over the tiles), and each kept row writes its
// key at its offset plus its rank in its warp's ballot: two barriers for
// up to 32 tiles (M <= 32768), coalesced writes. Not a thread's
// contiguous rows (t * per ..): their keys lie 3 * per words apart, so a
// warp's shared-memory reads of them conflict on a bank gcd(per, 32) ways
// (8 at M = 8192), and its output stores spread over 32 sectors; the
// ballots over strided rows keep both contiguous, and the scan is as
// short. Integer atomics only: every launch gives the same bits.
//
// Bound on an H100: it reads each row's 12 B and mask byte and writes
// max_vox rows of 13 B (~0.05 us at M = 8192); a few tens of integer
// operations a row and round. One SM's barriers and shared-memory round
// trips hold it. Built with -DPHASE_STAMPS the launch stamps the keys, the
// rounds and the compaction.

#include <cuda_runtime.h>
#include <stdint.h>

#include "phase_stamps.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int ROUNDS = 4;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_BYTES = 220 * 1024;  // below the H100's 227 KB a block
constexpr int MAX_M = 1 << 28;          // rows the launch takes: M < MAX_M
constexpr int TAG_SHIFT = 29;           // a table entry: (round + 1) << 29 | (ROW_MASK - row)
constexpr unsigned ROW_MASK = (1u << TAG_SHIFT) - 1u;
static_assert(MAX_M - 1 <= (int)ROW_MASK, "row ids below the round tag");
static_assert((((unsigned long long)ROUNDS << TAG_SHIFT) | ROW_MASK) <= 0xffffffffull,
              "the last round's tag in 32 bits");

struct Args {
  const float* pg;        // (M, 3)
  const uint8_t* mask;    // (M,)
  int* vox;               // (max_vox, 3)
  uint8_t* vmask;         // (max_vox,)
  int* ws;                // scratch: scratch_ints(M) ints, all 0 (unused in shared memory)
  int M, TB, max_vox;
};

__host__ __device__ int rows_a_thread(int M) { return (M + THREADS - 1) / THREADS; }

// the state words past 32 rows a thread: contending and winner, a word a
// thread each 32 rows
__host__ __device__ long long state_ints(int M) {
  const int per = rows_a_thread(M);
  return per > 32 ? 2LL * ((per + 31) / 32) * THREADS : 0;
}

// the shared-memory or scratch arrays' words: keys, table (and state words)
__host__ __device__ long long layout_ints(int M, int TB) { return 3LL * M + TB; }

__device__ __forceinline__ unsigned slot_of(int k0, int k1, int k2, unsigned tb_mask) {
  const uint32_t h = static_cast<uint32_t>(k0) * 73856093u ^
                     static_cast<uint32_t>(k1) * 19349663u ^
                     static_cast<uint32_t>(k2) * 83492791u;
  return h & tb_mask;
}

// a table entry: from shared memory, or from the scratch through L2, where
// its atomics were performed
template <bool SMEM>
__device__ __forceinline__ unsigned ld_table(const unsigned* p) {
  if constexpr (SMEM) return *p;
  else return __ldcg(p);
}

// One thread's word w of row states (bit j: row (32 w + j) * THREADS + t):
// in registers while a thread has at most 32 rows, else in the scratch
// (only its owner reads and writes it).
template <bool WIDE>
struct States {
  unsigned* mem;  // WIDE: [2][words][THREADS]
  unsigned c0 = 0, w0 = 0;
  int words;
  __device__ unsigned contend(int w, int t) const {
    if constexpr (WIDE) return mem[(size_t)w * THREADS + t];
    else return c0;
  }
  __device__ unsigned winner(int w, int t) const {
    if constexpr (WIDE) return mem[((size_t)words + w) * THREADS + t];
    else return w0;
  }
  __device__ void set(int w, int t, unsigned c, unsigned win) {
    if constexpr (WIDE) {
      mem[(size_t)w * THREADS + t] = c;
      mem[((size_t)words + w) * THREADS + t] = win;
    } else {
      c0 = c;
      w0 = win;
    }
  }
};

template <bool SMEM, bool WIDE>
__global__ void __launch_bounds__(THREADS) vio_dedup_kernel(Args a) {
  extern __shared__ int smem[];
  __shared__ unsigned s_cnt[32][WARPS + 1];  // [tile][warp] kept counts, then offsets
  __shared__ unsigned s_kept;
  PHASE_STAMP_START();
  const int M = a.M, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = rows_a_thread(M), words = (per + 31) / 32;
  const unsigned tbm = static_cast<unsigned>(a.TB - 1);
  int* keys = SMEM ? smem : a.ws;
  unsigned* table = reinterpret_cast<unsigned*>(keys + 3 * M);
  States<WIDE> st;
  st.mem = table + a.TB;
  st.words = words;

  if (SMEM)  // set once (the scratch's table is 0 already)
    for (int s = t; s < a.TB; s += THREADS) table[s] = 0u;
  if (t == 0) s_kept = 0;
  for (int w = 0; w < words; ++w) {  // the rows' loads issued 8 at a time
    unsigned c = 0;
    const int jn = min(32, per - 32 * w);
#pragma unroll 8
    for (int j = 0; j < jn; ++j) {
      const int r = (32 * w + j) * THREADS + t;
      if (r < M) {
        const float* p = a.pg + 3 * static_cast<size_t>(r);
        const float x = __ldg(p), y = __ldg(p + 1), z = __ldg(p + 2);
        keys[3 * r] = static_cast<int>(floorf(x / 0.5f));
        keys[3 * r + 1] = static_cast<int>(floorf(y / 0.5f));
        keys[3 * r + 2] = static_cast<int>(floorf(z / 0.5f));
        if (__ldg(a.mask + r)) c |= 1u << j;
      }
    }
    st.set(w, t, c, 0u);
  }
  __syncthreads();
  PHASE_STAMP(1);

  for (int p = 0; p < ROUNDS; ++p) {
    const unsigned tag = static_cast<unsigned>(p + 1) << TAG_SHIFT;
    for (int w = 0; w < words; ++w)
      for (unsigned c = st.contend(w, t); c; c &= c - 1u) {
        const int r = (32 * w + __ffs(c) - 1) * THREADS + t;
        const int* k = keys + 3 * r;
        const unsigned s = (slot_of(k[0], k[1], k[2], tbm) + p) & tbm;
        atomicMax(table + s, tag | (ROW_MASK - static_cast<unsigned>(r)));
      }
    if (!SMEM) __threadfence();  // the scratch's atomics performed in L2 before the reads
    __syncthreads();
    unsigned left = 0;
    for (int w = 0; w < words; ++w) {
      unsigned c = st.contend(w, t), win = st.winner(w, t);
      for (unsigned m = c; m; m &= m - 1u) {
        const int j = __ffs(m) - 1, r = (32 * w + j) * THREADS + t;
        const int* k = keys + 3 * r;
        const int k0 = k[0], k1 = k[1], k2 = k[2];
        const unsigned s = (slot_of(k0, k1, k2, tbm) + p) & tbm;
        // this round's entry (the row wrote it): the lowest contender
        const int wr = static_cast<int>(ROW_MASK - (ld_table<SMEM>(table + s) & ROW_MASK));
        if (wr == r) {
          win |= 1u << j;
          c &= ~(1u << j);
        } else {
          const int* kw = keys + 3 * wr;
          if (kw[0] == k0 && kw[1] == k1 && kw[2] == k2)
            c &= ~(1u << j);
        }
      }
      st.set(w, t, c, win);
      left |= c;
    }
    if (!__syncthreads_or(left != 0u)) break;  // also: every read before the next atomics
  }
  PHASE_STAMP(2);

  // compaction in row order, 32 tiles of THREADS rows (a state word) at a time
  for (int w = 0; w < words; ++w) {
    const unsigned keep = st.contend(w, t) | st.winner(w, t);  // leftovers and winners
    const int tiles = min(32, per - 32 * w);
    unsigned mine = 0;
    for (int j = 0; j < tiles; ++j) {
      const unsigned bal = __ballot_sync(FULL, (keep >> j) & 1u);
      if (lane == j) mine = __popc(bal);
    }
    s_cnt[lane][warp] = mine;  // tile (32 w + lane), this warp
    __syncthreads();
    if (warp == 0) {  // lane j: tile j's warps in order, then the tiles in order
      unsigned run = 0;
      for (int v = 0; v < WARPS; ++v) run += s_cnt[lane][v];
      unsigned incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned x = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += x;
      }
      const unsigned base0 = s_kept;
      unsigned off = base0 + incl - run;
      for (int v = 0; v < WARPS; ++v) {
        const unsigned c = s_cnt[lane][v];
        s_cnt[lane][v] = off;
        off += c;
      }
      __syncwarp();
      if (lane == 31) s_kept = base0 + incl;
    }
    __syncthreads();
    for (int j = 0; j < tiles; ++j) {
      const unsigned bal = __ballot_sync(FULL, (keep >> j) & 1u);
      if ((keep >> j) & 1u) {
        const unsigned rank = s_cnt[j][warp] + __popc(bal & ((1u << lane) - 1u));
        if (rank < static_cast<unsigned>(a.max_vox)) {
          const int r = (32 * w + j) * THREADS + t;
          a.vox[3 * rank] = keys[3 * r];
          a.vox[3 * rank + 1] = keys[3 * r + 1];
          a.vox[3 * rank + 2] = keys[3 * r + 2];
          a.vmask[rank] = 1;
        }
      }
    }
    __syncthreads();  // s_cnt and s_kept read before the next word's
  }
  // the rows past the survivors
  const int kept = static_cast<int>(min(s_kept, static_cast<unsigned>(a.max_vox)));
  for (int r = kept + t; r < a.max_vox; r += THREADS) {
    a.vox[3 * r] = 0;
    a.vox[3 * r + 1] = 0;
    a.vox[3 * r + 2] = 0;
    a.vmask[r] = 0;
  }
  if (!SMEM) {  // the scratch back to 0 for the stream's next launch
    const long long n = layout_ints(M, a.TB) + state_ints(M);
    for (long long i = t; i < n; i += THREADS) a.ws[i] = 0;
  }
  PHASE_STAMP(3);
}

struct DevInfo {
  int smem_set = -1;
};
constexpr int MAX_DEV = 64;
DevInfo g_dev[MAX_DEV];

int table_size(int M) {
  return M == 0 ? 1 : 1 << (32 - __builtin_clz(static_cast<unsigned>(M)));
}

}  // namespace

PHASE_STAMPS_EXPORT(vio_dedup)

// The scratch a launch over M rows takes, in int32: none while its keys and
// table fit in shared memory, else theirs (keys, table, and past 32 rows a
// thread the row states), zeroed once by the caller and left at 0; -1 for
// an M of 2^28 rows or more (the round tag's width).
extern "C" int vio_dedup_scratch_ints(int M) {
  if (M < 0 || M >= MAX_M) return -1;
  const int TB = table_size(M);
  const long long n = layout_ints(M, TB);
  return 4 * n <= SMEM_BYTES ? 0 : static_cast<int>(n + state_ints(M));
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
  const int TB = table_size(M);
  Args a{static_cast<const float*>(pg), static_cast<const uint8_t*>(mask),
         static_cast<int*>(vox), static_cast<uint8_t*>(vmask), static_cast<int*>(ws),
         M, TB, max_vox};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *grid_out = 1;
  if (k > 0) {
    if (state_ints(M) > 0)
      vio_dedup_kernel<false, true><<<1, THREADS, 0, s>>>(a);
    else
      vio_dedup_kernel<false, false><<<1, THREADS, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  const int smem = static_cast<int>(4 * layout_ints(M, TB));
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= MAX_DEV) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > g_dev[dev].smem_set) {  // raised once per device to the largest asked
    e = cudaFuncSetAttribute(vio_dedup_kernel<true, false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    g_dev[dev].smem_set = SMEM_BYTES;
  }
  vio_dedup_kernel<true, false><<<1, THREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
