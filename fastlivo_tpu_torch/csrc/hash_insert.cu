// The hash map's insert (`map_backend: hash`, ops/voxel_map.py) for
// Hopper: two launches around a sort, the table written in place.
//
// Replaces no TPU kernel: it is the port of the jitted XLA code of
// fastlivo_tpu/ops/voxel_map.py::insert (:131-189), whose torch version
// ops/voxel_map.py::insert_plain runs four stable argsorts for the lexsort
// and then `max_probe` rounds of ~15 ops, each round with two
// duplicate-index scatters over (T + 1,) int64 arrays and the whole table
// copied twice: ~800 kernels and 1.8 ms of device time a frame at 2^20
// slots.
//
// hash_insert_keys (a thread a row): the voxel k = floor(p / vs) as
// int32, voxel_map._slot_check's probe slot and 31-bit check (the mix of
// csrc/hash_mix.cuh), the distance to the voxel centre x*x + y*y + z*z
// (BIG where the row is invalid), and two int64 sort keys: (k0 << 32) |
// bits(d2c), a non-negative f32's bits ordering like its value, and (k2 <<
// 32) | (k1 ^ 2^31). Two stable sorts, the first key and then the second
// gathered, give jnp.lexsort((d2c, k0, k1, k2))'s order for any int32
// voxel (torch's; between the launches).
//
// hash_insert_probe: every probe round in one cooperative launch, on the
// table in place. A sorted row heads its voxel's run if it is valid and
// its voxel differs from the previous sorted row's. Each round, for every
// head not done: its slot's check is read at the round's start (phase A);
// an empty slot is claimed, and a slot holding the row's own check is
// rewritten where the row lies nearer its voxel centre than the stored
// point (pts read before any of the round's writes). The claimers and
// writers of a slot take an int ticket, atomicMax of (sorted position +
// 1); after a grid barrier (phase B) the ticket's holder, the greatest
// sorted position as the JAX package's duplicate-index scatter on the CPU
// keeps the last row, writes the check (a claim) and the point, and puts
// the ticket back at 0 (a later reader then sees 0, never its own value).
// After the next barrier each claimer reads its slot back: it won if the
// check that stands there is its own (the JAX package's read-back, so two
// voxels with one 31-bit check both win), and count += won. A row is done
// when it won or its slot held its check; the others probe the next slot.
// The rounds stop once no head is live (the rounds left would change
// nothing); a head still live after max_probe rounds is dropped. Rows'
// round state lives in a per-call array, the tickets and per-round live
// counts in the stream's zeroed scratch, left at 0.
//
// Bound on an H100: the bytes (each row's inputs, the probed slots, the
// written slots, once each), a few us; what holds the launch above it is
// the chain of grid barriers, two a round (three to five rounds on the
// main path's frames), and the dependent gathers of a row (its order
// entry, its keys, the slot). Built with -DPHASE_STAMPS
// (csrc/phase_stamps.cuh; scripts/torch_lidar_frame_ab.py --stamps) the
// probe launch stamps its heads, and each round's reads, first barrier,
// writes and second barrier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_mix.cuh"
#include "flat_map.cuh"
#include "phase_stamps.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int KEYS_THREADS = 256;
constexpr int THREADS = 256;
constexpr float BIG = 1e30f;
// a sorted row's round state: done, or this round's role
constexpr int DONE = 1, CLAIM = 2, WRITE = 4, MINE = 8;

__global__ void __launch_bounds__(KEYS_THREADS) hash_insert_keys_kernel(
    const float* __restrict__ pts, const uint8_t* __restrict__ valid,
    const float* __restrict__ voxel_size, int mask, int32_t* __restrict__ rows,
    int64_t* __restrict__ skeys, int B) {
  const int i = blockIdx.x * KEYS_THREADS + threadIdx.x;
  if (i >= B) return;
  const float vs = voxel_size[0];
  int32_t k[3];
  float e[3];
  for (int a = 0; a < 3; ++a) {
    const float p = pts[3 * (size_t)i + a];
    k[a] = flat::voxel(p, vs);
    e[a] = p - flat::centre(k[a], vs);
  }
  const uint32_t z = mix3(k[0], k[1], k[2]);
  const float d2c = valid[i] ? flat::sq3(e[0], e[1], e[2]) : BIG;
  const uint32_t bits = __float_as_uint(d2c);
  const size_t n = (size_t)B;
  rows[i] = k[0];
  rows[n + i] = k[1];
  rows[2 * n + i] = k[2];
  rows[3 * n + i] = (int32_t)(z >> 13) & mask;
  rows[4 * n + i] = (int32_t)(z & 0x7FFFFFFFu);
  rows[5 * n + i] = (int32_t)bits;
  skeys[i] = (int64_t)(((uint64_t)(uint32_t)k[0] << 32) | bits);
  skeys[n + i] = (int64_t)(((uint64_t)(uint32_t)k[2] << 32) | ((uint32_t)k[1] ^ 0x80000000u));
}

struct Probe {
  const float* pts;      // (B, 3) the batch
  const uint8_t* valid;  // (B,)
  const int32_t* rows;   // (6, B) hash_insert_keys' rows
  const int64_t* order;  // (B,) the sorted positions' rows
  const float* voxel_size;
  int32_t* check;        // (T,) in place
  float* mpts;           // (T, 3) in place
  const int32_t* count_in;
  int32_t* count_out;
  int32_t* state;        // (B,) per call
  int* tickets;          // (T,) zeros, left at 0
  int* live;             // (max_probe + 1,) zeros, left at 0
  int B, T, max_probe;
  int32_t empty;
};

__global__ void __launch_bounds__(THREADS) hash_insert_probe_kernel(Probe a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_warp[THREADS / 32];
  const int mask = a.T - 1;
  const size_t n = (size_t)a.B;
  const int32_t *k0 = a.rows, *k1 = a.rows + n, *k2 = a.rows + 2 * n;
  const int32_t *slot0 = a.rows + 3 * n, *chk = a.rows + 4 * n, *d2c = a.rows + 5 * n;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  const float vs = a.voxel_size[0];
  PHASE_STAMP_START();

  // the heads: a valid row whose voxel differs from the previous sorted row's
  for (long long p = first; p < a.B; p += stride) {
    const int64_t r = a.order[p];
    bool head = a.valid[r] != 0;
    if (head && p > 0) {
      const int64_t q = a.order[p - 1];
      head = k0[r] != k0[q] || k1[r] != k1[q] || k2[r] != k2[q];
    }
    a.state[p] = head ? 0 : DONE;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.count_out = *a.count_in;
  PHASE_STAMP(1);

  int round = 0;
  for (;; ++round) {
    // phase A: the last round's claims read back, then this round's slot
    // reads and tickets
    int won = 0, live = 0;
    for (long long p = first; p < a.B; p += stride) {
      const int s = a.state[p];
      if (s & DONE) continue;
      const int64_t r = a.order[p];
      const int32_t c = chk[r];
      if (round > 0) {
        bool w = false;
        if (s & CLAIM) {
          w = __ldcg(a.check + ((slot0[r] + round - 1) & mask)) == c;
          won += w;
        }
        if ((s & MINE) || w) {
          a.state[p] = DONE;
          continue;
        }
      }
      if (round == a.max_probe) continue;  // out of probes: the row is dropped
      const int slot = (slot0[r] + round) & mask;
      const int32_t cur = __ldcg(a.check + slot);
      int role = 0;
      if (cur == a.empty) {
        role = CLAIM;
      } else if (cur == c) {
        role = MINE;
        const float* sp = a.mpts + 3 * (size_t)slot;
        const float stored = flat::sq3(__ldcg(sp) - flat::centre(k0[r], vs),
                                       __ldcg(sp + 1) - flat::centre(k1[r], vs),
                                       __ldcg(sp + 2) - flat::centre(k2[r], vs));
        if (__int_as_float(d2c[r]) < stored) role |= WRITE;
      }
      if (role & (CLAIM | WRITE)) atomicMax(a.tickets + slot, (int)p + 1);
      a.state[p] = role;
      ++live;
    }
    const int sw = flat::block_sum(won, s_warp);
    const int sl = flat::block_sum(live, s_warp);
    if (threadIdx.x == 0) {
      if (sw) atomicAdd(a.count_out, sw);
      if (sl) atomicAdd(a.live + round, sl);
    }
    PHASE_STAMP_IT(round, 0);
    grid.sync();
    PHASE_STAMP_IT(round, 1);
    if (__ldcg(a.live + round) == 0) break;  // grid-uniform

    // phase B: each ticketed slot's holder writes and resets the ticket
    for (long long p = first; p < a.B; p += stride) {
      const int s = a.state[p];
      if (!(s & (CLAIM | WRITE))) continue;
      const int64_t r = a.order[p];
      const int slot = (slot0[r] + round) & mask;
      if (__ldcg(a.tickets + slot) != (int)p + 1) continue;
      a.tickets[slot] = 0;
      if (s & CLAIM) a.check[slot] = chk[r];
      for (int q = 0; q < 3; ++q) a.mpts[3 * (size_t)slot + q] = a.pts[3 * (size_t)r + q];
    }
    PHASE_STAMP_IT(round, 2);
    grid.sync();
    PHASE_STAMP_IT(round, 3);
  }
  grid.sync();  // every block has read live[round]
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i <= round; i += THREADS) a.live[i] = 0;
  PHASE_STAMP(2);
}

int g_resident[flat::MAX_DEV];

}  // namespace

PHASE_STAMPS_EXPORT(hash_insert)

constexpr int MAX_ROWS = (1 << 28) - 1;  // 6 B int32 rows indexable by int

// C interface for ctypes, all pointers contiguous on the device.
// hash_insert_keys_launch: pts (B, 3) f32, valid (B,) bool, voxel_size ()
// f32; outputs rows (6, B) int32 [k0, k1, k2, probe slot, check, d2c bits]
// and skeys (2, B) int64; mask = T - 1. B = 0 launches nothing.
extern "C" int hash_insert_keys_launch(const void* pts, const void* valid,
                                       const void* voxel_size, void* rows, void* skeys,
                                       int B, int mask, void* stream) {
  if (B < 0 || B > MAX_ROWS) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  hash_insert_keys_kernel<<<(B + KEYS_THREADS - 1) / KEYS_THREADS, KEYS_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<const uint8_t*>(valid),
      static_cast<const float*>(voxel_size), mask, static_cast<int32_t*>(rows),
      static_cast<int64_t*>(skeys), B);
  return static_cast<int>(cudaGetLastError());
}

// hash_insert_probe_launch: pts (B, 3) f32, valid (B,) bool, rows (6, B)
// int32 (hash_insert_keys'), order (B,) int64 (the sorted positions'
// rows), voxel_size () f32; the table check (T,) int32 and mpts (T, 3) f32,
// written in place; count_in () int32; count_out () int32 (written);
// state (B,) int32 (any values); scratch T + max_probe + 1 int32 zeros
// (left at 0). T a power of two. Launches also at B = 0 (count_out =
// count_in). Writes the grid's block count to *grid_out.
extern "C" int hash_insert_probe_launch(const void* pts, const void* valid, const void* rows,
                                        const void* order, const void* voxel_size,
                                        void* check, void* mpts, const void* count_in,
                                        void* count_out, void* state, void* scratch, int B,
                                        int T, int max_probe, int empty_check, int* grid_out,
                                        void* stream) {
  *grid_out = 0;
  if (B < 0 || B > MAX_ROWS || T < 1 || (T & (T - 1)) || max_probe < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Probe a;
  a.pts = static_cast<const float*>(pts);
  a.valid = static_cast<const uint8_t*>(valid);
  a.rows = static_cast<const int32_t*>(rows);
  a.order = static_cast<const int64_t*>(order);
  a.voxel_size = static_cast<const float*>(voxel_size);
  a.check = static_cast<int32_t*>(check);
  a.mpts = static_cast<float*>(mpts);
  a.count_in = static_cast<const int32_t*>(count_in);
  a.count_out = static_cast<int32_t*>(count_out);
  a.state = static_cast<int32_t*>(state);
  a.tickets = static_cast<int*>(scratch);
  a.live = static_cast<int*>(scratch) + T;
  a.B = B;
  a.T = T;
  a.max_probe = max_probe;
  a.empty = (int32_t)empty_check;
  void* args[] = {&a};
  return flat::coop_launch((const void*)hash_insert_probe_kernel, THREADS,
                           ((long long)B + THREADS - 1) / THREADS, args, g_resident, grid_out,
                           static_cast<cudaStream_t>(stream));
}
