// The hash map's insert (`map_backend: hash`, ops/voxel_map.py) for
// Hopper: two cooperative launches and no sort, the table written in place.
//
// Replaces no TPU kernel: it is the port of the jitted XLA code of
// fastlivo_tpu/ops/voxel_map.py::insert (:131-189), whose torch version
// ops/voxel_map.py::insert_plain sorts the batch with four stable argsorts
// (jnp.lexsort((d2c, k0, k1, k2))) and then runs `max_probe` rounds of ~15
// ops, each with two duplicate-index scatters over (T + 1,) int64 arrays.
// The lexsort's order matters in exactly two places, and neither needs a
// total order of the batch:
//   (a) the head of each voxel's run, its row with the least (d2c bits,
//       row) (an invalid row carries d2c = BIG, so it heads a voxel only
//       where no valid row lies below it, and such a voxel is skipped);
//   (b) a slot contested in one round, by heads of different voxels that
//       claim it empty or rewrite it under their shared 31-bit check: the
//       JAX package's scatter on the CPU keeps the last of them in sorted
//       order, the head last in (k2, k1, k0) order (signed).
//
// hash_insert_keys picks the heads, one cooperative launch, three phases:
//   1. a thread a row: its voxel k = floor(p / vs) (int32), the distance
//      to the voxel centre x*x + y*y + z*z (BIG where invalid) and its
//      bits; the row enters a scratch open-addressed table of S >= 2B
//      entries keyed by the whole voxel (the entry's owner, row + 1, taken
//      by atomicCAS; a row finding another voxel's owner compares the
//      owner's voxel and probes on), and takes a 64-bit atomicMax of
//      ~((bits << 32) | row), the entry's least (bits, row): integer
//      atomics only, so the result does not depend on the order of the
//      rows' arrival. Invalid rows that a warp holds together and that
//      share a voxel (a padded batch: ~15000 rows of one voxel at the main
//      path's 16384) send only their lowest row, which carries their
//      least (bits, row) as they share d2c = BIG (__match_any_sync):
//      with every such row on the entry's atomics an H100 spent ~13 of
//      the launch's ~19 us in this phase;
//   2. after a grid barrier, a valid row whose entry names it is its
//      voxel's head; the heads are written compactly in row order by a
//      block scan and decoupled look-back over the tiles (lookback.cuh):
//      heads (7, B) int32, [row, k0, k1, k2, probe slot, 31-bit check, d2c
//      bits] (voxel_map._slot_check's slot and check, the mix of
//      hash_mix.cuh), and their count;
//   3. after a second grid barrier, each entry's owner and the tiles'
//      status words go back to 0.
//
// hash_insert_probe runs every probe round over the compact heads, one
// cooperative launch with one grid barrier a round. The phase after
// barrier r - 1 first settles round r - 1 and then plays round r:
//   - a head that took a ticket in round r - 1 reads its slot's ticket,
//     final since the barrier: the holder writes the check (a claim) and
//     its point; a claimer won if it holds the ticket or if the holder's
//     check is its own (the JAX package's read-back: two voxels with one
//     check both win), and count += won; a claimer that lost goes on, the
//     others are done, as is a head that found its own check;
//   - round r: the head's slot s is read as round r - 1 left it: where s
//     holds a round r - 1 ticket, its holder's point and (for a slot read
//     empty, the holder's write not landed yet) its check stand there,
//     whether the holder has written them yet or not; elsewhere nothing
//     writes s in this phase. An empty slot is claimed; a slot holding the
//     head's check is rewritten where the head lies nearer its voxel
//     centre than the stored point. Claimers and writers of s take a
//     64-bit ticket in the round's parity half, ((r + 1) << 32) | head, by
//     an atomicCAS loop that keeps the head last in (k2, k1, k0) order (a
//     ticket of another round counts as empty): deterministic, as only
//     the order of the contenders decides.
// So the claim's read-back of the sorted version needs no barrier of its
// own. The rounds stop once no head is live; a head still live after
// max_probe rounds is dropped. At the end each head zeroes the ticket
// words of its rounds, and the last block to finish the round counts. The
// heads' round state lives in a per-call array; the tickets, round counts
// and the keys' table in the stream's zeroed scratch, left at 0.
//
// Bound on an H100: the bytes (each row's inputs, the heads written and
// read, the probed and written slots, once each), a few us; what holds the
// launches above it is the chain of grid barriers (two in the keys launch,
// one a round in the probe launch). Built with -DPHASE_STAMPS
// (csrc/phase_stamps.cuh; scripts/torch_lidar_frame_ab.py --stamps) the
// probe launch stamps each round's phase and barrier, and the keys launch
// its three phases and two barriers (stamps 3-7), each launched alone.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_mix.cuh"
#include "flat_map.cuh"
#include "lookback.cuh"
#include "phase_stamps.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;  // and the rows of a tile of the keys' phase 2
constexpr int NWARP = THREADS / 32;
constexpr float BIG = 1e30f;
// a head's round state: done, or its role in the round just played, and
// in its high bits the number of rounds it took part in
constexpr int DONE = 1, CLAIM = 2, WRITE = 4, MINE = 8, ROUNDS_SHIFT = 4;

struct Keys {
  const float* pts;      // (B, 3) the batch
  const uint8_t* valid;  // (B,)
  const float* voxel_size;
  int32_t* rk;           // (4, B) per call: each row's voxel and table entry
  int32_t* heads;        // (7, B) out: the heads, compact, in row order
  int32_t* nh;           // () out: the number of heads
  unsigned long long* best;  // (S,) scratch, 0: ~((bits << 32) | row), the max
  int32_t* owner;        // (S,) scratch, 0: the entry's voxel, as a row + 1
  unsigned* status;      // (tiles,) scratch, 0: look-back words
  int B, S, mask, tiles;
};

__device__ __forceinline__ uint32_t d2c_bits(const float* p, bool valid, float vs,
                                             int32_t (&k)[3]) {
  float e[3];
  for (int a = 0; a < 3; ++a) {
    k[a] = flat::voxel(p[a], vs);
    e[a] = p[a] - flat::centre(k[a], vs);
  }
  return __float_as_uint(valid ? flat::sq3(e[0], e[1], e[2]) : BIG);
}

__global__ void __launch_bounds__(THREADS) hash_insert_keys_kernel(Keys a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_warp[NWARP];
  __shared__ int s_excl;
  const size_t n = (size_t)a.B;
  const float vs = a.voxel_size[0];
  const long long stride = (long long)gridDim.x * THREADS;
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  PHASE_STAMP_START();

  // 1. every row into the voxel's entry of the scratch table; of the
  // invalid rows of one voxel that a warp holds together (a batch's
  // padding: one voxel) only the lowest enters, for them all (they share
  // d2c = BIG), so that they do not queue on one entry's atomics
  for (long long i = first; i < a.B; i += stride) {
    int32_t k[3];
    const bool valid = a.valid[i] != 0;
    const uint32_t bits = d2c_bits(a.pts + 3 * i, valid, vs, k);
    for (int c = 0; c < 3; ++c) a.rk[c * n + i] = k[c];
    bool enter = true;
    if (!valid) {
      const unsigned act = __activemask();
      const unsigned same =
          __match_any_sync(act, ((unsigned long long)(uint32_t)k[0] << 32) | (uint32_t)k[1]) &
          __match_any_sync(act, k[2]);
      enter = (int)(threadIdx.x & 31) == __ffs(same) - 1;
    }
    int s = -1;
    if (enter) {
      __threadfence();  // the voxel is visible before the row may own an entry
      s = (int)(mix3(k[0], k[1], k[2]) & (uint32_t)(a.S - 1));
      for (;;) {
        const int32_t prev = atomicCAS(a.owner + s, 0, (int32_t)i + 1);
        if (prev == 0) break;
        const size_t j = (size_t)prev - 1;
        if (__ldcg(a.rk + j) == k[0] && __ldcg(a.rk + n + j) == k[1] &&
            __ldcg(a.rk + 2 * n + j) == k[2])
          break;
        s = (s + 1) & (a.S - 1);
      }
      atomicMax(a.best + s, ~(((unsigned long long)bits << 32) | (unsigned long long)i));
    }
    a.rk[3 * n + i] = s;
  }
  PHASE_STAMP(3);
  grid.sync();
  PHASE_STAMP(4);

  // 2. the heads, compact in row order: a tile of THREADS rows a pass
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int tile = blockIdx.x; tile < a.tiles; tile += gridDim.x) {
    const long long i = (long long)tile * THREADS + threadIdx.x;
    bool head = false;
    if (i < a.B && a.valid[i]) {
      const unsigned long long b = ~__ldcg(a.best + __ldcg(a.rk + 3 * n + i));
      head = (uint32_t)b == (uint32_t)i;
    }
    const unsigned m = __ballot_sync(flat::FULL, head);
    if (lane == 0) s_warp[warp] = __popc(m);
    __syncthreads();
    int rank = __popc(m & ((1u << lane) - 1)), H = 0;
    for (int w = 0; w < NWARP; ++w) {
      if (w < warp) rank += s_warp[w];
      H += s_warp[w];
    }
    if (threadIdx.x == 0)
      lookback::store_status(a.status + tile,
                             (tile == 0 ? lookback::FLAG_P : lookback::FLAG_A) | (unsigned)H);
    if (warp == 0) {
      const int excl = tile ? lookback::count_before(a.status, tile) : 0;
      if (lane == 0) {
        s_excl = excl;
        if (tile) lookback::store_status(a.status + tile, lookback::FLAG_P | (unsigned)(excl + H));
        if (tile == a.tiles - 1) *a.nh = excl + H;
      }
    }
    __syncthreads();
    if (head) {
      const size_t h = (size_t)(s_excl + rank);
      const int32_t k0 = a.rk[i], k1 = a.rk[n + i], k2 = a.rk[2 * n + i];
      int32_t k[3];
      const uint32_t bits = d2c_bits(a.pts + 3 * i, true, vs, k);
      const uint32_t z = mix3(k0, k1, k2);
      a.heads[h] = (int32_t)i;
      a.heads[n + h] = k0;
      a.heads[2 * n + h] = k1;
      a.heads[3 * n + h] = k2;
      a.heads[4 * n + h] = (int32_t)(z >> 13) & a.mask;
      a.heads[5 * n + h] = (int32_t)(z & 0x7FFFFFFFu);
      a.heads[6 * n + h] = (int32_t)bits;
    }
    __syncthreads();  // s_warp and s_excl are read before the next tile writes them
  }
  PHASE_STAMP(5);
  grid.sync();
  PHASE_STAMP(6);

  // 3. the scratch back to 0: each entry by its owner, the status words
  for (long long i = first; i < a.B; i += stride) {
    const int s = a.rk[3 * n + i];
    if (s >= 0 && __ldcg(a.owner + s) == (int32_t)i + 1) {
      a.owner[s] = 0;
      a.best[s] = 0ull;
    }
  }
  for (long long t = first; t < a.tiles; t += stride) a.status[t] = 0u;
  PHASE_STAMP(7);
}

struct Probe {
  const float* pts;      // (B, 3) the batch
  const int32_t* heads;  // (7, B) hash_insert_keys' heads
  const int32_t* nh;     // () their number
  const float* voxel_size;
  int32_t* check;        // (T,) in place
  float* mpts;           // (T, 3) in place
  const int32_t* count_in;
  int32_t* count_out;
  int32_t* state;        // (B,) per call
  unsigned long long* tickets;  // (2, T) zeros, left at 0
  int* live;             // (max_probe + 2,) zeros, left at 0: per round, then finished blocks
  int B, T, max_probe;
  int32_t empty;
};

// Whether head a lies after head b in (k2, k1, k0) order (signed): the
// JAX package's sorted order of two different voxels.
__device__ __forceinline__ bool later(const int32_t* heads, size_t n, int a, int b) {
  const int32_t a2 = __ldg(heads + 3 * n + a), b2 = __ldg(heads + 3 * n + b);
  if (a2 != b2) return a2 > b2;
  const int32_t a1 = __ldg(heads + 2 * n + a), b1 = __ldg(heads + 2 * n + b);
  if (a1 != b1) return a1 > b1;
  return __ldg(heads + n + a) > __ldg(heads + n + b);
}

__global__ void __launch_bounds__(THREADS) hash_insert_probe_kernel(Probe a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int s_warp[NWARP];
  const int mask = a.T - 1;
  const size_t n = (size_t)a.B;
  const int32_t* row = a.heads;
  const int32_t *k0 = a.heads + n, *k1 = a.heads + 2 * n, *k2 = a.heads + 3 * n;
  const int32_t *slot0 = a.heads + 4 * n, *chk = a.heads + 5 * n, *d2c = a.heads + 6 * n;
  const long long stride = (long long)gridDim.x * THREADS;
  const long long first = (long long)blockIdx.x * THREADS + threadIdx.x;
  const float vs = a.voxel_size[0];
  const int nh = a.B > 0 ? __ldg(a.nh) : 0;
  PHASE_STAMP_START();
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.count_out = *a.count_in;

  int round = 0;
  for (;; ++round) {
    unsigned long long* prev_t = a.tickets + (size_t)((round + 1) & 1) * a.T;  // round - 1's
    unsigned long long* cur_t = a.tickets + (size_t)(round & 1) * a.T;
    int won = 0, live = 0;
    for (long long p = first; p < nh; p += stride) {
      const int h = (int)p;
      const int st = round == 0 ? 0 : a.state[h];
      if (st & DONE) continue;
      const int32_t c = __ldg(chk + h);
      const int rounds = st >> ROUNDS_SHIFT;
      if (round > 0) {  // round - 1 settled
        bool done = (st & MINE) != 0;
        if (st & (CLAIM | WRITE)) {
          const int s = (__ldg(slot0 + h) + round - 1) & mask;
          const int holder = (int)(uint32_t)__ldcg(prev_t + s);
          bool w = false;
          if (holder == h) {
            if (st & CLAIM) a.check[s] = c;
            const size_t r = (size_t)__ldg(row + h);
            for (int q = 0; q < 3; ++q) a.mpts[3 * (size_t)s + q] = a.pts[3 * r + q];
            w = (st & CLAIM) != 0;
          } else {
            w = (st & CLAIM) && __ldg(chk + holder) == c;
          }
          won += w;
          done = done || w || (st & WRITE);
        }
        if (done) {
          a.state[h] = DONE | (rounds << ROUNDS_SHIFT);
          continue;
        }
      }
      if (round == a.max_probe) {  // out of probes: the head is dropped
        a.state[h] = DONE | (rounds << ROUNDS_SHIFT);
        continue;
      }
      // round's slot as round - 1 left it
      const int s = (__ldg(slot0 + h) + round) & mask;
      int pend = -1;  // the slot's round - 1 ticket holder
      if (round > 0) {
        const unsigned long long t = __ldcg(prev_t + s);
        if ((int)(t >> 32) == round) pend = (int)(uint32_t)t;
      }
      int32_t cur = __ldcg(a.check + s);
      if (pend >= 0 && cur == a.empty) cur = __ldg(chk + pend);
      int role = 0;
      if (cur == a.empty) {
        role = CLAIM;
      } else if (cur == c) {
        role = MINE;
        float sp[3];
        if (pend >= 0) {
          const size_t r = (size_t)__ldg(row + pend);
          for (int q = 0; q < 3; ++q) sp[q] = __ldg(a.pts + 3 * r + q);
        } else {
          for (int q = 0; q < 3; ++q) sp[q] = __ldcg(a.mpts + 3 * (size_t)s + q);
        }
        const float stored = flat::sq3(sp[0] - flat::centre(__ldg(k0 + h), vs),
                                       sp[1] - flat::centre(__ldg(k1 + h), vs),
                                       sp[2] - flat::centre(__ldg(k2 + h), vs));
        if (__int_as_float(__ldg(d2c + h)) < stored) role |= WRITE;
      }
      if (role & (CLAIM | WRITE)) {  // the ticket: the head last in (k2, k1, k0) keeps it
        const unsigned long long mine =
            ((unsigned long long)(round + 1) << 32) | (unsigned long long)(uint32_t)h;
        unsigned long long t = __ldcg(cur_t + s);
        for (;;) {
          if ((int)(t >> 32) == round + 1 && !later(a.heads, n, h, (int)(uint32_t)t)) break;
          const unsigned long long was = atomicCAS(cur_t + s, t, mine);
          if (was == t) break;
          t = was;
        }
      }
      a.state[h] = role | ((round + 1) << ROUNDS_SHIFT);
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
    if (__ldcg(a.live + round) == 0) break;  // grid-uniform: nothing was played
  }

  // every read of a ticket was before the last barrier: each head zeroes
  // the words of its rounds
  for (long long p = first; p < nh; p += stride) {
    const int h = (int)p;
    const int rounds = a.state[h] >> ROUNDS_SHIFT;
    for (int q = 0; q < rounds; ++q)
      a.tickets[(size_t)(q & 1) * a.T + ((__ldg(slot0 + h) + q) & mask)] = 0ull;
  }
  // the round counts, by the last block to finish (every block read
  // live[round] before it counts itself)
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    int* finished = a.live + a.max_probe + 1;
    if (atomicAdd(finished, 1) == (int)gridDim.x - 1) {
      for (int i = 0; i <= round; ++i) a.live[i] = 0;
      *finished = 0;
    }
  }
  PHASE_STAMP(2);
}

int g_keys_resident[flat::MAX_DEV];
int g_probe_resident[flat::MAX_DEV];

}  // namespace

PHASE_STAMPS_EXPORT(hash_insert)

constexpr int MAX_ROWS = (1 << 28) - 1;  // 7 B int32 words indexable by int

// C interface for ctypes, all pointers contiguous on the device.
// hash_insert_keys_launch: pts (B, 3) f32, valid (B,) bool, voxel_size ()
// f32; rk (4, B) int32 per-call scratch (any values); outputs heads (7, B)
// int32 (the first nh columns: [row, k0, k1, k2, probe slot, check, d2c
// bits] of each voxel's head, in row order) and nh () int32; scratch S +
// S + S + ceil(B / 256) int32 zeros (left at 0; the first 2 S words, 8-byte
// aligned, the table's minima, then its owners, then the look-back words)
// with S a power of two >= 2 B; mask = T - 1. B = 0 launches nothing.
extern "C" int hash_insert_keys_launch(const void* pts, const void* valid,
                                       const void* voxel_size, void* rk, void* heads, void* nh,
                                       void* scratch, int B, int S, int mask, int* grid_out,
                                       void* stream) {
  *grid_out = 0;
  if (B < 0 || B > MAX_ROWS || S < 2 * B || (S & (S - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  Keys a;
  a.pts = static_cast<const float*>(pts);
  a.valid = static_cast<const uint8_t*>(valid);
  a.voxel_size = static_cast<const float*>(voxel_size);
  a.rk = static_cast<int32_t*>(rk);
  a.heads = static_cast<int32_t*>(heads);
  a.nh = static_cast<int32_t*>(nh);
  a.best = static_cast<unsigned long long*>(scratch);
  a.owner = static_cast<int32_t*>(scratch) + 2 * (size_t)S;
  a.status = reinterpret_cast<unsigned*>(a.owner + S);
  a.B = B;
  a.S = S;
  a.mask = mask;
  a.tiles = (B + THREADS - 1) / THREADS;
  void* args[] = {&a};
  return flat::coop_launch((const void*)hash_insert_keys_kernel, THREADS, a.tiles, args,
                           g_keys_resident, grid_out, static_cast<cudaStream_t>(stream));
}

// hash_insert_probe_launch: pts (B, 3) f32, heads (7, B) int32 and nh ()
// int32 (hash_insert_keys'), voxel_size () f32; the table check (T,) int32
// and mpts (T, 3) f32, written in place; count_in () int32; count_out ()
// int32 (written); state (B,) int32 (any values); scratch 4 T + max_probe +
// 2 int32 zeros, 8-byte aligned (left at 0: the two halves of 64-bit
// tickets, then the round counts and a count of finished blocks). T a
// power of two. Launches also at B = 0 (count_out = count_in; nh unread).
// Writes the grid's block count to *grid_out.
extern "C" int hash_insert_probe_launch(const void* pts, const void* heads, const void* nh,
                                        const void* voxel_size, void* check, void* mpts,
                                        const void* count_in, void* count_out, void* state,
                                        void* scratch, int B, int T, int max_probe,
                                        int empty_check, int* grid_out, void* stream) {
  *grid_out = 0;
  if (B < 0 || B > MAX_ROWS || T < 1 || (T & (T - 1)) || max_probe < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Probe a;
  a.pts = static_cast<const float*>(pts);
  a.heads = static_cast<const int32_t*>(heads);
  a.nh = static_cast<const int32_t*>(nh);
  a.voxel_size = static_cast<const float*>(voxel_size);
  a.check = static_cast<int32_t*>(check);
  a.mpts = static_cast<float*>(mpts);
  a.count_in = static_cast<const int32_t*>(count_in);
  a.count_out = static_cast<int32_t*>(count_out);
  a.state = static_cast<int32_t*>(state);
  a.tickets = static_cast<unsigned long long*>(scratch);
  a.live = static_cast<int*>(scratch) + 4 * (size_t)T;
  a.B = B;
  a.T = T;
  a.max_probe = max_probe;
  a.empty = (int32_t)empty_check;
  void* args[] = {&a};
  return flat::coop_launch((const void*)hash_insert_probe_kernel, THREADS,
                           ((long long)B + THREADS - 1) / THREADS, args, g_probe_resident,
                           grid_out, static_cast<cudaStream_t>(stream));
}
