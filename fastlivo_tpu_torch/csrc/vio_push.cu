// The camera frame's image-pool push, for Hopper.
//
// Replaces no TPU kernel: it is the port of the jitted XLA code of
// fastlivo_tpu/visual_map.py::push_image (:216-240) with push_slot
// (:191-213) and _live_slot_refs (:126-156), whose torch version
// visual_map.push_image_plain is an index_add_ of every ring entry into R +
// 1 bins (every dead entry on the last one), an R x R age rank, an argmin
// and the image copy. Input: the visual map's observation rings obs_slot,
// obs_fid (NP, KO) int32, its point count n_pts () int32, the pool's frame
// ids img_fid (R,) int32 (updated) and images imgs (R, H, W) u8 or f32
// (one written), the frame img (H, W) f32 and its id fid () int32.
//   refs[s]: the ring entries of rows < n_pts with fid >= 0 whose slot,
//     clamped to [0, R), still holds that fid;
//   rank[s]: the slots j with img_fid[j] < img_fid[s], or equal and j < s;
//   key[s]: -2 where img_fid[s] == fid, else rank[s] where refs[s] == 0,
//     else (min(refs[s], 200) + 1) R + rank[s];
// the slot is the lowest s of the least key (argmin's pick). imgs[slot]
// takes img (a u8 pool round(clamp(img, 0, 255)), rounding half to even:
// rintf, then torch's cast through int64), img_fid[slot] takes fid. The
// plain version's bits.
//
// Design: one cooperative launch, no host read, two forms chosen by the
// launcher (a routing choice between two hand-written forms; either gives
// the plain version's bits).
//
// One grid barrier, at pools up to ONE_R slots (the shipped frame_ring
// 256). Before the barrier each block
//   - stages the pool's ids in shared memory and counts its equal share of
//     the rows below n_pts (read on the device, so dead rows cost nothing)
//     into a shared histogram of R bins, a warp's equal targets summed by
//     __match_any_sync and added by their lowest lane, then adds its
//     nonzero bins into refs in the stream's scratch (integer sums: any
//     order gives the same counts);
//   - forms the age ranks of its share of the slots, which depend on the
//     ids alone (a warp a slot, grid-stride, as the two-barrier form's
//     keys), and stores each beside the slot's count in the scratch (the
//     pair (count, rank) one 8-byte word);
//   - reads its share of the frame (a grid-stride share, four pixels a
//     thread where 16-byte loads align) into registers, converted to the
//     pool's type, up to PRE loads a thread.
// Grid barrier. Then every block reads the R (count, rank) pairs through
// L2 (__ldcg, one 8-byte load a slot), forms all R keys itself and takes
// the least packed (key's order bits) << 32 | slot, so that every block
// finds the same slot with no second barrier; writes its share of the
// image into that slot (the rest of a share past PRE loads read and
// written now); block 0 writes img_fid[slot]; the last block to finish
// reading the pairs (a ticket) zeroes them and the ticket, so the scratch
// the wrapper zeroed once serves every launch. (Every block forming all R
// ranks itself, R^2 compares a block, measured slower than the two
// barriers at R = 256: PERF.md.)
//
// Two grid barriers, past ONE_R slots, where a block's R keys and their
// argmin cost more than a barrier:
//   (a) the counts as above (past STAGE_R slots into the scratch directly,
//       the ids read in place);
//   (b) grid barrier; a warp a slot (grid-stride) counts its rank over the
//       ids and forms its key; each block's least packed key goes into one
//       64-bit word by atomicMax of its complement (the scratch word's 0
//       is then the identity);
//   (c) grid barrier; each block reads the slot, copies its share of the
//       image into imgs[slot], zeroes its share of refs; block 0 writes
//       img_fid[slot]; the last block to read the word sets it and the
//       ticket back to 0.
//
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "phase_stamps.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int STAGE_R = 12288;  // pool slots counted and ids staged in shared memory (96 KB)
constexpr int MAX_BLOCKS_PER_SM = 2;
constexpr int ONE_R = 2048;  // pools the launcher gives the one-barrier form
constexpr int PRE = 4;  // 16-byte image loads a thread held across the barrier
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const int32_t* obs_slot;  // (NP, KO)
  const int32_t* obs_fid;   // (NP, KO)
  const int32_t* n_pts;     // ()
  int32_t* img_fid;         // (R,)
  void* imgs;               // (R, H, W) u8 or f32
  const float* img;         // (H, W)
  const int32_t* fid;       // ()
  unsigned long long* best;  // scratch word 0 (8-byte aligned), 0 at entry
  unsigned* done;           // scratch: blocks that read the word, 0 at entry
  int* refs;                // scratch: (R,) counts or (R, 2) (count, rank), 0 at entry
  int NP, KO, R;
  long long HW;
  int u8, vec;
};

__device__ __forceinline__ uint8_t to_u8(float v) {
  // torch.clamp (NaN kept), torch.round (half to even), then torch's
  // cast to uint8 through int64
  v = v < 0.0f ? 0.0f : v;
  v = v > 255.0f ? 255.0f : v;
  return static_cast<uint8_t>(static_cast<long long>(rintf(v)));
}

template <bool STAGED>
__global__ void __launch_bounds__(THREADS) vio_push_kernel(Args a) {
  extern __shared__ int smem[];  // STAGED: hist (R), ids (R)
  __shared__ unsigned long long s_best[WARPS];
  __shared__ unsigned long long s_slot;
  PHASE_STAMP_START();
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int R = a.R, G = gridDim.x, b = blockIdx.x;
  int* hist = smem;
  int* ids = smem + R;
  const int32_t* fids = STAGED ? ids : a.img_fid;
  if (STAGED) {
    for (int s = t; s < R; s += THREADS) {
      hist[s] = 0;
      ids[s] = a.img_fid[s];
    }
    __syncthreads();
  }

  // (a) this block's share of the live rows' ring entries
  const long long n = min(max(*a.n_pts, 0), a.NP);
  const long long e0 = n * b / G * a.KO, e1 = n * (b + 1) / G * a.KO;
  for (long long base = e0; base < e1; base += THREADS) {
    const long long e = base + t;
    int target = -1;
    if (e < e1) {
      const int f = a.obs_fid[e];
      const int s = min(max(a.obs_slot[e], 0), R - 1);
      if (f >= 0 && fids[s] == f) target = s;
    }
    // the loop's trip count is the block's: every lane of a warp is here
    const unsigned peers = __match_any_sync(FULL, target);
    if (target >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(STAGED ? &hist[target] : &a.refs[target], __popc(peers));
  }
  if (STAGED) {
    __syncthreads();
    for (int s = t; s < R; s += THREADS)
      if (hist[s]) atomicAdd(&a.refs[s], hist[s]);
  }
  PHASE_STAMP(1);
  grid.sync();
  PHASE_STAMP(2);

  // (b) a warp a slot: its age rank and key; the block's least packed key
  const int fid = *a.fid;
  unsigned long long mine = ~0ull;
  const int nwarps = G * WARPS;
  for (int s = b * WARPS + warp; s < R; s += nwarps) {
    const int fs = fids[s];
    int older = 0;
    for (int j = lane; j < R; j += 32) {
      const int fj = fids[j];
      older += (fj < fs) | ((fj == fs) & (j < s));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) older += __shfl_xor_sync(FULL, older, o);
    const int refs = __ldcg(&a.refs[s]);
    // int32 arithmetic wrapping as the plain version's; the sign bit
    // flipped so that unsigned order is signed order
    unsigned key = refs > 0 ? static_cast<unsigned>(min(refs, 200) + 1) * R + older
                            : static_cast<unsigned>(older);
    if (fs == fid) key = static_cast<unsigned>(-2);
    const unsigned long long packed =
        static_cast<unsigned long long>(key ^ 0x80000000u) << 32 | static_cast<unsigned>(s);
    mine = packed < mine ? packed : mine;
  }
  if (lane == 0) s_best[warp] = mine;
  __syncthreads();
  if (t == 0) {
    unsigned long long m = s_best[0];
    for (int w = 1; w < WARPS; ++w) m = s_best[w] < m ? s_best[w] : m;
    if (m != ~0ull) atomicMax(a.best, ~m);
  }
  PHASE_STAMP(3);
  grid.sync();
  PHASE_STAMP(4);

  // (c) the copy, the id, the scratch back to 0
  if (t == 0) {
    s_slot = ~__ldcg(a.best) & 0xffffffffull;
    __threadfence();
    if (atomicAdd(a.done, 1u) == static_cast<unsigned>(G - 1)) {  // every block has read it
      *a.best = 0;
      *a.done = 0;
    }
  }
  for (int s = b * THREADS + t; s < R; s += G * THREADS) a.refs[s] = 0;
  __syncthreads();
  const long long slot = static_cast<long long>(s_slot);
  if (b == 0 && t == 0) a.img_fid[slot] = fid;
  const long long HW = a.HW, stride = static_cast<long long>(G) * THREADS;
  const long long i0 = static_cast<long long>(b) * THREADS + t;
  if (a.u8) {
    uint8_t* dst = static_cast<uint8_t*>(a.imgs) + slot * HW;
    if (a.vec) {
      const float4* src4 = reinterpret_cast<const float4*>(a.img);
      uchar4* dst4 = reinterpret_cast<uchar4*>(dst);
      for (long long i = i0; i < HW / 4; i += stride) {
        const float4 v = __ldg(&src4[i]);
        dst4[i] = make_uchar4(to_u8(v.x), to_u8(v.y), to_u8(v.z), to_u8(v.w));
      }
    } else {
      for (long long i = i0; i < HW; i += stride) dst[i] = to_u8(a.img[i]);
    }
  } else {
    float* dst = static_cast<float*>(a.imgs) + slot * HW;
    if (a.vec) {
      const float4* src4 = reinterpret_cast<const float4*>(a.img);
      float4* dst4 = reinterpret_cast<float4*>(dst);
      for (long long i = i0; i < HW / 4; i += stride) dst4[i] = __ldg(&src4[i]);
    } else {
      for (long long i = i0; i < HW; i += stride) dst[i] = a.img[i];
    }
  }
  PHASE_STAMP(5);
}

// The pool's element type and the 16-byte vector a thread converts.
template <typename T>
struct Pixels;
template <>
struct Pixels<uint8_t> {
  using V = uchar4;
  __device__ __forceinline__ static V of(float4 v) {
    return make_uchar4(to_u8(v.x), to_u8(v.y), to_u8(v.z), to_u8(v.w));
  }
  __device__ __forceinline__ static uint8_t one(float v) { return to_u8(v); }
};
template <>
struct Pixels<float> {
  using V = float4;
  __device__ __forceinline__ static V of(float4 v) { return v; }
  __device__ __forceinline__ static float one(float v) { return v; }
};

// The one-barrier form (see the top), for the pools the launcher gives
// it. Shared memory: hist (R), ids (R). Scratch: (count, rank) pairs.
template <typename T>
__global__ void __launch_bounds__(THREADS) vio_push_one_kernel(Args a) {
  extern __shared__ int smem[];
  __shared__ unsigned long long s_best[WARPS];
  __shared__ unsigned long long s_slot;
  __shared__ int s_last;
  using V = typename Pixels<T>::V;
  PHASE_STAMP_START();
  cg::grid_group grid = cg::this_grid();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int R = a.R, G = gridDim.x, b = blockIdx.x;
  int* hist = smem;
  int* ids = smem + R;
  int2* pairs = reinterpret_cast<int2*>(a.refs);  // (count, rank) a slot
  // this block's share of the live rows' ring entries; its first round's
  // entries loaded while the pool's ids are staged
  const long long n = min(max(*a.n_pts, 0), a.NP);
  for (int s = t; s < R; s += THREADS) {
    hist[s] = 0;
    ids[s] = a.img_fid[s];
  }
  const long long e0 = n * b / G * a.KO, e1 = n * (b + 1) / G * a.KO;
  int ef = -1, eslot = 0;  // an entry's frame id and slot
  if (e0 + t < e1) {
    ef = a.obs_fid[e0 + t];
    eslot = a.obs_slot[e0 + t];
  }
  __syncthreads();
  for (long long base = e0; base < e1; base += THREADS) {
    if (base != e0) {
      const long long e = base + t;
      ef = -1;
      if (e < e1) {
        ef = a.obs_fid[e];
        eslot = a.obs_slot[e];
      }
    }
    int target = -1;
    if (ef >= 0) {
      const int s = min(max(eslot, 0), R - 1);
      if (ids[s] == ef) target = s;
    }
    // the loop's trip count is the block's: every lane of a warp is here
    const unsigned peers = __match_any_sync(FULL, target);
    if (target >= 0 && lane == __ffs(peers) - 1) atomicAdd(&hist[target], __popc(peers));
  }
  __syncthreads();
  for (int s = t; s < R; s += THREADS)
    if (hist[s]) atomicAdd(&pairs[s].x, hist[s]);
  PHASE_STAMP(1);

  // a warp a slot (grid-stride): its age rank, the slots j with ids[j] <
  // ids[s], or equal and j < s, beside its count
  const int nwarps = G * WARPS;
  for (int s = b * WARPS + warp; s < R; s += nwarps) {
    const int fs = ids[s];
    int older = 0;
    for (int j = lane; j < R; j += 32) {
      const int fj = ids[j];
      older += (fj < fs) | ((fj == fs) & (j < s));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) older += __shfl_xor_sync(FULL, older, o);
    if (lane == 0) pairs[s].y = older;
  }
  // this thread's share of the frame, converted, in registers
  const long long HW = a.HW, stride = static_cast<long long>(G) * THREADS;
  const long long i0 = static_cast<long long>(b) * THREADS + t;
  const long long nv = a.vec ? HW / 4 : 0;  // the share in 16-byte loads
  V pre[PRE];
  const float4* src4 = reinterpret_cast<const float4*>(a.img);
#pragma unroll
  for (int k = 0; k < PRE; ++k) {
    const long long i = i0 + k * stride;
    if (i < nv) pre[k] = Pixels<T>::of(__ldg(&src4[i]));
  }
  PHASE_STAMP(6);
  grid.sync();
  PHASE_STAMP(2);

  // every slot's key from its (count, rank); the block's least packed key
  const int fid = *a.fid;
  unsigned long long mine = ~0ull;
  for (int s = t; s < R; s += THREADS) {
    const int2 cr = __ldcg(&pairs[s]);
    // int32 arithmetic wrapping as the plain version's; the sign bit
    // flipped so that unsigned order is signed order
    unsigned key = cr.x > 0 ? static_cast<unsigned>(min(cr.x, 200) + 1) * R + cr.y
                            : static_cast<unsigned>(cr.y);
    if (ids[s] == fid) key = static_cast<unsigned>(-2);
    const unsigned long long packed =
        static_cast<unsigned long long>(key ^ 0x80000000u) << 32 | static_cast<unsigned>(s);
    mine = packed < mine ? packed : mine;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long v = __shfl_xor_sync(FULL, mine, o);
    mine = v < mine ? v : mine;
  }
  if (lane == 0) s_best[warp] = mine;
  __syncthreads();
  if (t == 0) {
    unsigned long long m = s_best[0];
    for (int w = 1; w < WARPS; ++w) m = s_best[w] < m ? s_best[w] : m;
    s_slot = m & 0xffffffffull;
  }
  __syncthreads();
  PHASE_STAMP(3);
  PHASE_STAMP(4);

  // the copy and the id
  const long long slot = static_cast<long long>(s_slot);
  if (b == 0 && t == 0) a.img_fid[slot] = fid;
  T* dst = static_cast<T*>(a.imgs) + slot * HW;
  if (a.vec) {
    V* dst4 = reinterpret_cast<V*>(dst);
#pragma unroll
    for (int k = 0; k < PRE; ++k) {
      const long long i = i0 + k * stride;
      if (i < nv) dst4[i] = pre[k];
    }
    for (long long i = i0 + PRE * stride; i < nv; i += stride)
      dst4[i] = Pixels<T>::of(__ldg(&src4[i]));
  } else {
    for (long long i = i0; i < HW; i += stride) dst[i] = Pixels<T>::one(a.img[i]);
  }
  // the ticket, off the copy's way: the last block to take it (every
  // block has read the pairs) sets the pairs and the ticket back to 0
  if (t == 0) {
    __threadfence();
    s_last = atomicAdd(a.done, 1u) == static_cast<unsigned>(G - 1);
  }
  __syncthreads();
  if (s_last) {
    for (int s = t; s < R; s += THREADS) pairs[s] = make_int2(0, 0);
    if (t == 0) *a.done = 0;
  }
  PHASE_STAMP(5);
}

// The launcher's four kernels: the two-barrier form unstaged and staged,
// the one-barrier form on a u8 and an f32 pool.
constexpr int NFN = 4;
struct DevInfo {
  int coop = -1, sms = 0;
  int smem_set[NFN] = {-1, -1, -1, -1};
  int occ_smem[NFN] = {-1, -1, -1, -1};
  int per_sm[NFN] = {0, 0, 0, 0};
};
constexpr int MAX_DEV = 64;
DevInfo g_dev[MAX_DEV];

}  // namespace

PHASE_STAMPS_EXPORT(vio_push)

// The largest pool the launcher gives the one-barrier form.
extern "C" int vio_push_one_barrier_max_r() { return ONE_R; }

// The scratch a launch over a pool of R slots takes, in int32: the 64-bit
// word, the block count, a pad and R counts (the two-barrier form) or R
// (count, rank) pairs (the one-barrier form), zeroed once by the caller and
// left at 0 by every launch; -1 for an R the kernel does not take.
extern "C" int vio_push_scratch_ints(int R) {
  if (R < 1 || R > (1 << 28)) return -1;
  return 4 + 2 * R;
}

// C interface for ctypes. obs_slot, obs_fid (NP, KO) int32, n_pts ()
// int32, img_fid (R,) int32 (updated), imgs (R, H, W) (one slot written; u8
// != 0: uint8, else f32), img (H, W) f32, fid () int32, scratch
// vio_push_scratch_ints(R) int32 zeros (16-byte aligned; left at 0); all
// contiguous on the device. form: 0 the launcher's choice (one barrier up
// to ONE_R slots, else two), 1 one barrier (up to STAGE_R slots), 2 two
// barriers. blocks: 0 for the form's grid (one block an SM for one
// barrier, two for two), else that many (at most what the card holds at
// once). Writes the grid's block count to *grid_out and
// the form launched to *form_out. Returns the launch's cudaError_t (0 =
// cudaSuccess).
extern "C" int vio_push_launch(const void* obs_slot, const void* obs_fid, const void* n_pts,
                               void* img_fid, void* imgs, const void* img, const void* fid,
                               void* scratch, int NP, int KO, int R, int H, int W, int u8,
                               int form, int blocks, int* grid_out, int* form_out,
                               void* stream) {
  *grid_out = 0;
  *form_out = 0;
  if (form == 0) form = R <= ONE_R ? 1 : 2;
  if (NP < 0 || KO < 0 || vio_push_scratch_ints(R) < 0 || H < 1 || W < 1 || scratch == nullptr ||
      (reinterpret_cast<uintptr_t>(scratch) & 15) || form < 1 || form > 2 ||
      (form == 1 && R > STAGE_R) || blocks < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.obs_slot = static_cast<const int32_t*>(obs_slot);
  a.obs_fid = static_cast<const int32_t*>(obs_fid);
  a.n_pts = static_cast<const int32_t*>(n_pts);
  a.img_fid = static_cast<int32_t*>(img_fid);
  a.imgs = imgs;
  a.img = static_cast<const float*>(img);
  a.fid = static_cast<const int32_t*>(fid);
  int* ws = static_cast<int*>(scratch);
  a.best = reinterpret_cast<unsigned long long*>(ws);
  a.done = reinterpret_cast<unsigned*>(ws + 2);
  a.refs = ws + 4;
  a.NP = NP;
  a.KO = KO;
  a.R = R;
  a.HW = static_cast<long long>(H) * W;
  a.u8 = u8 != 0;
  const long long es = u8 ? 1 : 4;
  a.vec = a.HW % 4 == 0 && (reinterpret_cast<uintptr_t>(img) & 15) == 0 &&
          (reinterpret_cast<uintptr_t>(imgs) & (4 * es - 1)) == 0;

  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= MAX_DEV) return static_cast<int>(cudaErrorInvalidDevice);
  DevInfo& d = g_dev[dev];
  if (d.coop < 0) {
    int coop = 0, sms = 0;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    d.sms = sms;
    d.coop = coop;
  }
  if (!d.coop) return static_cast<int>(cudaErrorNotSupported);
  int k;  // the kernel
  size_t smem;
  const void* fn;
  if (form == 1) {
    k = a.u8 ? 2 : 3;
    smem = 2 * sizeof(int) * static_cast<size_t>(R);
    fn = a.u8 ? (const void*)vio_push_one_kernel<uint8_t> : (const void*)vio_push_one_kernel<float>;
  } else {
    k = R <= STAGE_R ? 1 : 0;
    smem = k ? 2 * sizeof(int) * static_cast<size_t>(R) : 0;
    fn = k ? (const void*)vio_push_kernel<true> : (const void*)vio_push_kernel<false>;
  }
  if (static_cast<int>(smem) > d.smem_set[k]) {
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    d.smem_set[k] = static_cast<int>(smem);
  }
  if (d.occ_smem[k] != static_cast<int>(smem)) {
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    d.per_sm[k] = per_sm;
    d.occ_smem[k] = static_cast<int>(smem);
  }
  // the one-barrier form one block an SM (measured faster than two: its
  // share a block is small, its barrier cheaper), the other two
  const int per_sm = min(d.per_sm[k], form == 1 ? 1 : MAX_BLOCKS_PER_SM);
  if (per_sm < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if (blocks > d.per_sm[k] * d.sms) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int grid = blocks ? blocks : per_sm * d.sms;
  *grid_out = grid;
  *form_out = form;
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(THREADS), args, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
