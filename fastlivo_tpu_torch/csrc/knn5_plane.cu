// Fused 5-nearest-neighbour selection + centred TLS plane fit on a
// gathered candidate block, for Hopper.
//
// Replaces the TPU kernel fastlivo_tpu/ops/pallas_lio.py::knn5_plane
// (body `_kernel`, the `pl.pallas_call` at line 219), with its
// signature: for each LIO query,
//   squared distance to its M gathered map candidates (missing ones
//   masked to BIG) -> five rounds of min-select, ties to the lowest
//   row -> the centred total-least-squares plane through the five picks
//   (missing picks are zeros and still count as points) -> the gate
//   "normal found and all five picks within `threshold` of the plane".
// The host loop's LIO search calls it under `cache_knn` (lio.host_search,
// over a mesh), on the block gathered once per frame at the prior pose and
// re-ranked at every search; on one card lio_cascade.cu writes that
// block at its first search and re-ranks it itself (knn5_cached_walk.cuh,
// the same selection and fit), and this kernel is its oracle. The searches without a cache walk the map
// themselves (knn5_plane_tiled.cu, knn5_plane_hashed.cu).
//
// Design: a block is one warp and owns the contiguous slab of its 32
// queries: 32*M*12 B of candidates, 32*M mask bytes, 32*12 B of queries.
// Lane 0 stages the slab into shared memory with three TMA 1-D bulk
// copies (cp.async.bulk ... mbarrier::complete_tx::bytes) on one
// mbarrier, so the slab arrives in whole lines instead of a warp load
// touching 32 lines (a thread's rows lie M*12 B from its neighbour's).
// Bulk copies move whole 16-byte chunks between 16-byte aligned
// addresses: every full slab starts on 16 bytes and is a multiple of 16
// long; a ragged last slab's bytes past its last whole chunk (< 16 per
// array) are copied by lanes; inputs whose base is not on 16 bytes are
// read by each thread from device memory. Each thread then selects and
// fits its own query from shared memory (a thread's rows lie an odd
// number of words from its neighbour's: no bank conflicts): the M
// squared distances in registers (M is a template parameter, the loops
// unrolled), five strict-`<` scans over rows 0..M-1 (the lowest row wins
// a tie), the fit of plane_fit.cuh. Built without --use_fast_math (the
// fit needs the accurate acosf/cosf/sqrtf) and with -fmad=false, so every
// product rounds as in the plain PyTorch version
// (ops/knn_plane.py::knn5_plane_plain), which sums in the same order:
// the kernel is bit-exact against it.
//
// At N = 16384 the kernel is one wave (512 one-warp blocks, ~4 per SM):
// the slabs land together, so the gain over reading each thread's rows
// from device memory is the whole-line transfer, not an overlap of one
// block's copy with another's selection. Lane groups selecting from the
// slab (knn5_select.cuh, 4 or 16 lanes a query) were slower: their
// shuffle chain runs after the last row lands. Times on an H100 against
// the thread-per-query kernel that read device memory directly:
// scripts/torch_knn5_bench.py, PERF.md.
//
// Bound on an H100: memory. Per query it reads M*12 candidate bytes,
// M mask bytes and 12 query bytes and writes 16 + 1 + 4 bytes: ~384 B at
// M = 27, ~6.3 MB at N = 16384 -> ~1.9 us at 3.35 TB/s. The arithmetic
// (~500 flops per query) is far below the card's float32 rate.

#include <cuda_runtime.h>
#include <stdint.h>

#include "plane_fit.cuh"
#include "knn5_select.cuh"

namespace {

constexpr float BIG = 3.0e37f;  // a missing row's squared distance
constexpr int W = 32;           // queries (and threads) per block: one warp

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// one bulk copy of `bytes` (a multiple of 16, from and to 16-byte
// aligned addresses) from device memory into shared memory, completing on
// the mbarrier at `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// the bytes of `src` past its last whole 16 (fewer than 16), one per lane
__device__ __forceinline__ void copy_tail(void* dst, const void* src, uint32_t bytes) {
  const uint32_t k = (bytes & ~15u) + threadIdx.x;
  if (k < bytes) static_cast<uint8_t*>(dst)[k] = static_cast<const uint8_t*>(src)[k];
}

template <int M>
constexpr size_t slab_bytes() {
  return 16 + (size_t)W * (M * 12 + 12 + M);  // mbarrier, candidates, queries, masks
}

// one query: its M rows at c (12 B each), masks at f, the query at q;
// the parent-thread selection and fit, written to row i of the outputs
template <int M>
__device__ __forceinline__ void select_fit(const float* c, const uint8_t* f, const float* q,
                                           int i, float threshold, float* __restrict__ pabcd,
                                           uint8_t* __restrict__ plane_ok,
                                           float* __restrict__ nd2_5) {
  const float qx = q[0], qy = q[1], qz = q[2];
  float d2[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    const float dx = c[3 * j + 0] - qx;
    const float dy = c[3 * j + 1] - qy;
    const float dz = c[3 * j + 2] - qz;
    d2[j] = f[j] ? dx * dx + dy * dy + dz * dz : BIG;
  }

  float nx[5], ny[5], nz[5];
  float dmin = BIG;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    dmin = d2[0];
    int pick = 0;
#pragma unroll
    for (int j = 1; j < M; ++j) {
      if (d2[j] < dmin) {
        dmin = d2[j];
        pick = j;
      }
    }
    const bool v = dmin < BIG * 0.5f;
    nx[k] = v ? c[3 * pick + 0] : 0.0f;
    ny[k] = v ? c[3 * pick + 1] : 0.0f;
    nz[k] = v ? c[3 * pick + 2] : 0.0f;
#pragma unroll
    for (int j = 0; j < M; ++j) d2[j] = (j == pick) ? BIG : d2[j];
  }

  // centred TLS plane (all five picks count, missing ones as zeros)
  float ux, uy, uz, d;
  const bool ok = plane5_fit(nx, ny, nz, threshold, ux, uy, uz, d);
  pabcd[4 * i + 0] = ux;
  pabcd[4 * i + 1] = uy;
  pabcd[4 * i + 2] = uz;
  pabcd[4 * i + 3] = d;
  plane_ok[i] = ok ? 1 : 0;
  nd2_5[i] = dmin;
}

template <int M>
__global__ void __launch_bounds__(W) knn5_plane_kernel(
    const float* __restrict__ cand, const uint8_t* __restrict__ found,
    const float* __restrict__ queries, float* __restrict__ pabcd,
    uint8_t* __restrict__ plane_ok, float* __restrict__ nd2_5, int n,
    float threshold, bool bulk) {
  const int t = threadIdx.x;
  const int q0 = blockIdx.x * W;
  const int nq = min(W, n - q0);  // >= 1
  const float* g_cand = cand + (size_t)q0 * M * 3;
  const uint8_t* g_f = found + (size_t)q0 * M;
  const float* g_q = queries + (size_t)q0 * 3;
  if (!bulk) {  // an input not on 16 bytes: each thread reads its own rows
    if (t < nq) {
      select_fit<M>(g_cand + t * M * 3, g_f + t * M, g_q + 3 * t, q0 + t, threshold, pabcd,
                    plane_ok, nd2_5);
    }
    return;
  }

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* s_cand = reinterpret_cast<float*>(smem + 16);
  float* s_q = s_cand + W * M * 3;
  uint8_t* s_f = reinterpret_cast<uint8_t*>(s_q + W * 3);
  // each slab's whole 16-byte chunks by one bulk copy, the rest by lanes
  const uint32_t cb = nq * M * 12, fb = nq * M, qb = nq * 12;
  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                     smem_addr(bar)),
                 "r"((cb & ~15u) + (fb & ~15u) + (qb & ~15u))
                 : "memory");
    bulk_load(s_cand, g_cand, cb & ~15u, bar);  // >= 320 bytes
    if (fb >= 16) bulk_load(s_f, g_f, fb & ~15u, bar);
    if (qb >= 16) bulk_load(s_q, g_q, qb & ~15u, bar);
  }
  copy_tail(s_cand, g_cand, cb);
  copy_tail(s_f, g_f, fb);
  copy_tail(s_q, g_q, qb);
  __syncthreads();
  mbar_wait(bar, 0);
  if (t < nq) {
    select_fit<M>(s_cand + t * M * 3, s_f + t * M, s_q + 3 * t, q0 + t, threshold, pabcd,
                  plane_ok, nd2_5);
  }
}

// Any other M: a thread a query reads its rows from device memory (the
// slab of 32 queries, 52 KB of shared memory at M = 125 already, grows
// with M), streams them in row order into its five nearest (knn5_select.cuh's
// Top5: a strict `<`, the lower row ahead on a tie) and takes them in turn
// (group_merge5 of one lane): the picks and the fifth distance of the
// lowest-row min-select bit for bit, then the same fit.
__global__ void __launch_bounds__(W) knn5_plane_any_kernel(
    const float* __restrict__ cand, const uint8_t* __restrict__ found,
    const float* __restrict__ queries, float* __restrict__ pabcd,
    uint8_t* __restrict__ plane_ok, float* __restrict__ nd2_5, int n, int M,
    float threshold) {
  const int i = blockIdx.x * W + threadIdx.x;
  if (i >= n) return;
  const float qx = queries[3 * (size_t)i + 0], qy = queries[3 * (size_t)i + 1],
              qz = queries[3 * (size_t)i + 2];
  const float* c = cand + (size_t)i * M * 3;
  const uint8_t* f = found + (size_t)i * M;
  Top5 t;
  top5_clear(t);
  for (int j = 0; j < M; ++j) {
    if (!f[j]) continue;
    const float px = c[3 * j + 0], py = c[3 * j + 1], pz = c[3 * j + 2];
    const float dx = px - qx, dy = py - qy, dz = pz - qz;
    top5_push(t, dx * dx + dy * dy + dz * dz, j, px, py, pz);
  }
  float nx[5], ny[5], nz[5];
  const float dmin = group_merge5<1>(t, 0, nx, ny, nz);
  float ux, uy, uz, d;
  const bool ok = plane5_fit(nx, ny, nz, threshold, ux, uy, uz, d);
  pabcd[4 * (size_t)i + 0] = ux;
  pabcd[4 * (size_t)i + 1] = uy;
  pabcd[4 * (size_t)i + 2] = uz;
  pabcd[4 * (size_t)i + 3] = d;
  plane_ok[i] = ok ? 1 : 0;
  nd2_5[i] = dmin;
}

template <int M>
int launch(const float* cand, const uint8_t* found, const float* queries,
           float* pabcd, uint8_t* plane_ok, float* nd2_5, int n, float threshold,
           cudaStream_t stream) {
  constexpr size_t smem = slab_bytes<M>();
  static bool opted_in = false;  // M = 125's 52 KB exceed the default 48 KB
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        knn5_plane_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const bool bulk = ((reinterpret_cast<uintptr_t>(cand) |
                      reinterpret_cast<uintptr_t>(found) |
                      reinterpret_cast<uintptr_t>(queries)) & 15) == 0;
  knn5_plane_kernel<M><<<(n + W - 1) / W, W, bulk ? smem : 0, stream>>>(
      cand, found, queries, pabcd, plane_ok, nd2_5, n, threshold, bulk);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface for ctypes. cand (n, m, 3) f32, found (n, m) bool as u8,
// queries (n, 3) f32; outputs pabcd (n, 4) f32, plane_ok (n,) u8, nd2_5
// (n,) f32; all contiguous on the device. m = (2r+1)^3 >= 1 for any
// radius r >= 0 (27 and 125 through the TMA slabs, any other m from device
// memory). Returns the cudaError_t of the launch (0 = cudaSuccess);
// n = 0 launches nothing.
extern "C" int knn5_plane_launch(const void* cand, const void* found,
                                 const void* queries, void* pabcd,
                                 void* plane_ok, void* nd2_5, int n, int m,
                                 float threshold, void* stream) {
  if (n <= 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  auto* c = static_cast<const float*>(cand);
  auto* f = static_cast<const uint8_t*>(found);
  auto* q = static_cast<const float*>(queries);
  auto* pa = static_cast<float*>(pabcd);
  auto* ok = static_cast<uint8_t*>(plane_ok);
  auto* nd = static_cast<float*>(nd2_5);
  if (m == 27) return launch<27>(c, f, q, pa, ok, nd, n, threshold, s);
  if (m == 125) return launch<125>(c, f, q, pa, ok, nd, n, threshold, s);
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  knn5_plane_any_kernel<<<(n + W - 1) / W, W, 0, s>>>(c, f, q, pa, ok, nd, n, m, threshold);
  return static_cast<int>(cudaGetLastError());
}
