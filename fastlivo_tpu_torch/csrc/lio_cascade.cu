// The LIO iterated EKF of one scan in one launch, on the tiled map, the
// hash map or the dense grid, with or without `cache_knn` (the candidate
// block gathered at the first search and re-ranked at every later one),
// with the TLS plane fit or the reference's, for Hopper.
//
// lio_cascade replaces the device program the JAX package compiles from
// the `jax.lax.while_loop` of fastlivo_tpu/lio.py::lio_update (the loop at
// :256, its body :188-238), whose search runs the TPU kernel
// fastlivo_tpu/ops/pallas_lio.py::knn5_plane (`pl.pallas_call` at :219) on
// the map's candidate block (the JAX package's knn_candidates of the tiled,
// hash or dense map, lio.py:144-173) or on the block gathered once at the
// prior pose under `cache_knn` (:119-133), and with `plane_fit: ref` the
// reference's A·n = -1 fit (:140, :165-173). Each iteration, at the pose
// in force:
//   on an iteration with search_en, the search for every point of the scan
//   in the world frame, walk W a template parameter: the walk of
//   knn5_tiled_walk.cuh on the tiled map, of knn5_hashed_walk.cuh on the
//   hash map or the dense grid (the five nearest); with G (`cache_knn`, a
//   template parameter) the first search, at the start pose, is the walk's
//   gather form, which also writes every row it walks into the candidate
//   block (N, M, 3) f32 and (N, M) u8 (the backend's knn_candidates at
//   that pose: found flags, and points where found), and every later
//   search is knn5_cached_walk.cuh's re-rank of that block; then the plane
//   fit F, a template parameter too (plane_fit.cuh: the centred TLS fit,
//   or the reference's in f64);
//   the gates (laserMapping.cpp:1549-1600; their values are arguments, as
//   lio.py sets them): sel = nd2_5 <= sq_dist_gate & pmask at a search,
//   pd2 = n·p + d, s = 1 - 0.9 |pd2| / |p_body|^(1/2), sel &= plane_ok &
//   s > s_gate, active = sel & |pd2| <= res_gate;
//   the H rows [p_imu × Rᵀn, n] and z = -pd2, and [HᵀH₆ | Hᵀz] as the
//   per-row products h_r·active·[h | z]_c summed in a fixed order
//   (ops/lio_cascade.py::fixed_order_sum): a halving tree over each chunk
//   of 64 rows, then over each group of 64 chunk sums, and so on;
//   the step of ekf_step.cuh fed -Hᵀz (the LIO step's bits) with the LIO
//   convergence thresholds (arguments), and the rematch / stop state machine
//   (laserMapping.cpp:1700-1705; the JAX package's lio.py:233-235).
// After the loop: rot, x, G = K HᵀH₆ of the last iteration, sel, pabcd,
// plane_ok and the iteration count. The plain version is the host loop
// lio.py::lio_loop (its search lio.host_search: knn5_plane_tiled,
// knn5_plane_hashed or, on the block the backend's knn_candidates gathers
// at the start pose in torch ops, knn5_plane; with the reference's fit
// the backend's knn or topk_from_candidates on the block, then
// plane.fit_plane_ref; the gates in torch ops, the same fixed-order sum and
// the step kernel or its plain version). Contract: with the step kernel
// every output bit-equal to that loop's, iterations too.
//
// Bound (chip_smoke.py's lio_cascade_bound_ms): the larger of the bytes
// (the map entries the searches touch; under `cache_knn` those of the
// first search, and the block, 13 B a candidate, written once and read
// at each later search; each point's inputs and outputs, the pose and
// prior, once each) over HBM bandwidth and the operations (the searches',
// ~120 a row each iteration, the f64 steps, and with the reference's fit
// its f64 algebra) over the f32 and f64 rates. Neither counts the
// dependent chain that holds the launch far above it: the chunk trees, a
// grid barrier, the chunk-sum trees and the f64 step, every iteration.
// The block is the caller's scratch, N·M·13 B (5.5 MB at N = 16384, M =
// 27), read again from L2. No grid barrier orders its writes and reads:
// the rows a block owns, and the query and candidate rows of each thread
// (query q0 + tid / L of a pass, rows tid % L, + L, ...), are the same at
// every search, so a thread reads only the block entries it wrote itself,
// with coherent loads (knn5_cached_walk.cuh).
//
// Design: one cooperative, persistent launch
// (cudaLaunchCooperativeKernel) of as many 256-thread blocks as can be
// co-resident, at most one per chunk of 64 rows; block b owns chunks b, b
// + grid, ... for the whole launch and keeps their p_imu, |p_body|^(1/2),
// mask, sel, plane and plane_ok in shared memory across the iterations
// (the while_loop's carry). The walks run L lanes a query (4 at M = 27,
// this library's templated walks; 16 at M = 125, lio_cascade_125.cu's; 16
// at any other M = (2r+1)^3, the walks' generic form, which streams a
// lane's rows into its own five nearest and merges the group's,
// knn5_select.cuh: lio_cascade_any.cu's; each a library built from the
// same kernel, csrc/lio_cascade.cuh), the picks in every lane of the
// group, and every lane fits
// them, so the reference's f64 fit adds no divergence. Each iteration: the block's chunks (while the
// first chunk's gates run, a spare warp forms the step's vec, Log on the
// pose only), their sums into the chunk sums of the iteration's parity,
// and the block whose chunk completes a group of 64 (an int ticket per
// group, taken after a fence and reset by that block) sums the group into
// the group sums; one grid barrier; then every block reads the few group
// sums, reduces them in its own shared memory, runs the step in one
// warp's registers and the state machine in one thread, and so holds the
// same next pose and flags as every other block: no second barrier. The
// chunk and group sums are double-buffered by the iteration's parity, so
// a block that starts iteration i + 1 never writes what a slower block
// still reads of iteration i. Block 0 writes the pose, G and the count.
// No host read and no launch between iterations, so the search pays no
// launch and no host round trip; no float atomics (the integer tickets
// and the grid barrier are the only atomics). Built with -fmad=false:
// every product rounds alone, as in the plain version's torch ops.


#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_mix.cuh"
#include "knn5_select.cuh"
#include "plane_fit.cuh"
#include "knn5_tiled_walk.cuh"
#include "knn5_hashed_walk.cuh"
#include "knn5_cached_walk.cuh"
#include "so3.cuh"
#include "ekf_step.cuh"
#include "phase_stamps.cuh"
#include "lio_cascade.cuh"
