// The LIO iterated EKF of one scan in one launch at any search radius past
// the templated walks' (M = (2r+1)^3 other than 27 and 125), for Hopper:
// lio_cascade.cu's kernel (csrc/lio_cascade.cuh) with the walks' generic
// form (knn5_tiled_walk_any, knn5_hashed_walk_any, knn5_cached_walk_any:
// a lane streams its rows into its own five nearest, the group merges
// them, knn5_select.cuh), one instance a walk and fit that gathers the
// candidate block or not at run time. A library of its own, so that it
// builds beside lio_cascade.cu's and lio_cascade_125.cu's 12 instances
// each; the same C entry points, which ops/lio_cascade.py calls at any
// other M. Contract as
// lio_cascade.cu's: every output bit-equal to the host loop lio.lio_loop
// with the step kernel, iterations too.

#define LIO_CASCADE_M 0  // any m

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
