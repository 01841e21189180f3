// The LIO iterated EKF of one scan in one launch at search radius 2 (M =
// 125 candidates, the templated walks with 16 lanes a query), for Hopper:
// lio_cascade.cu's kernel (csrc/lio_cascade.cuh) at LIO_CASCADE_M 125. A
// library of its own, so that its 12 instances build beside lio_cascade.cu's
// (M = 27) and lio_cascade_any.cu's; the same C entry points, which
// ops/lio_cascade.py calls at M = 125. Contract as lio_cascade.cu's.

#define LIO_CASCADE_M 125

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
