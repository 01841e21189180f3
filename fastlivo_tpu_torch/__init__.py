"""fastlivo_tpu_torch — the LiDAR-inertial odometry framework in PyTorch.

A port of the JAX package `fastlivo_tpu` to PyTorch, for an NVIDIA H100.
It imports torch and numpy only: nothing of JAX and nothing of the JAX
package, whose host modules it keeps its own copies of.

Layout (same module names as the JAX package):
  - device.py   default device, the no-CPU-fallback check, precision.
  - ops/        SO(3), plane fit, f64 gain, voxel filter, the tiled map
                and the fused 5-NN + plane-fit kernel (ops/knn_plane.py,
                CUDA source in csrc/).
  - state.py    the 18-dim navigation state (NamedTuple of tensors).
  - imu.py      IMU init, propagation and scan undistortion.
  - lio.py      the point-to-plane iterated EKF update.
  - frame_step.py  the per-scan step: undistort -> filter -> EKF -> insert.
  - pipeline.py the per-frame orchestrator (LiDAR-inertial path).
  - convert.py  state and maps carried across from numpy arrays.
  - run.py      CLI: `python -m fastlivo_tpu_torch.run --synthetic --no-img`.

Conventions: the navigation state and its covariance are float64, point
batches float32. Entry points run on CUDA unless the caller passes
`device="cpu"`; they never fall back to the CPU on their own. The port
runs eagerly; the map is updated in place.
"""

__version__ = "0.1.0"
