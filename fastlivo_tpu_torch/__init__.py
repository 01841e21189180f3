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
  - camera.py, visual_map.py, vio.py  the camera frame (VIO).
  - pipeline.py the per-frame orchestrator (LIO and LIVO), with deferred
                readback (readback.py), trace logs and warm start.
  - replay.py   offline replay in blocks, one read per block.
  - serve.py    the socket server (`python -m fastlivo_tpu_torch.serve`).
  - convert.py, io/checkpoint.py  state and maps as numpy arrays / .npz.
  - preprocess.py, features.py, io/rosbag.py, io/lz4.py  bag ingestion.
  - run.py      CLI: `python -m fastlivo_tpu_torch.run --bag run.bag` or
                `--synthetic`.

Conventions: the navigation state and its covariance are float64, point
batches float32. Entry points run on CUDA unless the caller passes
`device="cpu"`; they never fall back to the CPU on their own. The port
runs eagerly; the map is updated in place.
"""

__version__ = "0.1.0"
