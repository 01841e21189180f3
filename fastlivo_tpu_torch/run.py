"""CLI runner: a synthetic dataset through the LiDAR-inertial pipeline.

    python -m fastlivo_tpu_torch.run --synthetic --no-img \\
        [--config avia.yaml] [--duration 8] [--out traj.txt] [--eval]

Runs on CUDA unless `--device cpu` is given. Outputs a TUM trajectory
(t x y z qx qy qz qw, laserMapping.cpp:1738-1748) and per-stage timing.
Without `--config` the built-in `Config()` defaults are used. Rosbag
replay and the camera frame are not ported yet.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .config import Config, load_config
from .logging_util import write_tum
from .pipeline import Pipeline


def run_synthetic(pipe: Pipeline, duration: float, points_per_scan: int = 8192):
    """Feed a SyntheticDataset (LiDAR + IMU) through `pipe`; returns
    (frames, dataset)."""
    from .io.synthetic import SyntheticDataset

    ds = SyntheticDataset(
        duration=duration,
        points_per_scan=points_per_scan,
        lidar_noise=0.004,
        lid_rot=pipe.cfg.extrinsic_R,
        lid_off=pipe.cfg.extrinsic_T,
    )
    for beg, pts, t_rel in ds.lidar_scans_fast():
        pipe.push_lidar(beg, pts, t_rel)
    for t, acc, gyr in ds.imu_stream():
        pipe.push_imu(t, acc, gyr)
    outs = pipe.spin()
    return len(outs), ds


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default=None, help="FAST-LIVO style YAML")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--duration", type=float, default=8.0)
    ap.add_argument("--out", default="trajectory.txt")
    ap.add_argument("--no-img", action="store_true", help="force LIO-only")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on the CPU)")
    ap.add_argument(
        "--eval", action="store_true",
        help="print ATE RMSE vs the known trajectory and position-NEES "
        "filter consistency (eval.py)",
    )
    args = ap.parse_args(argv)
    if not args.synthetic:
        ap.error("only --synthetic input is ported (rosbag replay is not yet)")
    cfg = load_config(args.config) if args.config else Config()
    if not args.no_img and cfg.img_enable:
        ap.error("the camera frame is not ported yet; pass --no-img")
    cfg.img_enable = False

    pipe = Pipeline(cfg, device=args.device)
    pipe.collect_cov = args.eval  # per-frame covariance for NEES
    t0 = time.perf_counter()
    n, ds = run_synthetic(pipe, args.duration)
    wall = time.perf_counter() - t0

    traj = pipe.tum_trajectory()
    if len(traj):
        write_tum(args.out, traj)
    tm = {}
    if pipe.outputs:
        tm = {k: float(np.mean([o.timing[k] for o in pipe.outputs])) * 1e3
              for k in pipe.outputs[0].timing}
    print(f"frames={n} wall={wall:.1f}s device={pipe.device} "
          + " ".join(f"{k}={v:.1f}ms" for k, v in tm.items()))
    if pipe.auto_resets:
        print(f"divergence watchdog fired {pipe.auto_resets}x "
              "(mapping restarted; see capacity.auto_reset_rms)")
    print(f"trajectory: {args.out} ({len(traj)} poses)")
    if args.eval:
        from .eval import evaluate_synthetic

        m = evaluate_synthetic(pipe.outputs, pipe.covs, ds)
        print("eval: " + " ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in m.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
