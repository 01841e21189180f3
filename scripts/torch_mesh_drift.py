"""How far the port's LIO over a mesh drifts from one device, per frame.

Usage: python scripts/torch_mesh_drift.py [--points 4096] [--duration 5]
           [--frames 24] [--ranks 2 4] [--device cpu]

Replays the first `--frames` frames of a seeded SyntheticDataset (scans
of `--points` points) through a single-device Pipeline and through
`Pipeline(mesh=...)` on gloo ranks (parallel/launch.replay_rank), at the
capacities of tests/test_torch_pipeline.py::small_config. A mesh's only
arithmetic of its own is the grouping of the f32 [HᵀH | Hᵀz] row sums
(rank partials summed in rank order); the EKF's gates can turn that into
a different point set, which feeds back through the map. Prints, per
mesh size, the position difference of every frame (mm), the iteration
counts where they differ, and the largest difference as a JSON line.
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fastlivo_tpu_torch.config import CapacityConfig, Config  # noqa: E402
from fastlivo_tpu_torch.io.synthetic import SyntheticDataset  # noqa: E402
from fastlivo_tpu_torch.parallel.launch import launch, replay_rank  # noqa: E402
from fastlivo_tpu_torch.pipeline import Pipeline  # noqa: E402


def small_config() -> Config:
    cfg = Config()
    cfg.img_enable = False
    cfg.capacity = CapacityConfig(max_points=4096, max_raw_points=8192,
                                  tiled_dir_dims=(32, 32, 16), tiled_pool=1024)
    return cfg


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--points", type=int, default=4096)
    ap.add_argument("--duration", type=float, default=5.0)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--ranks", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--device", default="cpu", help="the ranks' device (gloo)")
    args = ap.parse_args()
    ds = SyntheticDataset(duration=args.duration, points_per_scan=args.points,
                          lidar_noise=0.004, seed=0)
    scans, imu = list(ds.lidar_scans_fast()), list(ds.imu_stream())
    single = Pipeline(small_config(), device=args.device)
    for beg, pts, t_rel in scans:
        single.push_lidar(beg, pts, t_rel)
    for sample in imu:
        single.push_imu(*sample)
    ref = single.spin()[:args.frames + 1]
    t_max = ref[args.frames].t
    scans = [s for s in scans if s[0] < t_max]
    imu = [s for s in imu if s[0] < t_max]
    ref = ref[:args.frames]
    for n in args.ranks:
        got = launch(replay_rank, n, (small_config(), scans, imu, args.device, False),
                     timeout=300, deadline=1800)[0]
        d = np.linalg.norm(got["pos"] - np.array([o.pos for o in ref]), axis=1) * 1e3
        iters = [(i, int(a), o.iters) for i, (a, o) in enumerate(zip(got["iters"], ref))
                 if a != o.iters]
        print(f"mesh {n}: per-frame position difference (mm) {np.round(d, 4).tolist()}")
        print(f"mesh {n}: frames whose iterations differ (frame, mesh, one device) {iters}")
        print(json.dumps({"ranks": n, "points": args.points, "frames": len(d),
                          "max_diff_mm": float(d.max())}))


if __name__ == "__main__":
    main()
