"""Single-device LIVO positions of the port, to compare two checkouts.

Usage: python scripts/torch_livo_positions.py [--tree DIR] [--device cuda]
           [--small] [--lio] [--save FILE.npz] [--against FILE.npz ...]

Runs chip_smoke.py's per-frame LIVO path (`Config()` at its shipped
capacities with a 640x512 pinhole camera looking at the walls, 6 s of a
seeded SyntheticDataset with 24000-point scans) through the `Pipeline` of
the package in `--tree` (default: this checkout), so that another
checkout, e.g. `git archive` of a parent commit, runs the same input
from the same script. `--small`: chip_smoke.py's livo_cpu_agreement
sizes (a 320x256 camera, 4096-point scans, small capacities), for the
CPU. `--lio`: the same dataset with the camera off (chip_smoke.py's LIO
per-frame path). Prints the frame counts, photometric iterations, visual-map points
and ATE; `--save` keeps the per-frame times and positions; each
`--against` file is compared with this run: the largest position
difference, the first lidar frame that differs and both ATEs, as one
JSON line.
"""
import argparse
import json
import os
import sys

import numpy as np

RCL = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])


def livo_config(small: bool):
    from fastlivo_tpu_torch.config import CameraConfig, CapacityConfig, Config

    cfg = Config()
    W, H, F = 640, 512, 400.0
    if small:
        W, H, F = 320, 256, 200.0
        cfg.grid_size = 32
        cfg.capacity = CapacityConfig(max_points=4096, max_raw_points=8192,
                                      tiled_dir_dims=(32, 32, 16), tiled_pool=1024,
                                      vmap_points=8192, vmap_table_size=1 << 15,
                                      frame_ring=16, max_cands=4096)
    cfg.img_enable = True
    cfg.camera = CameraConfig(width=W, height=H, fx=F, fy=F, cx=(W - 1) / 2.0,
                              cy=(H - 1) / 2.0, d=[0.0, 0.0, 0.0, 0.0])
    cfg.Rcl = RCL.ravel().tolist()
    cfg.Pcl = [0.0, 0.0, 0.0]
    cfg.outlier_threshold = 300.0
    cfg.img_point_cov = 100.0
    return cfg


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="the checkout whose package runs")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--lio", action="store_true", help="the camera off")
    ap.add_argument("--save", default=None)
    ap.add_argument("--against", nargs="*", default=[])
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))

    from fastlivo_tpu_torch import vio as vio_mod
    from fastlivo_tpu_torch.io.synthetic import SyntheticDataset
    from fastlivo_tpu_torch.pipeline import Pipeline

    cfg = livo_config(args.small)
    cfg.img_enable = not args.lio
    cam = cfg.camera
    size = (dict(duration=4.0, points_per_scan=4096, seed=5) if args.small
            else dict(duration=6.0, points_per_scan=24000, seed=0))
    ds = SyntheticDataset(cam_hz=10.0, cam_size=(cam.width, cam.height), cam_f=cam.fx,
                          cam_c=(cam.cx, cam.cy), Rcl=RCL, lidar_noise=0.004, **size)
    pipe = Pipeline(cfg, device=args.device)
    for beg, pts, t_rel in ds.lidar_scans_fast():
        pipe.push_lidar(beg, pts, t_rel)
    for t, acc, gyr in ds.imu_stream():
        pipe.push_imu(t, acc, gyr)
    for t, img in ([] if args.lio else ds.images()):
        pipe.push_img(t, img)
    measure = vio_mod.photometric_err_H
    calls = [0]

    def counted(*a, **k):
        calls[0] += 1
        return measure(*a, **k)

    vio_mod.photometric_err_H = counted
    outs = pipe.spin()
    vio_mod.photometric_err_H = measure
    t = np.array([o.t for o in outs])
    pos = np.array([o.pos for o in outs])
    base = ds.traj.base_pos
    late = t >= ds.traj.t_static + 0.5
    truth = np.array([ds.traj.pose(x)[1] - base for x in t])
    ate = float(np.sqrt(np.mean(np.sum((pos - truth)[late] ** 2, axis=1))))
    n_pts = 0 if args.lio else int(pipe.vio.vmap.n_pts)
    steps = 0 if args.lio else pipe.vio.steps
    print(f"{os.path.abspath(args.tree)}: {len(outs)} lidar frames, {steps} camera "
          f"steps, {calls[0]} photometric iterations, visual map {n_pts} points, "
          f"ATE {ate * 1e3:.4f} mm")
    if args.save:
        np.savez(args.save, t=t, pos=pos, ate=ate, n_pts=n_pts, iters=calls[0])
    for other in args.against:
        o = np.load(other)
        n = min(len(t), len(o["t"]))
        d = np.abs(pos[:n] - o["pos"][:n]).max(axis=1)
        differ = np.nonzero((d != 0.0) | (t[:n] != o["t"][:n]))[0]
        print(json.dumps({"against": other, "frames": [len(t), len(o["t"])],
                          "max_position_difference_mm": float(d.max()) * 1e3,
                          "first_frame_that_differs": int(differ[0]) if len(differ) else None,
                          "ate_mm": [ate * 1e3, float(o["ate"]) * 1e3],
                          "visual_map_points": [n_pts, int(o["n_pts"])],
                          "photometric_iterations": [calls[0], int(o["iters"])]}))


if __name__ == "__main__":
    main()
