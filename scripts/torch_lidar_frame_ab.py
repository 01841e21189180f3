"""The lidar frame with the LIO cascade against the host loop it replaced,
in turns on one card.

Usage: python scripts/torch_lidar_frame_ab.py [--rounds 3] [--duration 6]

Runs chip_smoke.py's LIO per-frame path (Pipeline(Config()) at the
shipped capacities, camera off, 24000-point scans) and its LIVO per-frame
path (a 640x512 camera), the same recorded datasets every run,
`--rounds` times in each of three arms, in turns: the LIO cascade (one
lio_cascade launch per EKF); the host loop lio.lio_loop with the step
kernel (one knn5_plane_tiled launch per search iteration, the gates and
rows in torch ops, one photometric_step launch and one flag read per
iteration: what a mesh and the other maps run); the host loop with the
f64 step in torch ops (chip_smoke.lio_host_loop, the EKF as it ran before
the cascade). Each run is a fresh pipeline, after one discarded run of
each path. Prints, per run, the steady lidar frame's median and p90 (host
wall of the frame, its stats read included) and the wall per lidar frame
(LIO) or per lidar + camera pair (LIVO), then one JSON line with every
run's numbers and the card's `nvidia-smi` name and power limit.
"""
import argparse
import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--duration", type=float, default=6.0)
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from fastlivo_tpu_torch import lio
    from fastlivo_tpu_torch.config import Config
    from fastlivo_tpu_torch.io.synthetic import SyntheticDataset
    from fastlivo_tpu_torch.pipeline import Pipeline

    if not torch.cuda.is_available():
        raise SystemExit("torch_lidar_frame_ab: needs a CUDA device")
    dev = torch.device("cuda")

    def lio_config():
        cfg = Config()
        cfg.img_enable = False
        return cfg

    data = {"lio": (lio_config, cs.Recorded(SyntheticDataset(
                duration=args.duration, points_per_scan=24000, lidar_noise=0.004, seed=0))),
            "livo": (cs.livo_config, cs.Recorded(cs.livo_dataset(
                cs.livo_config(), duration=args.duration, points_per_scan=24000,
                lidar_noise=0.004, seed=0)))}
    arms = {"cascade": contextlib.nullcontext,
            "host loop, step kernel": lambda: cs.swapped(lio, "cascade_applies",
                                                         lambda *a, **kw: False),
            "host loop, torch step": cs.lio_host_loop}

    def run(path, arm):
        make_cfg, ds = data[path]
        pipe = Pipeline(make_cfg(), device=dev)
        cs.push_all(pipe, ds)
        torch.cuda.synchronize()
        with arms[arm]():
            t0 = time.perf_counter()
            outs = pipe.spin()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        lid = [1e3 * o.timing["total"] for o in outs if o.iters > 0]
        return {"path": path, "ekf": arm, "lidar_median_ms": float(np.median(lid)),
                "lidar_p90_ms": float(np.percentile(lid, 90)),
                "ms_per_frame_or_pair": 1e3 * wall / len(outs), "steady_frames": len(lid)}

    for path in data:  # discarded: each path's first pipeline
        run(path, "cascade")
    runs = []
    for k in range(args.rounds * len(arms)):
        arm = list(arms)[k % len(arms)]
        for path in data:
            r = run(path, arm)
            runs.append(r)
            print(f"run {k} {path}: {arm}: steady lidar frame median {r['lidar_median_ms']:.2f} "
                  f"ms (p90 {r['lidar_p90_ms']:.2f}), {r['ms_per_frame_or_pair']:.2f} ms per "
                  f"{'lidar frame' if path == 'lio' else 'lidar + camera pair'}", flush=True)
            torch.cuda.empty_cache()
    print(json.dumps({"runs": runs, "card": cs.nvidia_smi_line()}))


if __name__ == "__main__":
    main()
