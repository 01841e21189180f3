"""The camera frame's kernels against the code they replaced, in turns on
one card.

Usage: python scripts/torch_camera_frame_ab.py [--rounds 3] [--duration 6]
           [--arms kernels "plain selection" ...]

Runs chip_smoke.py's LIVO per-frame path (Pipeline(Config()) at the
shipped capacities, a 640x512 camera, 24000-point scans, the same
recorded dataset every run) `--rounds` times in each arm, in turns. The
arms: "kernels", the path as it ships (one vio_select, one
photometric_cascade and one vio_observations launch per camera frame);
"plain selection", the selection and the map upkeep as their torch code
(vio.frame_kernels_apply False: select_tracked, select_new_points,
prep_observations, add_observations, add_points, ~2600 launches and four
host reads a frame); "host loop", the photometric cascade as the host
loop it replaced (chip_smoke.photometric_host_loop: one photometric_err_H
launch and the f64 step in torch ops per iteration, two flags read back);
"cascade, synchronised", the cascade followed by a
torch.cuda.synchronize(). The default arms are the first two. Each run
is a fresh pipeline, after one discarded run. Prints, per run, the
camera frame median and p90 (host wall of Vio.update, its stats read
included), the median steady lidar frame and the wall per lidar +
camera pair, then one JSON line with every run's numbers and the card's
`nvidia-smi` name and power limit.
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
    ap.add_argument("--arms", nargs="+", default=["kernels", "plain selection"])
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from fastlivo_tpu_torch import vio
    from fastlivo_tpu_torch.pipeline import Pipeline

    if not torch.cuda.is_available():
        raise SystemExit("torch_camera_frame_ab: needs a CUDA device")
    dev = torch.device("cuda")
    cfg = cs.livo_config()
    ds = cs.Recorded(cs.livo_dataset(cfg, duration=args.duration, points_per_scan=24000,
                                     lidar_noise=0.004, seed=0))

    cascade = vio.photometric_cascade

    def synchronised(*a):
        out = cascade(*a)
        torch.cuda.synchronize()
        return out

    every = {"kernels": contextlib.nullcontext,
             "plain selection": lambda: cs.swapped(vio, "frame_kernels_apply",
                                                   lambda *a, **kw: False),
             "host loop": cs.photometric_host_loop,
             "cascade, synchronised": lambda: cs.swapped(vio, "photometric_cascade",
                                                         synchronised)}
    arms = {a: every[a] for a in args.arms}

    def run(arm):
        pipe = Pipeline(cs.livo_config(), device=dev)
        cs.push_all(pipe, ds)
        cam_ms = []
        ctx = arms[arm]()
        torch.cuda.synchronize()
        with ctx, cs.timed_camera_frames(pipe.vio, cam_ms):
            t0 = time.perf_counter()
            outs = pipe.spin()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        lid = [1e3 * o.timing["total"] for o in outs if o.iters > 0]
        return {"camera_median_ms": float(np.median(cam_ms)),
                "camera_p90_ms": float(np.percentile(cam_ms, 90)),
                "lidar_median_ms": float(np.median(lid)),
                "ms_per_pair": 1e3 * wall / len(outs), "camera_frames": len(cam_ms)}

    run(args.arms[0])  # discarded: the process's first pipeline
    runs = []
    for k in range(args.rounds * len(arms)):
        arm = list(arms)[k % len(arms)]
        r = run(arm)
        r["arm"] = arm
        runs.append(r)
        print(f"run {k}: {arm}: camera frame median {r['camera_median_ms']:.2f} ms "
              f"(p90 {r['camera_p90_ms']:.2f}), lidar frame median {r['lidar_median_ms']:.2f} "
              f"ms, {r['ms_per_pair']:.2f} ms per lidar + camera pair", flush=True)
        torch.cuda.empty_cache()
    print(json.dumps({"runs": runs, "card": cs.nvidia_smi_line()}))


if __name__ == "__main__":
    main()
