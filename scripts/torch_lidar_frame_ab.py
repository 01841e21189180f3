"""The steady LIO and LIVO frames of several checkouts and arms of the port,
in turns on one card.

Usage: python scripts/torch_lidar_frame_ab.py [--variant TREE ...] [--arm ARM ...]
           [--paths lio livo hash dense cache_knn ref hash_cache_knn dense_cache_knn]
           [--rounds 3] [--duration 6] [--profile]
           [--kernel-rounds N] [--stamps]

A variant is a tree and an arm. Each tree holds `fastlivo_tpu_torch/` and
its `chip_smoke.py` (the repository itself, ".", or a parent unpacked
with `git archive <commit> | tar -x -C build/parent`), relative to the
repository root; each runs in a process of its own that imports that
tree's package (its kernels built at first use under TREE/build/), stays
up for the whole comparison and runs only when asked, so the runs of all
variants go in turns, forwards and backwards (A B B A ...). The arms:
"as shipped"; "host loop, step kernel", the LIO EKF as the host loop
lio.lio_loop (one knn5_plane_tiled and one photometric_step launch and
one flag read an iteration: what a mesh and the other maps run); "host
loop, torch step", that loop with the f64 step in torch ops
(chip_smoke.lio_host_loop, the EKF before the cascade); "plain
selection", the camera frame's selection and map upkeep as their torch
code (vio.frame_kernels_apply False: ~2600 launches and four host reads
a frame); "photometric host loop", the photometric cascade as the host
loop it replaced (chip_smoke.photometric_host_loop); "cascade,
synchronised", the cascade followed by torch.cuda.synchronize(). The LIO
arms act on both paths, the camera arms on the LIVO path only.

A run is a fresh pipeline on one path, after one discarded run of each
path in its process: chip_smoke.py's LIO per-frame path (Pipeline(Config())
at the shipped capacities, camera off, 24000-point scans of
SyntheticDataset(duration, seed 0)), the same on the hash map ("hash":
2^20 slots, probe 12) or the dense grid ("dense": 256 x 256 x 64 cells),
chip_smoke.py's paths (a) and (b), the tiled map with `cache_knn`
("cache_knn") or `plane_fit: ref` ("ref"), its paths (c) and (d), the
hash map or the dense grid with `cache_knn` ("hash_cache_knn",
"dense_cache_knn"), or its LIVO per-frame path
(chip_smoke.livo_config: a 640x512 camera), the same recorded datasets
every run. It reports the steady lidar frame's median and p90 host wall
(FrameOutput.timing["total"], the stats read included), the wall per
lidar frame or lidar + camera pair, on LIVO the camera frame's median and
p90 (host wall of Vio.update), and the median host wall per call of the
map insert, the box delete and the two voxel filters, unsynchronised and
unprofiled (a stage that reads the device waits there), and of the
undistortion (on hash and dense the backend's insert and box delete:
"hash.insert", "dense.insert", ...). With --profile,
each variant then runs once more under torch.profiler: a second dataset
(4 s, seed 1), the lidar paths from their 31st scan and LIVO from 3 s: host and device
ms per frame of every `frame.*` / `vio.*` range, device kernels per lidar
frame or lidar + camera pair, the device-busy share of the window, the
library sort kernels (onesweep) under frame.map_insert a frame, and the
map stages' kernels (voxel_centroids, tiled_delete_boxes, the insert's
launches, undistort; on hash and dense hash_insert_keys,
hash_insert_probe, dense_insert and flat_delete_boxes; the voxel filter's
key pass or keys and sort, the camera frame's dedup and push): launches
per frame and device us a launch.
With --kernel-rounds N, each tree then times, N times in turns, its own
wrappers on the LIO path's recorded calls (chip_smoke.time_ms, device
time between CUDA events with the calls queued ahead of the device): what
the insert runs after its sort (one launch, or the separate tiles and
cells launches of a tree from before they were one) on the last batch
re-inserted into the final map (every winner aliased) and on the
bootstrap batch into an empty map (every winner fresh; a directory of
its own for each call), the stable sort of the last batch's key at 64
bits (the JAX package's packing) and at 32 bits, in turns, the whole
insert, its keys and sort (the tree's insert_sort launch where it has
one, null else; and the route it replaced, the key pass and torch's
stable sort), the last frame step's undistortion and the
last scan's voxel centroid; with the hash or dense path also the box
delete on that path's final map with its last box set and, on dense, the
insert of its last batch into that map (between events, and device us a
launch under torch.profiler). With --stamps, a tree whose
csrc/undistort.cu, csrc/tiled_insert.cu, csrc/hash_insert.cu,
csrc/dense_insert.cu or csrc/flat_delete_boxes.cu stamps its
phases (csrc/phase_stamps.cuh) builds each again with -DPHASE_STAMPS and
launches it alone, synchronised, 30 times: undistort on that scan (the
median of each phase: staging the offsets and the frame's constants, the
search, the rest; and the whole launch), the insert's second launch on
the last batch re-inserted into the final map (the median time from the
first block's start to the last block past each boundary: marked, the
ranking past its wait and its look-back, ranked, the cells gathered,
past their wait, their runs walked, written, the end), and the hash
insert's probe launch on the hash path's last batch re-inserted into
its map (each phase summed over the rounds: the heads, the slot reads,
the first barrier, the writes, the second barrier, the end; and the
rounds), the dense insert on the dense path's last batch and the box
delete on its final map with its last box set (each boundary from the
first block's start); the %globaltimer ticks by 0.512 us on the H100.
Prints one line per run, then one JSON line with every run and the card's
`nvidia-smi` name and power limit.
"""
import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAP_STAGE_KERNELS = ("voxel_centroids_kernel", "tiled_delete_boxes_kernel",
                     "tiled_insert_keys_kernel", "tiled_insert_tiles_kernel",
                     "tiled_insert_cells_kernel", "undistort_kernel",
                     "hash_insert_keys_kernel", "hash_insert_probe_kernel",
                     "dense_insert_kernel", "flat_delete_boxes_kernel", "voxel_keys_kernel",
                     "voxel_sort_kernel", "vio_dedup_kernel", "vio_push_kernel",
                     "tiled_insert_sort_kernel", "vio_push_one_kernel")
# lidar only: tiled, hash and dense maps, tiled with cache_knn, with plane_fit ref, hash
# and dense with cache_knn
LIDAR_PATHS = ("lio", "hash", "dense", "cache_knn", "ref", "hash_cache_knn", "dense_cache_knn")
ARMS = ("as shipped", "host loop, step kernel", "host loop, torch step", "plain selection",
        "photometric host loop", "cascade, synchronised")


def stage_times(evs, prefix, n):
    """Host and device ms per frame (of n) of every range named prefix*."""
    return {e.key: {"host_ms": e.cpu_time_total / 1e3 / n,
                    "device_ms": e.device_time_total / 1e3 / n}
            for e in evs if e.key.startswith(prefix) and str(e.device_type).endswith("CPU")}


class Worker:
    """One tree's package in this process: the datasets, the arms and the
    runs the coordinator asks for."""

    def __init__(self, tree: str, duration: float, paths=("lio", "livo")):
        self.paths = paths
        sys.path[:0] = [os.path.abspath(os.path.join(ROOT, tree)), ROOT]
        import torch

        import chip_smoke as cs
        from fastlivo_tpu_torch import imu, lio, vio
        from fastlivo_tpu_torch.config import Config
        from fastlivo_tpu_torch.io.synthetic import SyntheticDataset
        from fastlivo_tpu_torch.ops import dense_map, tiled_map, voxel_filter, voxel_map

        if not torch.cuda.is_available():
            raise SystemExit("torch_lidar_frame_ab: needs a CUDA device")
        self.torch, self.cs, self.dev = torch, cs, torch.device("cuda")

        def lio_config(backend="tiled", **capacity):
            cfg = Config()
            cfg.img_enable = False
            cfg.capacity.map_backend = backend
            for k, v in capacity.items():
                setattr(cfg.capacity, k, v)
            return cfg

        self.configs = {"lio": lio_config, "livo": cs.livo_config,
                        "hash": lambda: lio_config("hash"), "dense": lambda: lio_config("dense"),
                        "cache_knn": lambda: lio_config(cache_knn=True),
                        "ref": lambda: lio_config(plane_fit="ref"),
                        "hash_cache_knn": lambda: lio_config("hash", cache_knn=True),
                        "dense_cache_knn": lambda: lio_config("dense", cache_knn=True)}
        lio_data = cs.Recorded(SyntheticDataset(
            duration=duration, points_per_scan=24000, lidar_noise=0.004, seed=0))
        self.data = {**{p: lio_data for p in LIDAR_PATHS},
                     "livo": cs.Recorded(cs.livo_dataset(
                         cs.livo_config(), duration=duration, points_per_scan=24000,
                         lidar_noise=0.004, seed=0))}
        lio_prof = cs.Recorded(SyntheticDataset(duration=4.0, points_per_scan=24000,
                                                lidar_noise=0.004, seed=1))
        self.profile_data = {
            **{p: lio_prof for p in LIDAR_PATHS},
            "livo": cs.Recorded(cs.livo_dataset(cs.livo_config(), duration=4.0,
                                                points_per_scan=24000, lidar_noise=0.004,
                                                seed=1))}
        cascade = vio.photometric_cascade

        def synchronised(*a):
            out = cascade(*a)
            torch.cuda.synchronize()
            return out

        self.arms = {
            "as shipped": contextlib.nullcontext,
            "host loop, step kernel": lambda: cs.swapped(lio, "cascade_applies",
                                                         lambda *a, **kw: False),
            "host loop, torch step": cs.lio_host_loop,
            "plain selection": lambda: cs.swapped(vio, "frame_kernels_apply",
                                                  lambda *a, **kw: False),
            "photometric host loop": cs.photometric_host_loop,
            "cascade, synchronised": lambda: cs.swapped(vio, "photometric_cascade",
                                                        synchronised)}
        self.stages = {"undistort": (imu, "undistort"), "map_insert": (tiled_map, "insert"),
                       "delete_boxes": (tiled_map, "delete_boxes"),
                       "voxel_filter": (voxel_filter, "voxel_downsample_device"),
                       "vio.voxel_filter": (vio, "voxel_downsample_device"),
                       "hash.insert": (voxel_map, "insert"),
                       "hash.delete_boxes": (voxel_map, "delete_boxes"),
                       "dense.insert": (dense_map, "insert"),
                       "dense.delete_boxes": (dense_map, "delete_boxes")}
        self.recorded_flat = {}  # record_flat's, by path
        for path in self.paths:  # discarded: builds and warms
            self.run(path, "as shipped")

    @contextlib.contextmanager
    def host_walls(self, walls: dict):
        """Append each timed stage's host wall (ms) per call to walls[stage]."""
        def timed(name, real):
            @functools.wraps(real)  # a kernel wrapper counts on its module's name
            def call(*a, **kw):
                t0 = time.perf_counter()
                out = real(*a, **kw)
                walls.setdefault(name, []).append(1e3 * (time.perf_counter() - t0))
                return out
            return call

        with contextlib.ExitStack() as stack:
            for name, (mod, attr) in self.stages.items():
                stack.enter_context(self.cs.swapped(mod, attr, timed(name, getattr(mod, attr))))
            yield

    def pipeline(self, path):
        from fastlivo_tpu_torch.pipeline import Pipeline

        return Pipeline(self.configs[path](), device=self.dev)

    def run(self, path, arm):
        import numpy as np

        torch, cs = self.torch, self.cs
        pipe = self.pipeline(path)
        cs.push_all(pipe, self.data[path])
        cam, walls = [], {}
        torch.cuda.synchronize()
        with self.arms[arm](), self.host_walls(walls), (
                cs.timed_camera_frames(pipe.vio, cam) if pipe.vio is not None
                else contextlib.nullcontext()):
            t0 = time.perf_counter()
            outs = pipe.spin()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        lid = [1e3 * o.timing["total"] for o in outs if o.iters > 0]
        res = {"lidar_median_ms": float(np.median(lid)),
               "lidar_p90_ms": float(np.percentile(lid, 90)), "steady_frames": len(lid),
               "ms_per_frame_or_pair": 1e3 * wall / len(outs),
               "stage_host_ms": {k: float(np.median(v)) for k, v in walls.items()}}
        if cam:
            res.update(camera_median_ms=float(np.median(cam)),
                       camera_p90_ms=float(np.percentile(cam, 90)), camera_frames=len(cam))
        del pipe
        torch.cuda.empty_cache()
        return res

    def profile(self, path, arm):
        from torch.profiler import ProfilerActivity, profile

        torch, cs = self.torch, self.cs
        ds = self.profile_data[path]
        lidar = path in LIDAR_PATHS
        split = ds.lidar_scans_fast()[30][0] if lidar else 3.0
        pipe = self.pipeline(path)
        cs.push_all(pipe, ds, t_max=split)
        with self.arms[arm]():
            pipe.spin()
            cs.push_all(pipe, ds, t_min=split)
            steps = pipe.vio.steps if pipe.vio is not None else 0
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                outs = pipe.spin()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        evs = prof.key_averages()
        ranges = ("frame.", "lio.", "vio.")
        kernels = [e for e in evs if str(e.device_type).endswith("CUDA")
                   and e.self_device_time_total > 0 and not e.key.startswith(ranges)]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        n = len(outs) if lidar else pipe.vio.steps - steps
        stage_kernels = {name: {"per_frame": e.count / n,
                                "device_us": e.self_device_time_total / e.count}
                         for e in kernels for name in MAP_STAGE_KERNELS if name in e.key}
        res = {"frames": n, "profiled_ms_per_frame": 1e3 * wall / n,
               "kernels_per_frame": sum(e.count for e in kernels) / n,
               "device_busy_share": busy / (1e3 * wall),
               "stages": stage_times(evs, "frame." if lidar else "vio.", n),
               "map_stage_kernels": stage_kernels,
               "map_insert_sort_kernels": cs.sort_kernels_in(prof, "frame.map_insert") / n}
        del pipe
        torch.cuda.empty_cache()
        return res


    def record_lio(self):
        """The LIO path's first and last insert, its last frame step and its
        last voxel filter, each call's tensors copied on the card, and the
        final map (once a worker)."""
        if getattr(self, "recorded", None) is not None:
            return self.recorded
        torch, cs = self.torch, self.cs
        from fastlivo_tpu_torch import pipeline as pipeline_mod
        from fastlivo_tpu_torch.ops import tiled_map, voxel_filter

        rec = {}
        cp = lambda a: [v.clone() if isinstance(v, torch.Tensor) else v for v in a]  # noqa

        def keep(name, real, first=False):
            def call(*a, **kw):
                if not (first and name in rec):
                    rec[name] = cp(a)
                return real(*a, **kw)
            return call

        pipe = self.pipeline("lio")
        cs.push_all(pipe, self.data["lio"])
        with contextlib.ExitStack() as stack:
            for mod, attr, name, first in (
                    (tiled_map, "insert", "first_insert", True),
                    (tiled_map, "insert", "insert", False),
                    (pipeline_mod, "lidar_frame_step", "step", False),
                    (voxel_filter, "voxel_downsample_device", "filter", False)):
                stack.enter_context(cs.swapped(mod, attr, keep(name, getattr(mod, attr), first)))
            pipe.spin()
        torch.cuda.synchronize()
        rec["map"] = pipe.map
        self.recorded = rec
        return rec

    def kernel_times(self):
        """This tree's wrappers timed on the recorded calls (ms): what runs
        after the insert's sort (the tiles and cells launches, or the one
        launch of both where `insert_tiles` takes `valid`) with every winner
        aliased and with every winner fresh, the stable sort of the batch's
        key at 64 and 32 bits in turns, the whole insert, the undistortion
        and the voxel centroid."""
        torch, cs = self.torch, self.cs
        import inspect
        import itertools

        from fastlivo_tpu_torch import imu
        from fastlivo_tpu_torch.ops import tiled_map as tm
        from fastlivo_tpu_torch.ops import voxel_filter as vf

        if "valid" in inspect.signature(tm.insert_tiles).parameters:
            post_sort = tm.insert_tiles
        else:  # two launches after the sort
            def post_sort(mm, p, v, r, s, o):
                n = tm.insert_tiles(mm, p, r, s, o)
                tm.insert_cells(mm, p, v, r, s, o, n[1])

        rec = self.record_lio()
        m = rec["map"]
        clone = lambda mp: type(mp)(*(t.clone() for t in mp))  # noqa: E731
        _, pts, valid = rec["insert"][:3]
        mt = clone(m)
        gkey, rows = tm.insert_keys_plain(mt, pts, valid)
        sg, order = torch.sort(gkey, stable=True)
        res = {"post_sort_aliased": cs.time_ms(lambda: post_sort(mt, pts, valid, rows, sg,
                                                                 order))}
        # the insert's stable sort on the batch's key at both widths, in turns:
        # dir << 40 | cell << 31 | distance bits (D << 40 invalid), and
        # (dir << 9 | cell) - 2^31 (0 invalid)
        cell = (rows[0].to(torch.int64) << 9) | rows[2]
        D = m.dir_check.shape[0]
        keys = {"sort_64": torch.where(valid, (cell << 31) | rows[3].to(torch.int64), D << 40),
                "sort_32": torch.where(valid, cell - (1 << 31), 0).to(torch.int32)}
        sorts = {k: [] for k in keys}
        for k in ("sort_64", "sort_32", "sort_32", "sort_64"):
            sorts[k].append(cs.time_ms(lambda: torch.sort(keys[k], stable=True)))
        res.update({k: sum(v) / len(v) for k, v in sorts.items()})
        res["insert"] = cs.time_ms(lambda: tm.insert(mt, pts, valid))
        # the insert's keys and sort: one launch where the tree has it, and
        # the route it replaced (the key pass and torch's stable sort)
        route = lambda: torch.sort(tm.insert_keys(mt, pts, valid)[0], stable=True)  # noqa
        res["keys_and_sort_route"] = cs.time_ms(route)
        res["insert_sort"] = cs.time_ms(lambda: tm.insert_sort(mt, pts, valid)) if hasattr(
            tm, "insert_sort") else None
        _, bpts, bvalid = rec["first_insert"][:3]
        dims = [1 << int(x) for x in m.log2_dims.cpu()]
        empty = tm.empty_tiled_map(dims, m.slot_key.shape[0], float(m.voxel_size),
                                   device=self.dev)
        bkey, brows = tm.insert_keys_plain(empty, bpts, bvalid)
        bsg, border = torch.sort(bkey, stable=True)
        # a directory each call, one pool: the cells after the first call live
        maps = itertools.cycle([empty._replace(
            dir_check=empty.dir_check.clone(), dir_slot=empty.dir_slot.clone(),
            slot_key=empty.slot_key.clone()) for _ in range(66)])
        res["post_sort_fresh"] = cs.time_ms(
            lambda: post_sort(next(maps), bpts, bvalid, brows, bsg, border))
        args = self.undistort_args(rec)
        res["undistort"] = cs.time_ms(lambda: imu.undistort(*args))
        und, rmask, leaf, max_out = rec["filter"][:4]
        keys, vorder = vf._sorted_keys(und, rmask, leaf, None)
        res["voxel_centroids"] = cs.time_ms(lambda: vf.voxel_centroids(keys, vorder, und,
                                                                        max_out))
        del maps, empty, mt
        torch.cuda.empty_cache()
        res.update(self.flat_times())
        return res

    @staticmethod
    def undistort_args(rec):
        st, _m, pose, calib, pts_raw, t_rel, rmask = rec["step"][:7]
        return st, pose, pts_raw, t_rel, rmask, calib

    def record_flat(self, path):
        """The hash or dense path's ("hash", "dense") last insert and last
        box delete (their tensors copied on the card) and final map (once a
        worker and path)."""
        if path in self.recorded_flat:
            return self.recorded_flat[path]
        torch, cs = self.torch, self.cs
        from fastlivo_tpu_torch.ops import dense_map, voxel_map

        mod = voxel_map if path == "hash" else dense_map
        rec = {}

        def keep(name, real):
            def call(*a, **kw):
                rec[name] = [v.clone() if isinstance(v, torch.Tensor) else v for v in a]
                return real(*a, **kw)
            return call

        pipe = self.pipeline(path)
        cs.push_all(pipe, self.data[path])
        with cs.swapped(mod, "insert", keep("insert", mod.insert)), cs.swapped(
                mod, "delete_boxes", keep("boxes", mod.delete_boxes)):
            pipe.spin()
        torch.cuda.synchronize()
        rec["map"] = pipe.map
        self.recorded_flat[path] = rec
        return rec

    def flat_times(self):
        """The flat maps' box delete on the hash and dense paths' final maps
        with their last box sets, and the dense insert of the dense path's
        last batch into its map, for the paths this worker runs: ms between
        CUDA events with the calls queued (chip_smoke.time_ms) and device us
        a launch under torch.profiler (30 launches)."""
        from torch.profiler import ProfilerActivity, profile

        torch, cs = self.torch, self.cs
        from fastlivo_tpu_torch.ops import dense_map as dm
        from fastlivo_tpu_torch.ops import voxel_map as vm

        def device_us(fn, kernel, n=30):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            evs = [e for e in prof.key_averages() if kernel in e.key
                   and e.self_device_time_total > 0]
            return sum(e.self_device_time_total for e in evs) / max(1, sum(e.count for e in evs))

        res = {}
        for path in ("hash", "dense"):
            if path not in self.paths:
                continue
            rec = self.record_flat(path)
            mt = type(rec["map"])(*(t.clone() for t in rec["map"]))
            _, lo, hi = rec["boxes"][:3]
            call = lambda: vm.flat_delete_boxes(mt, lo, hi)  # noqa: E731
            res[f"flat_delete_boxes {path}"] = cs.time_ms(call)
            res[f"flat_delete_boxes {path} us"] = device_us(call, "flat_delete_boxes_kernel")
            if path == "dense":
                _, pts, valid = rec["insert"][:3]
                call = lambda: dm.dense_insert(mt, pts, valid)  # noqa: E731
                res["dense_insert"] = cs.time_ms(call)
                res["dense_insert us"] = device_us(call, "dense_insert_kernel")
            del mt
        return res

    # the stamped kernels: {library: (phase names, boundary 1 .. n each ends)};
    # hash_insert's probe launch stamps its rounds (phase_stamps.cuh's
    # iteration slots): its phases are summed over the rounds
    STAMPED = {
        "undistort": ("staged", "searched", "rest"),
        "tiled_insert": ("marked", "ranking past its wait", "ranking past its look-back",
                         "ranked", "cells gathered", "cells past their wait",
                         "cells walked", "cells written", "end"),
        "hash_insert": ("heads", "reads", "first barrier", "writes", "second barrier", "end",
                        "phases", "barriers"),
        "dense_insert": ("phase 1", "barrier", "phase 2", "end"),
        "flat_delete_boxes": ("loads", "queue and tests", "block sums", "end")}
    IT_BASE, IT_NPH, IT_MAX = 16, 8, 64  # phase_stamps.cuh's iteration slots

    def hash_round_ms(self, t):
        """hash_insert_probe's stamps t (ns) -> {phase: ms} summed over the
        rounds, "rounds" and "total"; each boundary the last block's
        crossing. A probe over the heads (no heads stamp: one barrier a
        round) gives "phases" (each round's settling and reads, up to its
        barrier) and "barriers"; the sorted rows' probe "heads", "reads",
        "first barrier", "writes" and "second barrier"."""
        base, nph = self.IT_BASE, self.IT_NPH
        out = dict.fromkeys(self.STAMPED["hash_insert"], 0.0)
        if not t[1]:
            prev, rounds = t[0], 0
            for r in range(self.IT_MAX):
                s = t[base + r * nph: base + r * nph + 2]
                if not s[0]:
                    break
                rounds += 1
                out["phases"] += (s[0] - prev) / 1e6
                out["barriers"] += (s[1] - s[0]) / 1e6
                prev = s[1]
            out["end"] = (t[2] - prev) / 1e6
            out.update(rounds=rounds, total=(t[2] - t[0]) / 1e6)
            return out
        out["heads"] = (t[1] - t[0]) / 1e6
        prev, rounds = t[1], 0
        for r in range(self.IT_MAX):
            s = t[base + r * nph: base + r * nph + 4]
            if not s[0]:
                break
            rounds += 1
            out["reads"] += (s[0] - prev) / 1e6
            out["first barrier"] += (s[1] - s[0]) / 1e6
            prev = s[1]
            if s[2]:
                out["writes"] += (s[2] - s[1]) / 1e6
                out["second barrier"] += (s[3] - s[2]) / 1e6
                prev = s[3]
        out["end"] = (t[2] - prev) / 1e6
        out.update(rounds=rounds, total=(t[2] - t[0]) / 1e6)
        return out

    def stamps(self, tree: str, reps: int = 30):
        """Each stamped kernel (STAMPED) built with -DPHASE_STAMPS and
        launched alone `reps` times, synchronised, on the recorded calls:
        undistort on the last frame step's scan; the insert's second
        launch (tiled_insert_tiles) on the last batch re-inserted into the
        final map. {library: {phase: median ms}}: undistort's phases one
        after another, the insert's each boundary's time from the launch's
        first block start (the last block to cross it; phase_stamps.cuh);
        None where the tree's source has no stamps."""
        import ctypes

        import numpy as np

        torch = self.torch
        from fastlivo_tpu_torch import imu
        from fastlivo_tpu_torch.ops import _build
        from fastlivo_tpu_torch.ops import tiled_map as tm

        rec = self.record_lio()
        und = self.undistort_args(rec)
        m = type(rec["map"])(*(t.clone() for t in rec["map"]))
        _, pts, valid = rec["insert"][:3]
        gkey, rows = tm.insert_keys_plain(m, pts, valid)
        sg, order = torch.sort(gkey, stable=True)
        keys_call = None  # the hash insert's keys launch, where it has stamps
        calls = {"undistort": (lambda: imu.undistort(*und), imu._undistort_launcher),
                 "tiled_insert": (lambda: tm.insert_tiles(m, pts, valid, rows, sg, order),
                                  tm._insert_launchers)}
        out = {}
        for name, phases in self.STAMPED.items():
            src = _build.CSRC / f"{name}.cu"
            if not src.exists() or f"PHASE_STAMPS_EXPORT({name})" not in src.read_text():
                out[name] = None
                continue
            if name in ("dense_insert", "flat_delete_boxes"):  # on the dense path's map
                from fastlivo_tpu_torch.ops import dense_map as dm
                from fastlivo_tpu_torch.ops import voxel_map as vm

                drec = self.record_flat("dense")
                dmap = type(drec["map"])(*(t.clone() for t in drec["map"]))
                _, dp, dv = drec["insert"][:3]
                _, dlo, dhi = drec["boxes"][:3]
                calls["dense_insert"] = (lambda: dm.dense_insert(dmap, dp, dv),
                                         dm._insert_launcher)
                calls["flat_delete_boxes"] = (lambda: vm.flat_delete_boxes(dmap, dlo, dhi),
                                              vm._delete_launcher)
            if name == "hash_insert":  # the hash path's last batch into its map
                from fastlivo_tpu_torch.ops import voxel_map as vm

                hrec = self.record_flat("hash")
                hm = type(hrec["map"])(*(t.clone() for t in hrec["map"]))
                _, hp, hv, *probe = hrec["insert"]
                probe = probe[0] if probe else 12
                if hasattr(vm, "insert_heads_plain"):  # the probe over the heads
                    heads, nh = vm.insert_heads_plain(hm, hp, hv)
                    calls[name] = (lambda: vm.hash_insert_probe(hm, hp, heads, nh, probe),
                                   vm._insert_launchers)
                    keys_call = lambda: vm.hash_insert_keys(hm, hp, hv)  # noqa: E731
                else:
                    hrows, hkeys = vm.insert_keys_plain(hm, hp, hv)
                    horder = vm.sort_order(hkeys)
                    calls[name] = (
                        lambda: vm.hash_insert_probe(hm, hp, hv, hrows, horder, probe),
                        vm._insert_launchers)
            lib_path = _build.BUILD_DIR / "stamps" / f"lib{name}-stamped.so"
            lib_path.parent.mkdir(parents=True, exist_ok=True)
            res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DPHASE_STAMPS", "-o",
                                  str(lib_path), str(src)], capture_output=True, text=True)
            if res.returncode:
                raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
            lib = ctypes.CDLL(str(lib_path))
            read = getattr(lib, f"{name}_stamps")
            read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
            read.restype = ctypes.c_int
            n = (self.IT_BASE + self.IT_MAX * self.IT_NPH if name == "hash_insert"
                 else len(phases) + 1)
            buf = (ctypes.c_ulonglong * n)()
            call, launchers = calls[name]
            shipped = _build._loaded.get(name)
            _build._loaded[name] = lib
            launchers.cache_clear()
            rows_ms = []
            try:
                read(buf, n)  # reset
                for _ in range(reps + 1):
                    call()
                    torch.cuda.synchronize()
                    if read(buf, n):
                        raise RuntimeError(f"{name}: reading the stamps failed")
                    t = [int(x) for x in buf]
                    if name == "hash_insert":
                        rows_ms.append(self.hash_round_ms(t))
                    elif name == "undistort":
                        ms = [(t[k] - t[k - 1]) / 1e6 for k in range(1, n)] + [
                            (t[-1] - t[0]) / 1e6]
                        rows_ms.append(dict(zip(phases + ("total",), ms)))
                    else:
                        rows_ms.append({p: (t[k + 1] - t[0]) / 1e6
                                        for k, p in enumerate(phases)})
                if name == "hash_insert" and keys_call is not None:
                    keys_ms = self.keys_stamps(keys_call, read, buf, n, reps)
            finally:
                if shipped is None:
                    _build._loaded.pop(name)
                else:
                    _build._loaded[name] = shipped
                launchers.cache_clear()
            rows_ms = rows_ms[1:]  # the first launch warms up
            out[name] = {k: float(np.median([r[k] for r in rows_ms])) for k in rows_ms[0]}
            if name == "hash_insert" and keys_call is not None:
                out["hash_insert_keys"] = keys_ms
        return out

    KEYS_PHASES = ("rows into the table", "first barrier", "heads", "second barrier",
                   "reset")

    def keys_stamps(self, call, read, buf, n, reps):
        """hash_insert_keys launched alone `reps` times, synchronised, its
        stamps (3-7: the end of each phase and barrier) read after each:
        {phase: median ms} and the total."""
        import numpy as np

        torch = self.torch
        rows = []
        read(buf, n)  # reset
        for _ in range(reps + 1):
            call()
            torch.cuda.synchronize()
            if read(buf, n):
                raise RuntimeError("hash_insert_keys: reading the stamps failed")
            t = [int(x) for x in buf]
            ms = [(t[k] - (t[k - 1] if k > 3 else t[0])) / 1e6 for k in range(3, 8)]
            rows.append({**dict(zip(self.KEYS_PHASES, ms)), "total": (t[7] - t[0]) / 1e6})
        rows = rows[1:]
        return {k: float(np.median([r[k] for r in rows])) for k in rows[0]}


def serve(tree: str, duration: float, paths):
    """The worker's loop: one JSON command a line on stdin, one RESULT line
    an answer on stdout."""
    w = Worker(tree, duration, paths)
    print("RESULT " + json.dumps({"ready": True}), flush=True)
    for line in sys.stdin:
        cmd = json.loads(line)
        if cmd.get("kernels"):
            out = w.kernel_times()
        elif cmd.get("stamps"):
            out = w.stamps(tree)
        elif cmd.get("profile"):
            out = w.profile(cmd["path"], cmd["arm"])
        else:
            out = w.run(cmd["path"], cmd["arm"])
        print("RESULT " + json.dumps(out), flush=True)


def ask(proc, tree, cmd=None):
    if cmd is not None:
        proc.stdin.write(json.dumps(cmd) + "\n")
        proc.stdin.flush()
    for line in proc.stdout:
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
        print(line, end="", file=sys.stderr)
    raise SystemExit(f"{tree}: worker ended (rc {proc.wait()})")


def describe(path, r):
    s = (f"steady lidar frame median {r['lidar_median_ms']:.2f} ms (p90 "
         f"{r['lidar_p90_ms']:.2f}), {r['ms_per_frame_or_pair']:.2f} ms per "
         f"{'lidar frame' if path in LIDAR_PATHS else 'lidar + camera pair'}")
    if "camera_median_ms" in r:
        s += (f", camera frame median {r['camera_median_ms']:.2f} ms (p90 "
              f"{r['camera_p90_ms']:.2f})")
    return s + "; host ms a call " + ", ".join(
        f"{k} {v:.3f}" for k, v in r["stage_host_ms"].items())


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--variant", action="append", default=None, metavar="TREE")
    ap.add_argument("--arm", action="append", default=None, choices=ARMS)
    ap.add_argument("--paths", nargs="+", default=["lio", "livo"],
                    choices=["lio", "livo", *LIDAR_PATHS[1:]])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--duration", type=float, default=6.0)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--kernel-rounds", type=int, default=0)
    ap.add_argument("--stamps", action="store_true")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        serve(args.worker, args.duration, tuple(args.paths))
        return
    trees = args.variant or ["."]
    variants = [(t, a) for t in trees for a in (args.arm or ["as shipped"])]
    procs = {}
    try:
        for t in trees:
            procs[t] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--worker", t,
                 "--duration", str(args.duration), "--paths", *args.paths],
                cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        for t, p in procs.items():
            ask(p, t)
        runs = []
        for r in range(args.rounds):
            for tree, arm in (variants if r % 2 == 0 else variants[::-1]):
                for path in args.paths:
                    res = ask(procs[tree], tree, {"path": path, "arm": arm})
                    runs.append({"tree": tree, "arm": arm, "path": path, "round": r, **res})
                    print(f"{tree}, {arm}, {path}: {describe(path, res)}", flush=True)
        profiles = []
        for tree, arm in (variants if args.profile else []):
            for path in args.paths:
                res = ask(procs[tree], tree, {"path": path, "arm": arm, "profile": True})
                profiles.append({"tree": tree, "arm": arm, "path": path, **res})
                print(f"{tree}, {arm}, {path} profiled: {res['profiled_ms_per_frame']:.2f} ms "
                      f"a {'frame' if path in LIDAR_PATHS else 'camera frame'}, "
                      f"{res['kernels_per_frame']:.0f} kernels a "
                      f"{'lidar frame' if path in LIDAR_PATHS else 'lidar + camera pair'}, "
                      f"device "
                      f"busy {100 * res['device_busy_share']:.1f}%, "
                      f"{res['map_insert_sort_kernels']:.1f} library sort kernels under "
                      f"frame.map_insert; host / device ms " + ", ".join(
                          f"{k} {v['host_ms']:.3f} / {v['device_ms']:.3f}"
                          for k, v in sorted(res["stages"].items(),
                                             key=lambda kv: -kv[1]["host_ms"]))
                      + "; kernels " + ", ".join(
                          f"{k} {v['per_frame']:.2f} a frame, {v['device_us']:.2f} us"
                          for k, v in res["map_stage_kernels"].items()), flush=True)
        kernels = []
        for r in range(args.kernel_rounds):
            for tree in (trees if r % 2 == 0 else trees[::-1]):
                res = ask(procs[tree], tree, {"kernels": True})
                kernels.append({"tree": tree, "round": r, **res})
                print(f"{tree} kernels (ms): " + ", ".join(
                    f"{k} {v:.4f}" if v is not None else f"{k} none" for k, v in res.items()),
                      flush=True)
        stamps = {}
        for tree in (trees if args.stamps else []):
            stamps[tree] = ask(procs[tree], tree, {"stamps": True})
            print(f"{tree} phase stamps (ms, median of 30): {stamps[tree]}", flush=True)
    finally:
        for p in procs.values():
            with contextlib.suppress(OSError):
                p.stdin.close()
        for p in procs.values():
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(json.dumps({"variants": variants, "runs": runs, "profiles": profiles,
                      "kernels": kernels, "stamps": stamps, "card": smi}))


if __name__ == "__main__":
    main()
