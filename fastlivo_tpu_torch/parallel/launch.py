"""The rank launcher: one spawned process per mesh rank.

JAX drives a mesh from one process and needs no launcher. Here every rank
is a process (`torch.multiprocessing`, spawn), joined in a process group
on 127.0.0.1 at a free port: NCCL for ranks on cards, gloo on the CPU or
for ranks that share one card.

    results = launch(fn, n, args, backend="gloo", timeout=60, deadline=300)

runs `fn(rank, n, *args)` in each rank and returns the ranks' return
values in rank order. `fn` and `args` are pickled by reference, so `fn`
is a module-level function; return numpy arrays and plain values, not
tensors. Nothing can hang the caller past its limits:
  - the process group has a finite `timeout`: a rank waiting in a
    collective that another rank never calls raises after it;
  - a rank that raises, or dies, makes `launch` kill the others at once
    and raise with the rank's traceback or exit code;
  - past `deadline` seconds (None: no deadline) `launch` kills every rank
    and raises TimeoutError.
"""
from __future__ import annotations

import datetime
import queue
import socket
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(fn, rank, n, port, backend, timeout, args, out):
    """A rank's body: join the group, run `fn`, post (rank, ok, value)."""
    try:
        # one intra-op thread: the ranks share the host's cores (and
        # CPU test runs already run several workers)
        torch.set_num_threads(1)
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=n, timeout=datetime.timedelta(seconds=timeout))
        res = (rank, True, fn(rank, n, *args))
    except BaseException:  # noqa: BLE001 — reported to the launcher, which raises
        res = (rank, False, traceback.format_exc())
    out.put(res)
    out.close()
    out.join_thread()  # the result is in the pipe before the group goes
    if dist.is_initialized():
        dist.destroy_process_group()


def launch(fn, n: int, args=(), *, backend: str = "gloo", timeout: float = 300.0,
           deadline: float | None = None) -> list:
    """Run `fn(rank, n, *args)` on `n` spawned ranks and return their
    results in rank order; see the module doc."""
    if n < 1:
        raise ValueError(f"launch: {n} ranks")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_entry, name=f"rank{r}",
                         args=(fn, r, n, port, backend, timeout, args, out))
             for r in range(n)]
    for p in procs:
        p.start()
    t_end = None if deadline is None else time.monotonic() + deadline
    results = {}
    try:
        while len(results) < n:
            try:
                rank, ok, val = out.get(timeout=0.2)
            except queue.Empty:
                if t_end is not None and time.monotonic() > t_end:
                    raise TimeoutError(
                        f"launch: ranks {sorted(set(range(n)) - set(results))} "
                        f"still running after the {deadline} s deadline") from None
                for r, p in enumerate(procs):
                    # a result is in the pipe before its rank exits
                    if p.exitcode is not None and r not in results and out.empty():
                        raise RuntimeError(f"launch: rank {r} exited with code "
                                           f"{p.exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"launch: rank {rank} failed:\n{val}")
            results[rank] = val
        for p in procs:
            p.join(timeout=30)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        out.close()
    return [results[r] for r in range(n)]


def mesh_backend(device, n: int) -> str:
    """The backend for `n` ranks on `device` ("cpu": gloo; CUDA: NCCL,
    which takes one card per rank and so needs n cards)."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > visible:
        raise ValueError(f"a mesh of {n} ranks needs {n} cards, {visible} visible "
                         "(or pass device 'cpu')")
    return "nccl"


def rank_device(device):
    """A rank's `make_mesh` device for a command-line `--device`: a CUDA
    device means the rank's own card."""
    return None if device is None or torch.device(device).type == "cuda" else device


def replay_rank(rank: int, n: int, cfg, scans, imu, device=None,
                sharded_map: bool = False, images=()) -> dict:
    """A rank program for `launch`: this rank's Pipeline over the mesh
    (`make_mesh(n, device)`), fed `scans` [(beg, pts, t_rel)], `imu`
    [(t, acc, gyr)] and, with the camera on, `images` [(t, img)], all at
    once. Returns, as numpy: the frames' stamps, positions, quaternions,
    active counts and iterations; the wall seconds of the run; this
    rank's `knn5_plane_tiled`, `photometric_err_H`, `photometric_step`,
    `photometric_cascade` and `imu_propagate` launches and collectives
    during it; its map's bytes and pool tiles;
    with the camera, the camera frames that ran the frame step, the
    visual map's points and this rank's bytes of it."""
    from ..ops import imu_scan, knn_plane, photometric
    from ..pipeline import Pipeline
    from .sharded import make_mesh

    mesh = make_mesh(n, device=device)
    pipe = Pipeline(cfg, mesh=mesh, sharded_map=sharded_map)
    for beg, pts, t_rel in scans:
        pipe.push_lidar(beg, pts, t_rel)
    for t, acc, gyr in imu:
        pipe.push_imu(t, acc, gyr)
    for t, img in images:
        pipe.push_img(t, img)
    sync = torch.cuda.synchronize if mesh.device.type == "cuda" else (lambda: None)
    sync()
    k0, p0, i0, c0 = (knn_plane.knn5_plane_tiled.launches,
                      photometric.photometric_err_H.launches, imu_scan.imu_propagate.launches,
                      mesh.collectives)
    s0, q0 = photometric.photometric_step.launches, photometric.photometric_cascade.launches
    t0 = time.perf_counter()
    outs = pipe.spin() + pipe.finish()
    sync()
    wall = time.perf_counter() - t0
    out = dict(
        t=np.array([o.t for o in outs]), pos=np.array([o.pos for o in outs]),
        quat=np.array([o.quat for o in outs]),
        n_active=np.array([o.n_active for o in outs]),
        iters=np.array([o.iters for o in outs]), wall_s=wall,
        knn5_plane_tiled=knn_plane.knn5_plane_tiled.launches - k0,
        photometric_err_H=photometric.photometric_err_H.launches - p0,
        photometric_step=photometric.photometric_step.launches - s0,
        photometric_cascade=photometric.photometric_cascade.launches - q0,
        imu_propagate=imu_scan.imu_propagate.launches - i0,
        collectives=mesh.collectives - c0,
        map_bytes=sum(t.numel() * t.element_size() for t in pipe.map),
        pool_tiles=pipe.map.slot_key.shape[0],
        n_dropped=int(pipe.map.n_dropped))
    if pipe.vio is not None:
        vm = pipe.vio.vmap
        out.update(vio_steps=pipe.vio.steps, vmap_points=int(vm.n_pts),
                   vmap_bytes=sum(t.numel() * t.element_size() for t in vm))
    return out
