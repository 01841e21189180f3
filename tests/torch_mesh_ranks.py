"""Rank programs for the port's mesh tests (tests/test_torch_sharded*.py,
test_torch_mesh_product.py).

`fastlivo_tpu_torch.parallel.launch.launch` runs each in spawned gloo
ranks on the CPU, which import this module by name: it imports torch,
numpy and the port only, never JAX. Inputs and results are numpy arrays
and plain values.
"""
import os
import time

import numpy as np
import torch

from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch.ops import tiled_map as tm
from fastlivo_tpu_torch.parallel.launch import replay_rank
from fastlivo_tpu_torch.parallel import sharded_map as sm
from fastlivo_tpu_torch.parallel.product import MeshRunner
from fastlivo_tpu_torch.parallel.sharded import (
    make_mesh, sharded_lio_update, sharded_scan_step)
from fastlivo_tpu_torch.parallel.sharded_backend import ShardedTiledBackend


def t(a):
    return torch.as_tensor(np.asarray(a))


def arrays(nt) -> dict:
    return convert.tiled_map_to_arrays(nt)


def numpy(xs):
    return [x.numpy() if isinstance(x, torch.Tensor) else x for x in xs]


def lio_rank(rank, n, state, tmap, scan, kw):
    """sharded_lio_update on a replicated tiled map."""
    mesh = make_mesh(n, device="cpu")
    res = sharded_lio_update(
        mesh, convert.state_from_arrays(state, "cpu"),
        convert.tiled_map_from_arrays(tmap, "cpu"), t(scan),
        torch.ones(len(scan), dtype=torch.bool), torch.eye(3), torch.zeros(3), **kw)
    return dict(state=convert.state_to_arrays(res.state), n_active=int(res.n_active),
                iters=res.iters, pts_world=res.pts_world.numpy(),
                active=res.active.numpy(), res=res.res.numpy(),
                collectives=mesh.collectives)


def scan_step_rank(rank, n, state, tmap, prop, calib, scan, t_rel, kw):
    """sharded_scan_step (propagate, undistort, EKF, insert)."""
    mesh = make_mesh(n, device="cpu")
    m = convert.tiled_map_from_arrays(tmap, "cpu")
    st, m2, n_act, acc_l, ang_l = sharded_scan_step(
        mesh, convert.state_from_arrays(state, "cpu"), m,
        *[t(prop[k]) for k in ("acc", "gyr", "dt", "offs", "valid", "tail",
                               "acc_s_last", "angvel_last")],
        convert.calib_from_arrays(calib, "cpu"), t(scan), t(t_rel),
        torch.ones(len(scan), dtype=torch.bool), **kw)
    return dict(state=convert.state_to_arrays(st), n_active=int(n_act),
                map=arrays(m2), acc_last=acc_l.numpy(), gyr_last=ang_l.numpy())


def sharded_map_rank(rank, n, world, mask, dims, pool, vs, lo, hi, k_exch, k_small,
                     queries, del_lo, del_hi):
    """The sharded-map library on this rank's shard: shard_insert,
    extract_blocks (budgets k_exch and k_small), the halo snapshot and its
    kNN, delete + compact."""
    mesh = make_mesh(n, device="cpu")
    local = sm.make_shards(mesh, dims, pool, vs)
    local = sm.shard_insert(local, t(world), t(mask), rank, n)
    out = dict(shard=arrays(local))
    out["blocks"] = numpy(sm.extract_blocks(local, t(lo), t(hi), k_exch))
    out["small"] = numpy(sm.extract_blocks(local, t(lo), t(hi), k_small))
    snap, dropped = sm.exchange_snapshot(local, t(lo), t(hi), k_exch, mesh, dir_dims=dims)
    out["snap"], out["dropped"] = arrays(snap), int(dropped)
    out["knn"] = numpy(tm.knn(snap, t(queries), 5, 1))
    tm.delete_boxes(local, t(del_lo), t(del_hi))
    out["compact"] = arrays(sm.sharded_compact(local))
    return out


def backend_rank(rank, n, dims, pool_total, vs, batches, box_lo, box_hi):
    """Every ShardedTiledBackend operation, the shard after each."""
    be = ShardedTiledBackend(make_mesh(n, device="cpu"))
    shard = be.empty(dims, pool_total, vs)
    for pts, mask in batches:
        shard = be.insert(shard, t(pts), t(mask))
    out = dict(inserted=arrays(shard), points=be.extract_points(shard)[0],
               occupancy=be.max_occupancy(shard), pool=be.pool_per_shard(shard))
    shard = be.delete_boxes(shard, t(box_lo), t(box_hi))
    out["deleted"] = arrays(shard)
    shard = be.compact(shard)
    out["compacted"] = arrays(shard)
    out["points_after"] = be.extract_points(shard)[0]
    return out


def frame_step_rank(rank, n, sharded, world, dims, pool, vs, state, pose, calib, raw,
                    t_rel, rmask, fss, kw, halo_tiles=256):
    """One MeshRunner.lidar_frame_step on a map built from `world`:
    replicated (tiled_map.insert on every rank) or sharded."""
    mesh = make_mesh(n, device="cpu")
    wmask = torch.ones(len(world), dtype=torch.bool)
    if sharded:
        be = ShardedTiledBackend(mesh)
        m = be.insert(be.empty(dims, pool, vs), t(world), wmask)
    else:
        m = tm.insert(tm.empty_tiled_map(dims, pool, vs, device="cpu"), t(world), wmask)
    runner = MeshRunner(mesh, sharded_map=sharded, halo_tiles=halo_tiles, snap_dims=dims)
    (st, m2, down, dmask, n_act, iters, dense, active, stats) = runner.lidar_frame_step(
        convert.state_from_arrays(state, "cpu"), m,
        convert.pose_table_from_arrays(pose, "cpu"),
        convert.calib_from_arrays(calib, "cpu"), t(raw), t(t_rel), t(rmask),
        torch.tensor(fss, dtype=torch.float32), **kw)
    return dict(state=convert.state_to_arrays(st), map=arrays(m2), down=down.numpy(),
                dmask=dmask.numpy(), n_active=int(n_act), iters=iters,
                dense=dense.numpy(), active=active.numpy(), stats=stats.numpy())


def collectives_rank(rank, n):
    """Each Mesh collective on rank-dependent inputs."""
    mesh = make_mesh(n, device="cpu")
    rng = np.random.default_rng(rank)
    part = torch.as_tensor(rng.normal(size=(6, 7)).astype(np.float32))
    out = dict(part=part.numpy(), psum=mesh.psum(part).numpy(),
               gather=mesh.all_gather(torch.full((2, 3), float(rank))).numpy(),
               rows=mesh.all_gather_rows(torch.full((rank + 1, 2), rank)).numpy(),
               flags=mesh.all_gather(torch.tensor([rank % 2 == 0])).numpy(),
               sum=int(mesh.all_reduce(torch.tensor(rank + 1, dtype=torch.int32))),
               min=float(mesh.all_reduce(torch.tensor(float(rank) - 0.5), "min")),
               max=float(mesh.all_reduce(torch.tensor(float(rank) - 0.5), "max")))
    out["collectives"] = mesh.collectives
    return out


def failing_rank(rank, n):
    """Rank 1 raises; the others wait in a collective it never joins."""
    mesh = make_mesh(n, device="cpu")
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    mesh.all_reduce(torch.tensor(1))


def sleeping_rank(rank, n, seconds):
    make_mesh(n, device="cpu")
    time.sleep(seconds if rank == 0 else 0)
    return rank


def stranded_rank(rank, n):
    """Rank 1 waits in a collective that rank 0, busy for longer than the
    group's timeout, has not reached."""
    mesh = make_mesh(n, device="cpu")
    if rank == 0:
        time.sleep(30)
    mesh.all_reduce(torch.tensor(1))


def exiting_rank(rank, n):
    make_mesh(n, device="cpu")
    if rank == 1:
        os._exit(3)
    return rank


def mesh_of(rank, n, size):
    return repr(make_mesh(size, device="cpu"))


def frame_steps_rank(rank, n, *args):
    """frame_step_rank with the replicated map, then the sharded one."""
    return [frame_step_rank(rank, n, sharded, *args) for sharded in (False, True)]


def pipelines_rank(rank, n, cfg, scans, imu):
    """replay_rank with the replicated map, then the sharded one."""
    return [replay_rank(rank, n, cfg, scans, imu, "cpu", sharded) for sharded in (False, True)]


def refusals_rank(rank, n, cfg):
    """The messages of what a mesh refuses: the camera, a sharded map on
    another backend or restoring a checkpoint, the camera step, padded
    capacities the mesh size does not divide."""
    import dataclasses

    from fastlivo_tpu_torch.pipeline import Pipeline

    mesh = make_mesh(n, device="cpu")

    def message(fn):
        try:
            fn()
        except (ValueError, NotImplementedError) as e:
            return f"{type(e).__name__}: {e}"
        return None

    def with_cap(**kw):
        c = dataclasses.replace(cfg, capacity=dataclasses.replace(cfg.capacity, **kw))
        return c

    out = dict(
        camera=message(lambda: Pipeline(dataclasses.replace(cfg, img_enable=True),
                                        mesh=mesh)),
        backend=message(lambda: Pipeline(with_cap(map_backend="hash"), mesh=mesh,
                                         sharded_map=True)),
        vio_step=message(lambda: MeshRunner(mesh).vio_frame_step()),
        max_points=message(lambda: MeshRunner(mesh).check_capacity(
            with_cap(max_points=1001).capacity)),
        frame_ring=message(lambda: MeshRunner(mesh, sharded_map=True).check_capacity(
            with_cap(frame_ring=7).capacity)),
        frame_ring_replicated=message(lambda: MeshRunner(mesh).check_capacity(
            with_cap(frame_ring=7).capacity)))
    pipe = Pipeline(cfg, mesh=mesh, sharded_map=True)
    out["warm_start"] = message(lambda: pipe.warm_start(pipe.state, pipe.map))
    out["profile"] = pipe._profile_stages(None, None, None, None)
    return out


def blockmap_step_rank(rank, n, world, mask, dims, pool, vs, state, prop, calib, scan,
                       t_rel, kw):
    """sharded_blockmap_scan_step on shards built from `world`."""
    mesh = make_mesh(n, device="cpu")
    local = sm.shard_insert(sm.make_shards(mesh, dims, pool, vs), t(world), t(mask), rank, n)
    st, local2, n_act, snap_tiles = sm.sharded_blockmap_scan_step(
        mesh, convert.state_from_arrays(state, "cpu"), local,
        *[t(prop[k]) for k in ("acc", "gyr", "dt", "offs", "valid", "tail",
                               "acc_s_last", "angvel_last")],
        convert.calib_from_arrays(calib, "cpu"), t(scan), t(t_rel),
        torch.ones(len(scan), dtype=torch.bool), **kw)
    return dict(state=convert.state_to_arrays(st), shard=arrays(local2),
                n_active=int(n_act), snap_tiles=int(snap_tiles))
