"""Rank programs for the port's mesh tests (tests/test_torch_sharded*.py,
test_torch_mesh_product.py, test_torch_vio_mesh*.py).

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
from fastlivo_tpu_torch.visual_map import SLAB_FIELDS


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
    """The messages of what a mesh refuses (a sharded map on another
    backend or restoring a checkpoint, padded capacities the mesh size
    does not divide, a sharded visual map without a mesh), and the
    camera's layout on a mesh: each LIVO Pipeline's pool and ring shapes
    on this rank, replicated and with `sharded_map`."""
    import dataclasses

    from fastlivo_tpu_torch import vio as tvio
    from fastlivo_tpu_torch.pipeline import Pipeline

    mesh = make_mesh(n, device="cpu")

    def message(fn):
        try:
            fn()
        except ValueError as e:
            return f"{type(e).__name__}: {e}"
        return None

    def with_cap(**kw):
        c = dataclasses.replace(cfg, capacity=dataclasses.replace(cfg.capacity, **kw))
        return c

    out = dict(
        backend=message(lambda: Pipeline(with_cap(map_backend="hash"), mesh=mesh,
                                         sharded_map=True)),
        pool_without_mesh=message(lambda: tvio.select_tracked(
            *[None] * 11, grid_size=32, patch_size=8, gw=1, gh=1, pool_sharded=True)),
        max_points=message(lambda: MeshRunner(mesh).check_capacity(
            with_cap(max_points=1001).capacity)),
        frame_ring=message(lambda: MeshRunner(mesh, sharded_map=True).check_capacity(
            with_cap(frame_ring=7).capacity)),
        frame_ring_replicated=message(lambda: MeshRunner(mesh).check_capacity(
            with_cap(frame_ring=7).capacity)))
    livo = dataclasses.replace(cfg, img_enable=True)
    out["camera"] = []
    for sharded in (False, True):
        v = Pipeline(livo, mesh=mesh, sharded_map=sharded).vio
        out["camera"].append(dict(
            pool_sharded=v.pool_sharded, imgs=tuple(v.vmap.imgs.shape),
            obs=tuple(v.vmap.obs_fid.shape), pos=tuple(v.vmap.pos.shape),
            on_mesh_device=v.device == mesh.device))
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


def vio_arrays(nt) -> dict:
    return {f: v.numpy().copy() for f, v in nt._asdict().items()}


def vio_stages_rank(rank, n, scenes, steps=False):
    """Each stage of the camera frame over the mesh, on each scene (the
    inputs tests/test_torch_vio_mesh.py makes): select_tracked with the
    map replicated and with the pool in slabs, select_new_points, and on
    a `full` scene the photometric cascade and sharded_photometric_update
    on the scene's tracked set and the visual map's owner forms on this
    rank's slabs; with `steps`, MeshRunner.vio_frame_step both ways
    instead."""
    from fastlivo_tpu_torch import vio as tvio
    from fastlivo_tpu_torch import visual_map as tvm
    from fastlivo_tpu_torch.parallel.sharded import sharded_photometric_update

    mesh = make_mesh(n, device="cpu")
    out = []
    for sc in scenes:
        v = tvio.Vio(sc["cfg"], device="cpu")
        whole = lambda: convert.visual_map_from_arrays(sc["vmap"], "cpu")  # noqa: E731
        slabs = lambda: tvm.shard_slabs(whole(), rank, n)  # noqa: E731
        kw = dict(grid_size=v.grid_size, patch_size=v.patch_size, gw=v.gw, gh=v.gh)
        prior = convert.state_from_arrays(sc["prior"], "cpu")
        if steps:
            out.append(frame_steps(mesh, v, prior, whole, slabs, sc, kw))
            continue
        c0 = mesh.collectives
        sel = (t(sc["rcw"]), t(sc["pcw"]), t(sc["gray"]), t(sc["pg"]), t(sc["pg_mask"]),
               t(sc["vox"]), t(sc["vox_mask"]), v._out_thre_dev, v._ncc_thre_dev)
        r = dict(tracked={})
        for pool in (False, True):
            ts = tvio.select_tracked(slabs() if pool else whole(), v.cam, *sel, **kw,
                                     mesh=mesh, pool_sharded=pool)
            r["tracked"][pool] = vio_arrays(ts)
        r["new"] = numpy(tvio.select_new_points(
            v.cam, *sel[:5], t(sc["cell_value"]), **kw, mesh=mesh))
        r["select_collectives"] = mesh.collectives - c0
        tr = [t(sc["tracked"][f]) for f in ("pos", "patch", "search_level", "valid")]
        if not sc["full"]:  # the selection stages only
            out.append(r)
            continue
        rows = [mesh.slab(a) for a in tr]
        c0 = mesh.collectives
        st, G, perr, err, its = tvio.photometric_update_levels(
            prior, prior, v.cam, t(sc["gray"]), *rows, v.Rci, v.Pci, v.Jdphi_dR,
            v.Jdp_dR, img_point_cov=v._ipc_dev, patch_size=v.patch_size,
            max_iter=sc["cfg"].max_iteration, mesh=mesh)
        r["photo"] = dict(state=convert.state_to_arrays(st), G=G.numpy(),
                          perr=perr.numpy(), err=float(err), iters=its,
                          collectives=mesh.collectives - c0)
        st, G, perr, err, its = sharded_photometric_update(
            mesh, prior, prior, v.cam, t(sc["gray"]), *tr, v.Rci, v.Pci, v.Jdphi_dR,
            v.Jdp_dR, float(sc["cfg"].img_point_cov), v.patch_size, level=0,
            max_iter=4)
        r["photo1"] = dict(state=convert.state_to_arrays(st), G=G.numpy(),
                           perr=perr.numpy(), err=float(err), iters=its)
        r["ops"] = visual_ops(mesh, slabs, sc["ops"])
        out.append(r)
    return out


def frame_steps(mesh, v, prior, whole, slabs, sc, kw):
    """MeshRunner.vio_frame_step with the map replicated and in slabs."""
    r = {}
    for pool in (False, True):
        runner = MeshRunner(mesh, sharded_map=pool)
        vm = slabs() if pool else whole()
        o = runner.vio_frame_step(
            vm, v.cam, prior, prior, t(sc["gray"]), t(sc["meta"]), t(sc["cloud"]),
            v.Rci, v.Pci, v.Jdphi_dR, v.Jdp_dR, v._out_thre_dev, v._ncc_thre_dev,
            v._ipc_dev, **kw, ncc_en=False, max_iter=sc["cfg"].max_iteration,
            max_pg=v.max_pg)
        r[pool] = dict(state=convert.state_to_arrays(o[0]), vmap=vio_arrays(o[1]),
                       idx=o[2].numpy(), valid=o[3].numpy(), perr=o[5].numpy(),
                       iters=o[9], stats=o[10].numpy())
    return r


def visual_ops(mesh, slabs, a):
    """visual_map's owner forms on this rank's slabs of the scene's map:
    the slot refcounts, the ring gather, the push slot and push, a point
    batch, the close-view choice, an observation batch and compaction."""
    from fastlivo_tpu_torch import visual_map as tvm

    fid = torch.tensor(a["fid"], dtype=torch.int32)
    r = dict(refs=tvm._live_slot_refs(slabs(), mesh).numpy(),
             gather=numpy(tvm._gather_obs(slabs(), t(a["idx"]), mesh)),
             slot=int(tvm.push_slot(slabs(), fid, mesh)))
    r["push"] = vio_arrays(tvm.push_image(slabs(), t(a["img"]), fid, mesh))
    r["add_points"] = vio_arrays(tvm.add_points(
        slabs(), t(a["pts"]), t(a["px"]), t(a["rcw"]), t(a["pcw"]), t(a["value"]), fid,
        t(a["mask"]), mesh=mesh))
    cv = tvm.close_view_obs(slabs(), t(a["idx"]), t(a["campos"]), mesh)
    r["close_view"] = {k: v.numpy() for k, v in cv.items()}
    r["add_observations"] = vio_arrays(tvm.add_observations(
        slabs(), t(a["obs_idx"]), t(a["obs_px"]), t(a["rcw"]), t(a["pcw"]),
        t(a["obs_value"]), fid, t(a["obs_level"]), t(a["obs_mask"]), mesh))
    r["compact"] = vio_arrays(tvm.compact(slabs(), t(a["center"]),
                                          torch.tensor(a["radius"]), mesh))
    return r


def livo_pipelines_rank(rank, n, cfg, scans, imu, images, ckpt_path, staged):
    """A LIVO Pipeline over the mesh with the map replicated, then with
    the map sharded and the visual map in slabs, on the same stream. Per
    run: the trajectory and counts of replay_rank's kind, the whole
    visual map (gathered), the load-factor compaction forced through
    Pipeline._maybe_rebuild (its whole map), a camera frame through
    Vio.update_staged (`staged`: a host world cloud and an image; the
    state and the whole map after it), and, sharded, a checkpoint
    written by rank 0 to `ckpt_path` (every rank joins its gathers)."""
    from fastlivo_tpu_torch import pipeline as pl
    from fastlivo_tpu_torch.io import checkpoint as ckpt

    mesh = make_mesh(n, device="cpu")
    out = []
    for sharded in (False, True):
        pipe = pl.Pipeline(cfg, mesh=mesh, sharded_map=sharded)
        for beg, pts, t_rel in scans:
            pipe.push_lidar(beg, pts, t_rel)
        for t_, acc, gyr in imu:
            pipe.push_imu(t_, acc, gyr)
        for t_, img in images:
            pipe.push_img(t_, img)
        c0 = mesh.collectives
        outs = pipe.spin() + pipe.finish()
        vm = pipe.vio.vmap
        r = dict(t=np.array([o.t for o in outs]), pos=np.array([o.pos for o in outs]),
                 quat=np.array([o.quat for o in outs]), vio_steps=pipe.vio.steps,
                 collectives=mesh.collectives - c0,
                 vmap_bytes=sum(x.numel() * x.element_size() for x in vm),
                 slab_bytes=sum(getattr(vm, f).numel() * getattr(vm, f).element_size()
                                for f in SLAB_FIELDS),
                 imgs_rows=vm.imgs.shape[0], obs_rows=vm.obs_fid.shape[0],
                 state_pos=pipe.state.pos.numpy().copy(),
                 whole=vio_arrays(pipe.vio.whole_vmap()))
        if sharded:
            arrays = pipe.checkpoint_arrays()
            if rank == 0:
                ckpt.write(ckpt_path, arrays)
        # the visual map's load-factor compaction, forced
        pipe._frames_since_rebuild_check = pl.REBUILD_CHECK_EVERY - 1
        pipe.vio._n_pts_host = cfg.capacity.vmap_points
        pipe._maybe_rebuild()
        r["compacted"] = vio_arrays(pipe.vio.whole_vmap())
        r["compacted_rows"] = pipe.vio.vmap.obs_fid.shape[0]
        cloud, img = staged
        pipe.vio.set_last_cloud(cloud)
        st = pipe.vio.update_staged(pipe.state, pipe.state, img)
        r["staged"] = dict(state=convert.state_to_arrays(st), stats=pipe.vio.last_stats,
                           whole=vio_arrays(pipe.vio.whole_vmap()),
                           obs_rows=pipe.vio.vmap.obs_fid.shape[0])
        out.append(r)
    return out


def livo_mesh_rank(rank, n, cfg, scans, imu, images, device=None):
    """parallel.launch.replay_rank with images, with the map replicated
    and then sharded (the visual map in slabs)."""
    from fastlivo_tpu_torch.parallel.launch import replay_rank

    return [replay_rank(rank, n, cfg, scans, imu, device, sharded, images)
            for sharded in (False, True)]
