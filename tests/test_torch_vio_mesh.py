"""Port parity: the camera frame's stages over a device mesh, as gloo
ranks on the CPU (tests/torch_mesh_ranks.py::vio_stages_rank) against
the JAX package's `axis_name` / `vmap_axis` / `obs_axis` forms under
shard_map on the conftest's virtual CPU devices, at meshes of 2 and 4
(the whole camera frame at 2).

Two scenes, each a visual map populated by the JAX package's `Vio` over
three rendered frames and a next frame at a perturbed prior: a 320x256
camera at grid 32 (G = 80 cells) and a 288x224 one (G = 63, which
neither mesh size divides, so the cell slabs are padded). Tolerances:
  - select_tracked, with the map replicated and with the pool and rings
    in slabs, and select_new_points: every rank's output equals the
    port's single-device output (its rows of the padded cell slab) bit
    for bit; against JAX's mesh forms, idx, valid, search_level,
    cell_value and the add mask equal, patches within 1e-3, positions
    within rtol 1e-6 (the single-device parity bounds);
  - photometric_update_levels(mesh=) and sharded_photometric_update:
    pos atol 1e-5, rot and cov atol 1e-6, `iters` equal; one collective
    per iteration;
  - MeshRunner.vio_frame_step, replicated and sharded: the state as
    above, n_pts and the tracked idx / valid equal, each rank's slabs
    equal to JAX's rows of the same range (integers exactly, floats
    within 1e-5);
  - the visual map's owner forms (slot refcounts, ring gather, push
    slot, push, a point batch, the close-view choice, an observation
    batch, compaction): exact against JAX's (its obs_axis forms, and for
    push and compact the whole-map function cut into the same rows);
  - every rank bit-identical in every replicated output.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from fastlivo_tpu import vio as jvio
from fastlivo_tpu import visual_map as jvm
from fastlivo_tpu.config import CameraConfig as JCameraConfig
from fastlivo_tpu.config import CapacityConfig as JCapacity
from fastlivo_tpu.config import Config as JConfig
from fastlivo_tpu.ops import so3 as jso3
from fastlivo_tpu.ops.voxel_filter import voxel_downsample_device as jvoxel
from fastlivo_tpu.parallel import sharded as jsharded
from fastlivo_tpu.parallel.product import MeshRunner as JRunner
from fastlivo_tpu.state import identity_state as jidentity

from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch import vio as tvio
from fastlivo_tpu_torch import visual_map as tvm
from fastlivo_tpu_torch.config import CameraConfig, CapacityConfig, Config
from fastlivo_tpu_torch.io.synthetic import SyntheticDataset
from fastlivo_tpu_torch.parallel.launch import launch

import torch_mesh_ranks as ranks

F = 200.0
SIZES = {"G80": (320, 256), "G63": (288, 224)}
INT_FIELDS = ("n_obs", "n_pts", "obs_slot", "obs_fid", "obs_level", "vox_keys",
              "vox_count", "vox_idx", "img_fid", "imgs")


def make_cfg(cfg_cls, cam_cls, cap_cls, W, H):
    cfg = cfg_cls()
    cfg.camera = cam_cls(width=W, height=H, fx=F, fy=F, cx=(W - 1) / 2.0,
                         cy=(H - 1) / 2.0, d=[0.0, 0.0, 0.0, 0.0])
    cfg.grid_size = 32
    cfg.patch_size = 8
    cfg.outlier_threshold = 300.0
    cfg.img_point_cov = 30.0
    cfg.max_iteration = 6
    cfg.capacity = cap_cls(vmap_points=4096, vmap_table_size=1 << 14,
                           vmap_voxel_cap=8, frame_ring=8, max_cands=4096,
                           max_raw_points=8192)
    return cfg


def jstate(ds, t, dpos=(0.0, 0.0, 0.0), drot=(0.0, 0.0, 0.0)):
    rot, pos = ds.traj.pose(t)
    return jidentity()._replace(rot=jnp.asarray(rot) @ jso3.exp(jnp.asarray(drot)),
                                pos=jnp.asarray(pos) + jnp.asarray(dpos))


def arrays(nt):
    return {f: np.array(v) for f, v in nt._asdict().items()}


def make_scene(key):
    """A populated JAX Vio and the next frame's inputs (numpy), with the
    JAX single-device tracked set."""
    W, H = SIZES[key]
    ds = SyntheticDataset(cam_size=(W, H), cam_f=F, cam_hz=10.0)
    jv = jvio.Vio(make_cfg(JConfig, JCameraConfig, JCapacity, W, H))
    for k, t in enumerate((2.0, 2.1, 2.2)):
        s = jstate(ds, t)
        jv.set_last_cloud(ds.room.sample_surface(6000, np.random.default_rng(k))
                          .astype(np.float32))
        jv.update(s, s, ds.render_image(t))
    assert int(jv.vmap.n_pts) > 50 and jv.last_stats["tracked"] > 10
    prior = jstate(ds, 2.3, dpos=(0.012, -0.01, 0.008), drot=(0.003, -0.002, 0.004))
    gray = jv._to_gray(ds.render_image(2.3))
    R = jv.cfg.capacity.max_raw_points
    cloud = np.zeros((R, 3), np.float32)
    c = ds.room.sample_surface(6000, np.random.default_rng(9)).astype(np.float32)
    cloud[:len(c)] = c
    rcw = (np.asarray(jv.Rci) @ np.asarray(prior.rot, np.float32).T).astype(np.float32)
    pcw = (-rcw @ np.asarray(prior.pos, np.float32) + np.asarray(jv.Pci)).astype(np.float32)
    mask = np.arange(R) < len(c)
    pg, pm = jax.jit(lambda a, m: jvoxel(a, m, 0.2, jv.max_pg))(cloud, mask)
    vox, vm = jvio._dedup_voxels(pg, pm, jv.max_pg // 2)
    statics = dict(outlier_threshold=jv._out_thre_dev, ncc_thre=jv._ncc_thre_dev,
                   grid_size=jv.grid_size, patch_size=jv.patch_size, gw=jv.gw, gh=jv.gh)
    sel = [jnp.asarray(a) for a in (rcw, pcw, gray, pg, pm, vox, vm)]
    single = jvio.select_tracked(jv.vmap, jv.cam, *sel, **statics)
    assert int(jnp.sum(single.valid)) > 10
    return dict(jv=jv, ds=ds, prior=prior, gray=gray, cloud=cloud, n=len(c), rcw=rcw,
                pcw=pcw, sel=sel, statics=statics, single=single,
                tcfg=make_cfg(Config, CameraConfig, CapacityConfig, W, H))


def ops_inputs(sc):
    """Inputs of the owner-form checks: point rows, a point batch, an
    observation batch, a compaction box."""
    jv = sc["jv"]
    rng = np.random.default_rng(3)
    n_pts = int(jv.vmap.n_pts)
    NP = jv.vmap.pos.shape[0]
    idx = np.concatenate([rng.choice(n_pts, 40, replace=False), [n_pts, NP - 1]]
                         ).astype(np.int32)
    B = 48
    pts = np.asarray(jv.vmap.pos)[:n_pts].mean(0) + rng.normal(0, 1.0, (B, 3))
    obs_idx = rng.choice(n_pts, 30, replace=False).astype(np.int32)
    rot, pos = sc["ds"].traj.pose(2.4)
    rcw = (np.asarray(jv.Rci) @ np.asarray(rot, np.float32).T).astype(np.float32)
    pcw = (-rcw @ np.asarray(pos, np.float32) + np.asarray(jv.Pci)).astype(np.float32)
    return dict(
        fid=int(jv.fid), idx=idx, campos=(-pcw @ rcw).astype(np.float32),
        img=sc["gray"], rcw=rcw, pcw=pcw,
        pts=pts.astype(np.float32), px=rng.uniform(50, 200, (B, 2)).astype(np.float32),
        value=rng.uniform(0, 100, B).astype(np.float32), mask=rng.random(B) < 0.8,
        obs_idx=obs_idx, obs_px=rng.uniform(50, 200, (30, 2)).astype(np.float32),
        obs_value=rng.uniform(0, 100, 30).astype(np.float32),
        obs_level=rng.integers(0, 3, 30).astype(np.int32), obs_mask=rng.random(30) < 0.7,
        center=np.asarray(jv.vmap.pos)[0].astype(np.float32), radius=np.float32(2.0))


@pytest.fixture(scope="module")
def scenes():
    out = {k: make_scene(k) for k in SIZES}
    out["G80"]["ops"] = ops_inputs(out["G80"])
    return out


def port_scene(sc, full):
    """What a rank program needs of a scene (numpy and the port Config)."""
    jv, tr = sc["jv"], sc["single"]
    meta = np.array([sc["n"], jv.fid], np.int32)
    return dict(cfg=sc["tcfg"], vmap=arrays(jv.vmap), gray=sc["gray"], rcw=sc["rcw"],
                pcw=sc["pcw"], pg=np.array(sc["sel"][3]), pg_mask=np.array(sc["sel"][4]),
                vox=np.array(sc["sel"][5]), vox_mask=np.array(sc["sel"][6]),
                cell_value=np.array(tr.cell_value), prior=arrays(sc["prior"]),
                tracked=arrays(tr), full=full, meta=meta, cloud=sc["cloud"],
                ops=sc.get("ops"))


def vm_spec(slabs: bool):
    obs = P("dp") if slabs else P()
    return jvm.VisualMap(**{f: P() for f in jvm.VisualMap._fields})._replace(
        **{f: obs for f in tvm.SLAB_FIELDS})


def smap(fn, mesh, in_specs, out_specs):
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                             check_vma=False))


def jax_mesh(sc, n, full):
    """The JAX package's mesh forms on scene `sc` at a mesh of n: the
    selection stages, and on a `full` scene the photometric update and
    the visual map's owner forms."""
    jv, mesh = sc["jv"], jsharded.make_mesh(n)
    shd = jvio.TrackedSet(idx=P("dp"), pos=P("dp"), patch=P("dp"), search_level=P("dp"),
                          valid=P("dp"), cell_value=P(), errors=P("dp"))
    out = {"tracked": {}}
    for pool in (False, True):
        fn = smap(functools.partial(jvio.select_tracked, axis_name="dp",
                                    vmap_axis="dp" if pool else None, **sc["statics"]),
                  mesh, (vm_spec(pool),) + (P(),) * 8, shd)
        out["tracked"][pool] = arrays(fn(jv.vmap, jv.cam, *sc["sel"]))
    kw = {k: sc["statics"][k] for k in ("grid_size", "patch_size", "gw", "gh")}
    fn = smap(functools.partial(jvio.select_new_points, axis_name="dp", **kw), mesh,
              (P(),) * 7, (P(),) * 4)
    out["new"] = [np.array(a) for a in fn(jv.cam, *sc["sel"][:5], sc["single"].cell_value)]
    if not full:
        return out
    tr = sc["single"]
    rep = jax.tree.map(lambda _: P(), sc["prior"])

    def levels(state, prior, img, ipc, tp, tpa, tsl, tv):
        return jvio.photometric_update_levels(
            state, prior, jv.cam, img, tp, tpa, tsl, tv, jv.Rci, jv.Pci, jv.Jdphi_dR,
            jv.Jdp_dR, img_point_cov=ipc, patch_size=jv.patch_size, levels=(2, 1, 0),
            max_iter=jv.cfg.max_iteration, axis_name="dp")

    fn = smap(levels, mesh, (rep, rep, P(), P()) + (P("dp"),) * 4,
              (rep, P(), P("dp"), P(), P()))
    gray = jnp.asarray(sc["gray"])
    out["photo"] = fn(sc["prior"], sc["prior"], gray, jv._ipc_dev, tr.pos, tr.patch,
                      tr.search_level, tr.valid)
    out["photo1"] = jsharded.sharded_photometric_update(
        mesh, sc["prior"], sc["prior"], jv.cam, gray, tr.pos, tr.patch, tr.search_level,
        tr.valid, jv.Rci, jv.Pci, jv.Jdphi_dR, jv.Jdp_dR,
        img_point_cov=jv.cfg.img_point_cov, patch_size=jv.patch_size, level=0, max_iter=4)
    out["ops"] = jax_ops(jv.vmap, sc["ops"], mesh)
    return out


def jax_ops(vm, a, mesh):
    """The JAX package's visual-map forms on the owner layout."""
    rep, sl = P(), vm_spec(True)
    fid = jnp.int32(a["fid"])
    out = dict(
        refs=np.array(smap(lambda m: jvm._live_slot_refs(m, "dp"), mesh, (sl,), rep)(vm)),
        gather=[np.array(x) for x in smap(lambda m, s: jvm._gather_obs(m, s, "dp"), mesh,
                                          (sl, rep), (rep,) * 6)(vm, a["idx"])],
        slot=int(smap(lambda m, f: jvm.push_slot(m, f, "dp"), mesh, (sl, rep), rep)(vm, fid)),
        push=arrays(jvm.push_image(vm, jnp.asarray(a["img"]), fid)))
    out["add_points"] = arrays(smap(
        lambda m, *x: jvm.add_points(m, *x, obs_axis="dp"), mesh, (sl,) + (rep,) * 7, sl)(
        vm, a["pts"], a["px"], a["rcw"], a["pcw"], a["value"], fid, a["mask"]))
    cv = smap(lambda m, i, c: jvm.close_view_obs(m, i, c, obs_axis="dp"), mesh,
              (sl, rep, rep), rep)(vm, a["idx"], a["campos"])
    out["close_view"] = {k: np.array(v) for k, v in cv.items()}
    out["add_observations"] = arrays(smap(
        lambda m, *x: jvm.add_observations(m, *x, obs_axis="dp"), mesh,
        (sl,) + (rep,) * 8, sl)(vm, a["obs_idx"], a["obs_px"], a["rcw"], a["pcw"],
                                a["obs_value"], fid, a["obs_level"], a["obs_mask"]))
    out["compact"] = arrays(jvm.compact(vm, jnp.asarray(a["center"]), a["radius"]))
    return out


def jax_frame_steps(sc, n):
    """JAX's MeshRunner.vio_frame_step, replicated and with the pool and
    rings sharded."""
    jv, mesh = sc["jv"], jsharded.make_mesh(n)
    meta = jnp.asarray(np.array([sc["n"], jv.fid], np.int32))
    out = {}
    for pool in (False, True):
        o = JRunner(mesh, sharded_map=pool).vio_frame_step(
            jv.vmap, jv.cam, sc["prior"], sc["prior"], jnp.asarray(sc["gray"]), meta,
            jnp.asarray(sc["cloud"]), jv.Rci, jv.Pci, jv.Jdphi_dR, jv.Jdp_dR,
            jv._out_thre_dev, jv._ncc_thre_dev, jv._ipc_dev, grid_size=jv.grid_size,
            patch_size=jv.patch_size, gw=jv.gw, gh=jv.gh, ncc_en=False,
            max_iter=jv.cfg.max_iteration, max_pg=jv.max_pg)
        out[pool] = dict(state=o[0], vmap=arrays(o[1]), idx=np.array(o[2]),
                         valid=np.array(o[3]), iters=int(o[9]), stats=np.array(o[10]))
    return out


@pytest.fixture(scope="module")
def steps(scenes):
    """The whole camera frame on the G = 80 scene at a mesh of 2."""
    n = 2
    port = launch(ranks.vio_stages_rank, n, ([port_scene(scenes["G80"], True)], True),
                  timeout=120, deadline=600)
    return n, [r[0] for r in port], jax_frame_steps(scenes["G80"], n)


@pytest.fixture(scope="module", params=[2, 4])
def runs(request, scenes):
    n = request.param
    port = launch(ranks.vio_stages_rank, n,
                  ([port_scene(scenes[k], k == "G80") for k in SIZES],),
                  timeout=120, deadline=600)
    jx = {k: jax_mesh(scenes[k], n, k == "G80") for k in SIZES}
    return n, port, jx


def single_port(sc):
    """The port's single-device select_tracked and select_new_points."""
    jv = sc["jv"]
    vm = convert.visual_map_from_arrays(arrays(jv.vmap), "cpu")
    tv = tvio.Vio(sc["tcfg"], device="cpu")
    kw = {k: sc["statics"][k] for k in ("grid_size", "patch_size", "gw", "gh")}
    sel = [torch.from_numpy(np.array(a)) for a in sc["sel"]]
    ts = tvio.select_tracked(vm, tv.cam, *sel, tv._out_thre_dev, tv._ncc_thre_dev, **kw)
    new = tvio.select_new_points(tv.cam, *sel[:5],
                                 torch.from_numpy(np.array(sc["single"].cell_value)), **kw)
    return ranks.vio_arrays(ts), [a.numpy() for a in new]


def slab_rows(a, rank, n):
    """Rank `rank`'s rows of `a` split in slabs of L = ceil(rows / n): the
    rows it holds that are not padding."""
    L = -(-a.shape[0] // n)
    return a[rank * L:(rank + 1) * L]


@pytest.mark.parametrize("pool", [False, True], ids=["replicated", "pool_sharded"])
@pytest.mark.parametrize("key", list(SIZES))
def test_select_tracked_matches_jax(scenes, runs, key, pool):
    n, port, jx = runs
    sc = scenes[key]
    want_single, _ = single_port(sc)
    ki = list(SIZES).index(key)
    for r in range(n):
        got = port[r][ki]["tracked"][pool]
        for f, v in got.items():
            if f == "cell_value":  # whole, the same on every rank
                np.testing.assert_array_equal(v, want_single[f], err_msg=f)
            else:  # this rank's cell slab of the single-device output
                w = slab_rows(want_single[f], r, n)
                np.testing.assert_array_equal(v[:len(w)], w, err_msg=f)
                if f == "valid":  # the padding rows track nothing
                    assert not v[len(w):].any()
        j = jx[key]["tracked"][pool]
        L = got["idx"].shape[0]
        rows = slice(r * L, (r + 1) * L)
        valid = got["valid"]
        np.testing.assert_array_equal(valid, j["valid"][rows])
        for f in ("idx", "search_level"):
            np.testing.assert_array_equal(got[f][valid], j[f][rows][valid], err_msg=f)
        np.testing.assert_array_equal(got["cell_value"], j["cell_value"])
        np.testing.assert_allclose(got["patch"][valid], j["patch"][rows][valid], atol=1e-3)
        np.testing.assert_allclose(got["pos"][valid], j["pos"][rows][valid], rtol=1e-6)
    assert want_single["valid"].sum() > 10


@pytest.mark.parametrize("key", list(SIZES))
def test_select_new_points_matches_jax(scenes, runs, key):
    n, port, jx = runs
    _, want = single_port(scenes[key])
    ki = list(SIZES).index(key)
    j = jx[key]["new"]
    for r in range(n):
        got = port[r][ki]["new"]
        for a, b in zip(got, want):  # whole outputs, the single device's bits
            np.testing.assert_array_equal(a, b)
        add = got[3]
        np.testing.assert_array_equal(add, j[3])
        np.testing.assert_array_equal(got[0][add], j[0][add])
        np.testing.assert_allclose(got[2][add], j[2][add], rtol=1e-4)
    assert want[3].sum() > 5
    # select_tracked twice (the winners' keys and values; with the pool in
    # slabs also the ring gathers and the patch sum), select_new_points once
    assert port[0][ki]["select_collectives"] == 2 + (2 + 2 + 1) + 1


def assert_state(got, want, cov=True):
    np.testing.assert_allclose(got["pos"], np.asarray(want.pos), atol=1e-5)
    np.testing.assert_allclose(got["rot"], np.asarray(want.rot), atol=1e-6)
    if cov:
        np.testing.assert_allclose(got["cov"], np.asarray(want.cov), atol=1e-6)


def test_photometric_update_levels_matches_jax(runs):
    n, port, jx = runs
    sj, Gj, perr_j, err_j, its_j = jx["G80"]["photo"]
    got = port[0][0]["photo"]
    assert got["iters"] == int(its_j) >= 3
    assert_state(got["state"], sj)
    np.testing.assert_allclose(got["G"], np.asarray(Gj), atol=1e-4)
    np.testing.assert_allclose(got["err"], float(err_j), rtol=1e-4)
    # one 44-float rank-order sum per iteration
    assert got["collectives"] == got["iters"]
    perr = np.concatenate([port[r][0]["photo"]["perr"] for r in range(n)])
    np.testing.assert_allclose(perr, np.asarray(perr_j), rtol=1e-4, atol=1e-3)
    for r in range(1, n):
        for f, v in port[r][0]["photo"]["state"].items():
            np.testing.assert_array_equal(v, got["state"][f], err_msg=f)
        assert port[r][0]["photo"]["err"] == got["err"]


def test_sharded_photometric_update_matches_jax(runs):
    n, port, jx = runs
    sj, Gj, perr_j, err_j, its_j = jx["G80"]["photo1"]
    got = port[0][0]["photo1"]
    assert got["iters"] == int(its_j) >= 1
    assert_state(got["state"], sj)
    np.testing.assert_allclose(got["G"], np.asarray(Gj), atol=1e-4)
    np.testing.assert_allclose(got["perr"], np.asarray(perr_j), rtol=1e-4, atol=1e-3)
    for r in range(1, n):
        np.testing.assert_array_equal(port[r][0]["photo1"]["perr"], got["perr"])
        np.testing.assert_array_equal(port[r][0]["photo1"]["state"]["pos"],
                                      got["state"]["pos"])


@pytest.mark.parametrize("pool", [False, True], ids=["replicated", "pool_sharded"])
def test_vio_frame_step_matches_jax(steps, pool):
    n, port, jx = steps
    j = jx[pool]
    got = port[0][pool]
    assert got["iters"] == j["iters"]
    assert_state(got["state"], j["state"], cov=False)
    np.testing.assert_allclose(got["state"]["cov"], np.asarray(j["state"].cov),
                               rtol=1e-3, atol=1e-10)
    np.testing.assert_array_equal(got["valid"], j["valid"])
    assert got["valid"].sum() > 10
    np.testing.assert_array_equal(got["idx"][got["valid"]], j["idx"][j["valid"]])
    np.testing.assert_array_equal(got["stats"][[0, 1, 3, 28]], j["stats"][[0, 1, 3, 28]])
    for r in range(n):
        mine = port[r][pool]
        for f in ("pos", "rot", "cov"):  # lockstep
            np.testing.assert_array_equal(mine["state"][f], got["state"][f], err_msg=f)
        np.testing.assert_array_equal(mine["stats"], got["stats"])
        for f, v in mine["vmap"].items():
            w = j["vmap"][f]
            if pool and f in tvm.SLAB_FIELDS:
                k = v.shape[0]
                assert k * n == w.shape[0], f
                w = w[r * k:(r + 1) * k]
            if f in INT_FIELDS:
                np.testing.assert_array_equal(v, w, err_msg=f)
            else:
                np.testing.assert_allclose(v, w, atol=1e-5, err_msg=f)


OPS = ["refs", "gather", "slot", "push", "add_points", "close_view", "add_observations",
       "compact"]


@pytest.fixture(scope="module")
def single_ops(scenes):
    """The port's whole-map forms of the owner-form checks."""
    sc = scenes["G80"]
    a = sc["ops"]
    t = torch.from_numpy
    whole = lambda: convert.visual_map_from_arrays(arrays(sc["jv"].vmap), "cpu")  # noqa: E731
    fid = torch.tensor(a["fid"], dtype=torch.int32)
    cv = tvm.close_view_obs(whole(), t(a["idx"]), t(a["campos"]))
    return dict(
        refs=tvm._live_slot_refs(whole()).numpy(),
        gather=[x.numpy() for x in tvm._gather_obs(whole(), t(a["idx"]))],
        slot=int(tvm.push_slot(whole(), fid)),
        push=ranks.vio_arrays(tvm.push_image(whole(), t(a["img"]), fid)),
        add_points=ranks.vio_arrays(tvm.add_points(
            whole(), t(a["pts"]), t(a["px"]), t(a["rcw"]), t(a["pcw"]), t(a["value"]), fid,
            t(a["mask"]))),
        close_view={k: v.numpy() for k, v in cv.items()},
        add_observations=ranks.vio_arrays(tvm.add_observations(
            whole(), t(a["obs_idx"]), t(a["obs_px"]), t(a["rcw"]), t(a["pcw"]),
            t(a["obs_value"]), fid, t(a["obs_level"]), t(a["obs_mask"]))),
        compact=ranks.vio_arrays(tvm.compact(whole(), t(a["center"]),
                                             torch.tensor(a["radius"]))))


def flat(x) -> dict:
    """An op's result as {name: array}."""
    if isinstance(x, dict):
        return x
    if isinstance(x, (list, tuple)):
        return {str(i): v for i, v in enumerate(x)}
    return {"": np.asarray(x)}


@pytest.mark.parametrize("op", OPS)
def test_visual_map_owner_forms_match_jax(runs, single_ops, op):
    """Each rank's result equals the port's whole-map form (a slab field:
    the rank's rows of it) bit for bit; the whole-map form matches JAX's
    owner form with integers equal and floats within 1e-6 (the
    single-device visual map's bound, tests/test_torch_visual_map.py)."""
    n, port, jx = runs
    want, ref = flat(single_ops[op]), flat(jx["G80"]["ops"][op])
    for r in range(n):
        got = flat(port[r][0]["ops"][op])
        assert got.keys() == want.keys()
        for f, v in got.items():
            w = want[f]
            if f in tvm.SLAB_FIELDS and op in ("push", "add_points", "add_observations",
                                               "compact"):
                k = v.shape[0]
                assert k * n == w.shape[0], f
                w = w[r * k:(r + 1) * k]
            np.testing.assert_array_equal(v, w, err_msg=f)
    for f, w in want.items():
        if w.dtype.kind == "f":
            np.testing.assert_allclose(w, ref[f], atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(w, ref[f], err_msg=f)
    if op == "refs":
        assert want[""].sum() > 0


@pytest.mark.parametrize("n", [2, 4])
def test_empty_visual_map_slabs(n):
    """`empty_visual_map(slabs=n)` allocates one rank's slabs and nothing
    more: every field equals each rank's `shard_slabs` of the whole empty
    map, and the slab fields hold 1/n of its rows."""
    kw = dict(n_points=64, n_obs=4, table_size=128, voxel_cap=4, ring=8, height=16,
              width=20, img_dtype=torch.uint8, device="cpu")
    whole = tvm.empty_visual_map(**kw)
    slab = tvm.empty_visual_map(**kw, slabs=n)
    for r in range(n):
        want = tvm.shard_slabs(whole, r, n)
        for f in tvm.VisualMap._fields:
            assert getattr(slab, f).dtype == getattr(want, f).dtype, f
            torch.testing.assert_close(getattr(slab, f), getattr(want, f), rtol=0, atol=0)
    for f in tvm.SLAB_FIELDS:
        assert getattr(slab, f).shape[0] * n == getattr(whole, f).shape[0], f
    with pytest.raises(ValueError, match="do not divide"):
        tvm.empty_visual_map(**{**kw, "ring": 6}, slabs=4)
