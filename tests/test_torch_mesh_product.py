"""Port parity: the LiDAR frame over a device mesh (parallel/product.py)
and `Pipeline(mesh=, sharded_map=)`, on gloo ranks against the JAX
package on the conftest's virtual CPU devices.

- One `MeshRunner.lidar_frame_step`, replicated and sharded, at meshes
  of 2 and 4 against JAX's: posterior pos atol 1e-5, rot and cov atol
  1e-6, `iters` and the downsampled batch equal, `n_active` within 2, the
  dense cloud within 1e-4, the map's (or each shard's) tiles equal; the
  ranks in lockstep, bit for bit.
- The slice as a whole: the port's Pipeline on a world of 2, with the
  map replicated and with `sharded_map=True`, against JAX's
  `Pipeline(cfg, mesh=make_mesh(2))` on the same ~2 s of synthetic scans
  and IMU: positions within 1 mm, quaternions within 1e-5; the sharded
  run's per-rank pool is half the replicated one's.
- The camera with a mesh: a LIVO Pipeline on a mesh of 2 holds the
  visual map as JAX's does (the image pool and the observation rings
  whole, or in per-rank slabs of JAX's shard shape with `sharded_map`),
  and a sharded visual map without a mesh is refused (the whole camera
  frame over a mesh: tests/test_torch_vio_mesh*.py).
- The refusals: a sharded map on another backend or restoring a
  checkpoint, and `check_capacity` with JAX's messages.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from fastlivo_tpu import imu as jimu
from fastlivo_tpu.config import Config as JConfig
from fastlivo_tpu.ops import so3 as jso3
from fastlivo_tpu.ops import tiled_map as jtm
from fastlivo_tpu.parallel.product import MeshRunner as JRunner
from fastlivo_tpu.parallel.sharded import make_mesh as jmake_mesh
from fastlivo_tpu.parallel.sharded_backend import ShardedTiledBackend as JBackend
from fastlivo_tpu.pipeline import Pipeline as JPipeline
from fastlivo_tpu.state import identity_state

from fastlivo_tpu_torch.config import Config
from fastlivo_tpu_torch.io.synthetic import SyntheticDataset
from fastlivo_tpu_torch.parallel.launch import launch

import torch_mesh_ranks as ranks
from test_lio import make_room_points, scan_from_pose

DIMS, POOL, VS = (64, 64, 32), 2048, 0.5
KW = dict(laser_point_cov=0.001, max_points=2048, max_iter=4, knn_radius=1, max_probe=8,
          dense_out=True)


def run(fn, n, *args):
    return launch(fn, n, args, timeout=120, deadline=400)


def arrays(nt):
    return {f: np.asarray(v) for f, v in nt._asdict().items()}


def mesh_cfg(cls):
    """tests/test_mesh_product.py::_pipeline_cfg(False)'s values, from
    `cls()` (either package's Config)."""
    cfg = cls()
    cfg.img_enable = False
    cfg.dense_map_enable = True
    cfg.capacity.max_raw_points = 8192
    cfg.capacity.max_points = 4096
    cfg.capacity.max_cands = 8192
    cfg.capacity.vmap_points = 4096
    cfg.capacity.frame_ring = 16
    return cfg


@pytest.fixture(scope="module")
def frame_inputs():
    world = make_room_points(step=0.15).astype(np.float32)
    rot_true = np.asarray(jso3.exp(jnp.asarray([0.02, -0.01, 0.05])))
    pos_true = np.array([0.3, -0.2, 1.1])
    rng = np.random.default_rng(1)
    R = 4096
    raw = np.zeros((R, 3), np.float32)
    raw[:3500] = scan_from_pose(world, rot_true, pos_true, n=3500, rng=rng, noise=0.003)
    t_rel = np.zeros(R, np.float32)
    t_rel[:3500] = np.linspace(0.0, 0.09, 3500)
    rmask = np.arange(R) < 3500
    state = identity_state()._replace(
        rot=jnp.asarray(rot_true @ np.asarray(jso3.exp(jnp.asarray([0.004, -0.003, 0.002])))),
        pos=jnp.asarray(pos_true + np.array([0.03, -0.02, 0.01])),
        cov=jnp.eye(18, dtype=jnp.float64) * 0.01)
    k = 8
    pose = jimu.PoseTable(
        offs=jnp.asarray(np.linspace(0, 0.1, k, dtype=np.float32)),
        rot=jnp.tile(state.rot.astype(jnp.float32)[None], (k, 1, 1)),
        pos=jnp.tile(state.pos.astype(jnp.float32)[None], (k, 1)),
        vel=jnp.zeros((k, 3), jnp.float32), acc=jnp.zeros((k, 3), jnp.float32),
        gyr=jnp.zeros((k, 3), jnp.float32))
    calib = jimu.ImuCalib(
        acc_scale=jnp.float32(1.0), cov_acc=jnp.full(3, 0.01, jnp.float32),
        cov_gyr=jnp.full(3, 0.001, jnp.float32),
        cov_bias_acc=jnp.full(3, 1e-5, jnp.float32),
        cov_bias_gyr=jnp.full(3, 1e-5, jnp.float32),
        lid_rot=jnp.eye(3, dtype=jnp.float32), lid_off=jnp.zeros(3, jnp.float32))
    return world, state, pose, calib, raw, t_rel, rmask


@pytest.fixture(scope="module", params=[2, 4])
def frame(request, frame_inputs):
    n = request.param
    world, state, pose, calib, raw, t_rel, rmask = frame_inputs
    mesh = jmake_mesh(n)
    fss = 0.3
    args = (state, None, pose, calib, jnp.asarray(raw), jnp.asarray(t_rel),
            jnp.asarray(rmask), jnp.float32(fss))
    jx = {}
    for sharded in (False, True):
        if sharded:
            be = JBackend(mesh)
            m = be.insert(be.empty(DIMS, POOL, VS), jnp.asarray(world),
                          jnp.ones(len(world), bool))
        else:
            m = jtm.insert(jtm.empty_tiled_map(DIMS, POOL, VS), jnp.asarray(world),
                           jnp.ones(len(world), bool))
        runner = JRunner(mesh, sharded_map=sharded, halo_tiles=256, snap_dims=DIMS)
        jx[sharded] = runner.lidar_frame_step(*args[:1], m, *args[2:], **KW)
    port = run(ranks.frame_steps_rank, n, world, DIMS, POOL, VS, arrays(state),
               arrays(pose), arrays(calib), raw, t_rel, rmask, fss, KW)
    return n, jx, port


@pytest.mark.parametrize("sharded", [False, True], ids=["replicated", "sharded"])
def test_lidar_frame_step_matches_jax(frame, sharded):
    n, jx, port = frame
    (jst, jm, jdown, jdmask, jn, jiters, jdense, jactive, jstats) = jx[sharded]
    mode = int(sharded)
    got = port[0][mode]
    for r in range(1, n):  # lockstep: the same bits on every rank
        for f, v in port[r][mode]["state"].items():
            np.testing.assert_array_equal(v, got["state"][f], err_msg=f)
        np.testing.assert_array_equal(port[r][mode]["stats"], got["stats"])
    np.testing.assert_allclose(got["state"]["pos"], np.asarray(jst.pos), atol=1e-5)
    np.testing.assert_allclose(got["state"]["rot"], np.asarray(jst.rot), atol=1e-6)
    np.testing.assert_allclose(got["state"]["cov"], np.asarray(jst.cov), atol=1e-6)
    assert got["iters"] == int(jiters)
    assert abs(got["n_active"] - int(jn)) <= 2 and got["n_active"] > 1000
    np.testing.assert_array_equal(got["dmask"], np.asarray(jdmask))
    np.testing.assert_allclose(got["down"], np.asarray(jdown), atol=1e-6)
    np.testing.assert_allclose(got["dense"], np.asarray(jdense), atol=1e-4)
    assert (got["active"] != np.asarray(jactive)).sum() <= 2
    np.testing.assert_allclose(got["stats"], np.asarray(jstats), atol=1e-4, rtol=1e-4)
    if sharded:
        for r in range(n):
            mine = port[r][mode]["map"]
            assert int(mine["n_alloc"]) == int(np.asarray(jm.n_alloc)[r])
            np.testing.assert_array_equal(mine["slot_key"], np.asarray(jm.slot_key)[r])
            assert int(mine["n_dropped"]) == int(np.asarray(jm.n_dropped)[r]) == 0
    else:
        assert int(got["map"]["n_alloc"]) == int(jm.n_alloc)
        np.testing.assert_array_equal(got["map"]["slot_key"], np.asarray(jm.slot_key))


@pytest.fixture(scope="module")
def pipelines():
    """~2 s of synthetic LIO (the data `run --synthetic` makes), recorded
    once and fed to JAX's mesh Pipeline and to the port's world of 2."""
    ds = SyntheticDataset(duration=2.0, points_per_scan=8192, lidar_noise=0.004)
    scans = [(b, p, r) for b, p, r in ds.lidar_scans_fast()]
    imu = list(ds.imu_stream())
    jp = JPipeline(mesh_cfg(JConfig), mesh=jmake_mesh(2))
    for b, p, r in scans:
        jp.push_lidar(b, p, r)
    for t, a, g in imu:
        jp.push_imu(t, a, g)
    jp.spin()
    jp.finish()
    port = run(ranks.pipelines_rank, 2, mesh_cfg(Config), scans, imu)
    return jp.tum_trajectory(), port


@pytest.mark.parametrize("sharded", [False, True], ids=["replicated", "sharded_map"])
def test_pipeline_world_of_two_matches_jax(pipelines, sharded):
    jtraj, port = pipelines
    got = [r[int(sharded)] for r in port]
    assert len(jtraj) >= 8 and len(got[0]["t"]) == len(jtraj)
    np.testing.assert_array_equal(got[0]["t"], jtraj[:, 0])
    np.testing.assert_array_equal(got[1]["pos"], got[0]["pos"])
    assert np.abs(got[0]["pos"] - jtraj[:, 1:4]).max() < 1e-3
    quat_j = jtraj[:, [7, 4, 5, 6]]  # TUM qx qy qz qw -> w x y z
    np.testing.assert_allclose(got[0]["quat"], quat_j, atol=1e-5)
    assert (got[0]["iters"] > 0).sum() >= 3  # the steady frames ran over the mesh
    for r in got:
        assert r["knn5_plane_tiled"] == 0  # the CPU takes the plain search
        assert r["collectives"] > 0 and r["n_dropped"] == 0


def test_sharded_pool_is_half_the_replicated(pipelines):
    _, port = pipelines
    rep, sh = port[0]
    assert sh["pool_tiles"] * 2 == rep["pool_tiles"] == Config().capacity.tiled_pool
    assert sh["map_bytes"] < 0.55 * rep["map_bytes"]
    np.testing.assert_array_equal(sh["pos"], rep["pos"])


@pytest.fixture(scope="module")
def refusals():
    return run(ranks.refusals_rank, 2, mesh_cfg(Config))[0]


def test_camera_with_a_mesh_is_refused(refusals):
    """The camera runs on a mesh now: each LIVO Pipeline of a world of 2
    lays its visual map out as JAX's `Pipeline(cfg, mesh=make_mesh(2))`
    does; what is still refused is a sharded visual map without a mesh
    (JAX: `vmap_axis` without `axis_name`)."""
    jmesh = jmake_mesh(2)
    for sharded, got in zip((False, True), refusals["camera"]):
        cfg = mesh_cfg(JConfig)
        cfg.img_enable = True
        jv = JPipeline(cfg, mesh=jmesh, sharded_map=sharded).vio
        assert got["pool_sharded"] == jv.pool_sharded == sharded
        for name in ("imgs", "obs_fid", "pos"):
            shard = jv.vmap._asdict()[name].addressable_shards[0].data.shape
            assert got[{"obs_fid": "obs"}.get(name, name)] == tuple(shard), name
        assert got["on_mesh_device"]
    assert refusals["camera"][1]["imgs"][0] * 2 == mesh_cfg(Config).capacity.frame_ring
    assert refusals["pool_without_mesh"] == (
        "ValueError: pool_sharded (the sharded visual map) requires a mesh")


def test_sharded_map_refusals(refusals):
    assert refusals["backend"] == ("ValueError: sharded_map requires the tiled map "
                                   "backend (map_backend='hash')")
    assert "cannot restore a single-device map checkpoint" in refusals["warm_start"]
    assert refusals["profile"] is None
    with pytest.raises(ValueError, match="sharded_map requires a mesh"):
        from fastlivo_tpu_torch.pipeline import Pipeline

        Pipeline(mesh_cfg(Config), device="cpu", sharded_map=True)


def test_check_capacity_matches_jax(refusals):
    """MeshRunner.check_capacity's refusals on a mesh of 2, word for word
    JAX's."""
    jmesh = jmake_mesh(2)
    for key, field, sharded in (("max_points", "max_points", False),
                                ("frame_ring", "frame_ring", True)):
        cfg = JConfig()
        setattr(cfg.capacity, field, 1001 if field == "max_points" else 7)
        with pytest.raises(ValueError) as e:
            JRunner(jmesh, sharded_map=sharded).check_capacity(cfg.capacity)
        assert refusals[key] == f"ValueError: {e.value}"
    assert refusals["frame_ring_replicated"] is None  # only the sharded map shards it
