"""Port parity: residual rows over a device mesh (parallel/sharded.py) and
the rank launcher (parallel/launch.py).

`sharded_lio_update` and `sharded_scan_step` on gloo ranks against the
JAX package's on the conftest's virtual CPU devices, at meshes of 2 and
4, on the room of tests/test_lio.py in a tiled map: posterior pos atol
1e-5, rot and cov atol 1e-6 (the f32 [HᵀH | Hᵀz] partials group
differently), `iters` equal, `n_active` within 2; every rank holds the
same state bit for bit (the partials are summed in rank order on every
rank), and the gathered per-point outputs are JAX's global arrays.

The launcher: results in rank order; the collectives' values; a rank
that raises, exits, or waits past the group's timeout fails the caller
within seconds; the deadline kills a rank that hangs; make_mesh checks
the world size.
"""
import time

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fastlivo_tpu import imu as jimu
from fastlivo_tpu.ops import so3 as jso3
from fastlivo_tpu.ops import tiled_map as jtm
from fastlivo_tpu.parallel import sharded as jsh
from fastlivo_tpu.state import identity_state

from fastlivo_tpu_torch.parallel import launch as launch_mod
from fastlivo_tpu_torch.parallel.launch import launch
from fastlivo_tpu_torch.parallel.sharded import make_mesh

import torch_mesh_ranks as ranks
from test_lio import make_room_points, scan_from_pose

MESHES = [2, 4]
KW = dict(laser_point_cov=0.001, max_iter=5, knn_radius=1)


def run(fn, n, *args, **kw):
    kw.setdefault("timeout", 120)
    kw.setdefault("deadline", 300)
    return launch(fn, n, args, **kw)


def arrays(nt):
    return {f: np.asarray(v) for f, v in nt._asdict().items()}


def padded(pts, multiple=256):
    pad = np.zeros((-(-len(pts) // multiple) * multiple, 3), np.float32)
    pad[:len(pts)] = pts
    return pad, np.arange(len(pad)) < len(pts)


@pytest.fixture(scope="module")
def room():
    world = make_room_points(step=0.15)
    pad, mask = padded(world)
    m = jtm.insert(jtm.empty_tiled_map((64, 64, 32), 2048, 0.5), jnp.asarray(pad),
                   jnp.asarray(mask))
    return world, m


def assert_states(port, jx, pos=1e-5, rot=1e-6):
    np.testing.assert_allclose(port["pos"], np.asarray(jx.pos), atol=pos)
    np.testing.assert_allclose(port["rot"], np.asarray(jx.rot), atol=rot)
    np.testing.assert_allclose(port["cov"], np.asarray(jx.cov), atol=1e-6)


def assert_lockstep(results):
    """Every rank's state, bit for bit."""
    for r in results[1:]:
        for f, v in r["state"].items():
            np.testing.assert_array_equal(v, results[0]["state"][f], err_msg=f)


@pytest.mark.parametrize("n", MESHES)
def test_sharded_lio_update_matches_jax(room, n):
    world, m = room
    rot_true = np.asarray(jso3.exp(jnp.asarray([0.03, -0.02, 0.1])))
    pos_true = np.array([0.4, -0.3, 1.2])
    rot0 = rot_true @ np.asarray(jso3.exp(jnp.asarray([0.01, 0.015, -0.01])))
    pos0 = pos_true + np.array([0.05, -0.04, 0.03])
    scan = scan_from_pose(world, rot_true, pos_true, n=2048)
    s = identity_state()._replace(rot=jnp.asarray(rot0), pos=jnp.asarray(pos0))
    jout = jsh.sharded_lio_update(
        jsh.make_mesh(n), s, m, jnp.asarray(scan), jnp.ones(len(scan), bool),
        jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32), **KW)
    port = run(ranks.lio_rank, n, arrays(s), arrays(m), scan, KW)
    assert_lockstep(port)
    got = port[0]
    assert_states(got["state"], jout.state)
    assert got["iters"] == int(jout.iters)
    assert abs(got["n_active"] - int(jout.n_active)) <= 2
    assert got["n_active"] > 1500
    np.testing.assert_allclose(got["pts_world"], np.asarray(jout.pts_world), atol=1e-4)
    assert (got["active"] != np.asarray(jout.active)).sum() <= 2
    assert np.linalg.norm(got["state"]["pos"] - pos_true) < 2e-2
    # two reductions per iteration's search-and-solve: the partials and,
    # at the end, the active count; three gathers of the per-point outputs
    assert got["collectives"] == got["iters"] + 1 + 3


@pytest.mark.parametrize("n", MESHES)
def test_sharded_scan_step_matches_jax(room, n):
    """Propagation, undistortion, the EKF and the replicated insert (the
    JAX package's test_full_scan_step_under_mesh, on the tiled map)."""
    world, m = room
    rng = np.random.default_rng(0)
    P, N = 16, 1024
    s = identity_state()._replace(pos=jnp.asarray([0.0, 0.0, 1.2]),
                                  grav=jnp.asarray([0.0, 0.0, -9.81]))
    calib = jimu.ImuCalib(
        acc_scale=jnp.float32(1.0), cov_acc=jnp.full(3, 0.01, jnp.float32),
        cov_gyr=jnp.full(3, 0.001, jnp.float32),
        cov_bias_acc=jnp.full(3, 1e-5, jnp.float32),
        cov_bias_gyr=jnp.full(3, 1e-5, jnp.float32),
        lid_rot=jnp.eye(3, dtype=jnp.float32), lid_off=jnp.zeros(3, jnp.float32))
    prop = dict(
        acc=np.tile(np.array([0.0, 0.0, 9.81], np.float32), (P, 1)),
        gyr=np.zeros((P, 3), np.float32), dt=np.full(P, 0.005, np.float32),
        offs=((np.arange(P) + 1) * 0.005).astype(np.float32), valid=np.ones(P, bool),
        tail=np.float32(0.0), acc_s_last=np.array([0.0, 0.0, 0.0], np.float32),
        angvel_last=np.zeros(3, np.float32))
    scan = scan_from_pose(world, np.eye(3), np.array([0.0, 0.0, 1.2]), n=N)
    t_rel = rng.uniform(0, 0.08, N).astype(np.float32)
    kw = dict(laser_point_cov=0.001, max_iter=3)
    jst, jm2, jn, jacc, jang = jsh.sharded_scan_step(
        jsh.make_mesh(n), s, m,
        *[jnp.asarray(prop[k]) for k in ("acc", "gyr", "dt", "offs", "valid", "tail",
                                         "acc_s_last", "angvel_last")],
        calib, jnp.asarray(scan), jnp.asarray(t_rel), jnp.ones(N, bool), **kw)
    port = run(ranks.scan_step_rank, n, arrays(s), arrays(m), prop, arrays(calib),
               scan, t_rel, kw)
    assert_lockstep(port)
    got = port[0]
    assert_states(got["state"], jst)
    assert abs(got["n_active"] - int(jn)) <= 2 and got["n_active"] > N // 2
    np.testing.assert_allclose(got["acc_last"], np.asarray(jacc), atol=1e-6)
    np.testing.assert_allclose(got["gyr_last"], np.asarray(jang), atol=1e-6)
    # the replicated insert: the same tiles, and every rank's map equal
    assert int(got["map"]["n_alloc"]) == int(jm2.n_alloc) >= int(m.n_alloc)
    np.testing.assert_array_equal(got["map"]["slot_key"], np.asarray(jm2.slot_key))
    for r in port[1:]:
        for f, v in r["map"].items():
            np.testing.assert_array_equal(v, got["map"][f], err_msg=f)


def test_mesh_collectives():
    n = 4
    res = run(ranks.collectives_rank, n)
    want = res[0]["part"].copy()
    for r in res[1:]:
        want += r["part"]  # rank order
    for r in res:
        np.testing.assert_array_equal(r["psum"], want)
        np.testing.assert_array_equal(
            r["gather"], np.repeat(np.arange(n, dtype=np.float32), 2)[:, None] * np.ones(3))
        np.testing.assert_array_equal(
            r["rows"], np.concatenate([np.full((k + 1, 2), k) for k in range(n)]))
        np.testing.assert_array_equal(r["flags"], [True, False, True, False])
        assert (r["sum"], r["min"], r["max"]) == (10, -0.5, 2.5)
        assert r["collectives"] == 8


def test_failing_rank_fails_the_caller():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed(.|\n)*rank 1 fails on purpose"):
        run(ranks.failing_rank, 2)
    assert time.monotonic() - t0 < 60


def test_rank_that_exits_fails_the_caller():
    with pytest.raises(RuntimeError, match="rank 1 exited with code 3"):
        run(ranks.exiting_rank, 2)


def test_stranded_collective_times_out():
    """A rank waiting past the group's timeout raises there, and the
    launcher fails before the late rank is done."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        run(ranks.stranded_rank, 2, timeout=3)
    assert time.monotonic() - t0 < 25


def test_deadline_kills_a_hung_rank():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[0\] still running"):
        run(ranks.sleeping_rank, 2, 120, deadline=8)
    assert time.monotonic() - t0 < 40
    assert run(ranks.sleeping_rank, 3, 0) == [0, 1, 2]


def test_make_mesh_checks_the_world():
    assert run(ranks.mesh_of, 2, 2) == [
        "Mesh(rank=0, size=2, device=cpu)", "Mesh(rank=1, size=2, device=cpu)"]
    with pytest.raises(RuntimeError, match="a mesh of 3 in a world of 2 ranks"):
        run(ranks.mesh_of, 2, 3)
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh(1, device="cpu")


def test_mesh_backend_refuses_missing_cards():
    assert launch_mod.mesh_backend("cpu", 4) == "gloo"
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"needs {visible + 1} cards"):
        launch_mod.mesh_backend(None, visible + 1)
    assert launch_mod.rank_device("cuda") is None and launch_mod.rank_device("cpu") == "cpu"
