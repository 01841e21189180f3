"""Port parity: the LIO iterated EKF update and the per-scan frame step.

On the scene of tests/test_pallas_lio.py (a rippled ground plane in a
tiled map), the port's `lio_update` (its kernel's plain version on the
CPU) against both JAX branches (`pallas_knn` on and off): posterior pos
atol 1e-5, rot atol 1e-6, `iters` equal, `n_active` within 1%. The frame
step adds undistortion, the voxel filter and the map insert.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fastlivo_tpu import imu as jimu
from fastlivo_tpu import lio as jlio
from fastlivo_tpu.frame_step import lidar_frame_step as jstep
from fastlivo_tpu.frame_step import stage_scan as jstage
from fastlivo_tpu.ops import tiled_map as jtm
from fastlivo_tpu.state import identity_state

from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch import lio as tlio
from fastlivo_tpu_torch.frame_step import lidar_frame_step as tstep
from fastlivo_tpu_torch.frame_step import stage_scan as tstage
from fastlivo_tpu_torch.ops import tiled_map as ttm


def _arrays(nt):
    return {k: np.array(v) for k, v in nt._asdict().items()}


def _scene(seed=2, n_scan=2048):
    rng = np.random.default_rng(seed)
    world = np.stack([
        rng.uniform(-10, 10, 6000),
        rng.uniform(-10, 10, 6000),
        np.abs(np.sin(0.3 * rng.uniform(-10, 10, 6000))) * 0.05,
    ], axis=1).astype(np.float32)
    idx = rng.choice(len(world), n_scan, replace=False)
    scan = world[idx] + rng.normal(0, 0.005, (n_scan, 3)).astype(np.float32)
    s = identity_state()._replace(
        pos=jnp.asarray([0.02, -0.015, 0.01]),
        cov=jnp.eye(18, dtype=jnp.float64) * 0.01,
    )
    return world, scan, s


def _compare_state(st, sj, pos_atol=1e-5, rot_atol=1e-6):
    np.testing.assert_allclose(st.pos.numpy(), np.asarray(sj.pos), atol=pos_atol)
    np.testing.assert_allclose(st.rot.numpy(), np.asarray(sj.rot), atol=rot_atol)


@pytest.mark.parametrize("pallas_knn", [True, False])
@pytest.mark.parametrize("max_iter", [4, 2])
def test_lio_update_matches_jax(pallas_knn, max_iter):
    world, scan, s = _scene()
    mj = jtm.build_host(world, (32, 32, 8), 1024, 0.5)
    mt = ttm.build_host(world, (32, 32, 8), 1024, 0.5, device="cpu")
    pmask = np.ones(len(scan), bool)
    pmask[::17] = False
    kw = dict(laser_point_cov=0.001, max_iter=max_iter, knn_radius=1)
    rj = jlio.lio_update(s, mj, jnp.asarray(scan), jnp.asarray(pmask),
                         jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32),
                         pallas_knn=pallas_knn, **kw)
    st = convert.state_from_arrays(_arrays(s), "cpu")
    rt = tlio.lio_update(st, mt, torch.from_numpy(scan), torch.from_numpy(pmask),
                         torch.eye(3), torch.zeros(3), **kw)
    _compare_state(rt.state, rj.state)
    np.testing.assert_allclose(rt.state.cov.numpy(), np.asarray(rj.state.cov),
                               rtol=1e-4, atol=1e-9)
    assert rt.iters == int(rj.iters)
    a_j, a_t = int(rj.n_active), int(rt.n_active)
    assert a_j > 1000 and abs(a_t - a_j) <= 0.01 * a_j, (a_t, a_j)
    assert not rt.active.numpy()[~pmask].any()
    np.testing.assert_allclose(rt.pts_world.numpy(), np.asarray(rj.pts_world), atol=1e-5)


def test_lio_rejects_deferred_options():
    world, scan, s = _scene()
    mt = ttm.build_host(world, (32, 32, 8), 1024, 0.5, device="cpu")
    st = convert.state_from_arrays(_arrays(s), "cpu")
    args = (st, mt, torch.from_numpy(scan), torch.ones(len(scan), dtype=torch.bool),
            torch.eye(3), torch.zeros(3), 0.001)
    with pytest.raises(NotImplementedError, match="ref"):
        tlio.lio_update(*args, plane_fit="ref")
    with pytest.raises(NotImplementedError, match="cache_knn"):
        tlio.lio_update(*args, cache_knn=True)
    with pytest.raises(NotImplementedError, match="dense"):
        tlio.check_supported("dense")


def _calib():
    return jimu.ImuCalib(
        acc_scale=jnp.float32(1.0), cov_acc=jnp.full(3, 0.01, jnp.float32),
        cov_gyr=jnp.full(3, 0.001, jnp.float32),
        cov_bias_acc=jnp.full(3, 1e-5, jnp.float32),
        cov_bias_gyr=jnp.full(3, 1e-5, jnp.float32),
        lid_rot=jnp.eye(3, dtype=jnp.float32), lid_off=jnp.zeros(3, jnp.float32),
    )


def _pose(s, P=16):
    return jimu.PoseTable(
        offs=jnp.asarray(np.linspace(0, 0.1, P).astype(np.float32)),
        rot=jnp.tile(jnp.asarray(s.rot, jnp.float32)[None], (P, 1, 1)),
        pos=jnp.tile(jnp.asarray(s.pos, jnp.float32)[None], (P, 1)),
        vel=jnp.tile(jnp.asarray([0.04, -0.02, 0.01], jnp.float32), (P, 1)),
        acc=jnp.zeros((P, 3), jnp.float32),
        gyr=jnp.tile(jnp.asarray([0.005, 0.002, -0.01], jnp.float32), (P, 1)),
    )


def test_frame_step_matches_jax():
    world, scan, s = _scene(seed=5, n_scan=3000)
    rng = np.random.default_rng(6)
    R = 4096
    w = np.zeros((R + 1, 4), np.float32)
    w[:len(scan), :3] = scan
    w[:len(scan), 3] = np.sort(rng.uniform(0, 0.1, len(scan)))
    w[R, 0] = len(scan)
    pj, tj, mj_ = jstage(jnp.asarray(w), R=R)
    pt, tt, mt_ = tstage(torch.from_numpy(w), R=R)
    for a, b in ((pt, pj), (tt, tj), (mt_, mj_)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    calib, pose = _calib(), _pose(s)
    mapj = jtm.build_host(world, (32, 32, 8), 1024, 0.5)
    mapt = ttm.build_host(world, (32, 32, 8), 1024, 0.5, device="cpu")
    outj = jstep(s, mapj, pose, calib, pj, tj, mj_, jnp.float32(0.3),
                 laser_point_cov=0.001, max_points=R, max_iter=4, knn_radius=1,
                 max_probe=0, pallas_knn=True)
    outt = tstep(convert.state_from_arrays(_arrays(s), "cpu"), mapt,
                 convert.pose_table_from_arrays(_arrays(pose), "cpu"),
                 convert.calib_from_arrays(_arrays(calib), "cpu"), pt, tt, mt_,
                 torch.tensor(0.3), laser_point_cov=0.001, max_points=R,
                 max_iter=4, knn_radius=1)
    _compare_state(outt[0], outj[0])
    np.testing.assert_array_equal(outt[3].numpy(), np.asarray(outj[3]))  # dmask
    np.testing.assert_allclose(outt[2].numpy(), np.asarray(outj[2]), rtol=1e-6, atol=1e-5)
    assert outt[5] == int(outj[5])
    np.testing.assert_allclose(outt[6].numpy(), np.asarray(outj[6]), atol=1e-4)  # dense
    stats_t, stats_j = outt[8].numpy(), np.asarray(outj[8])
    assert stats_t.shape == (29,) and stats_t.dtype == np.float64
    np.testing.assert_array_equal(stats_t[[0, 2, 28]], stats_j[[0, 2, 28]])
    assert abs(stats_t[1] - stats_j[1]) <= 0.01 * stats_j[1]
    np.testing.assert_allclose(stats_t[3:27], stats_j[3:27], atol=1e-5)
    np.testing.assert_allclose(stats_t[27], stats_j[27], rtol=1e-2)
    # the insert at the posterior leaves the same map up to points whose
    # posterior positions differ at float32 rounding
    mt2, mj2 = convert.tiled_map_to_arrays(outt[1]), _arrays(outj[1])
    for f in ("dir_check", "dir_slot", "slot_key", "n_alloc", "n_dropped"):
        np.testing.assert_array_equal(mt2[f], mj2[f], err_msg=f)
    assert (mt2["cell_check"] != mj2["cell_check"]).mean() < 1e-4
    np.testing.assert_allclose(mt2["pts"], mj2["pts"], atol=1e-4)


@pytest.mark.parametrize("mode", ["ref", "clamped"])
def test_local_map_tracker_matches_jax(mode):
    rng = np.random.default_rng(7)
    pos = np.cumsum(rng.normal(0, 4.0, (60, 3)), axis=0)
    for cube in (20.0, 200.0, 1000.0):
        tj, tt = jlio.LocalMapTracker(cube, mode), tlio.LocalMapTracker(cube, mode)
        for p in pos:
            assert tt.update(p) == tj.update(p)
        assert (tt.vmin, tt.vmax) == (tj.vmin, tj.vmax)
