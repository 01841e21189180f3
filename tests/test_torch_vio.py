"""Port parity: the camera frame (VIO) against the JAX package.

A visual map is populated by the JAX package's `Vio` over a few rendered
frames and carried across (convert.visual_map_from_arrays); a next frame
with a perturbed prior then goes through each stage of both packages on
the same inputs. Tolerances:
  - voxel filter of the frame's cloud: equal masks, centroids within
    1e-6; the deduplicated voxel set equal;
  - select_tracked: equal idx, valid and search_level; patches atol 1e-3;
  - select_new_points: equal add mask and picks;
  - photometric_update_levels: equal iteration count, rot within 1e-6,
    pos within 1e-5 (the port's gain is the exact f64 one, the JAX
    package's the mixed-precision one); G = K·HᵀH within 1e-4 and the
    posterior covariance within rtol 1e-3: HᵀH is taken at poses ~1e-6
    apart, and the image gradients change with the pixel position;
  - one iteration's measurement (ops/photometric.photometric_err_H_plain)
    at levels 0 and 2, each robust mode: per-point errors rtol 1e-4,
    mean error rtol 1e-5, G = K·HᵀH within 1e-4, the step's position
    within 2e-6 and rotation within 1e-6;
  - vio_frame_step: equal n_tracked and n_added; also at patch sizes 10
    and 16 (the camera-frame kernels' 128- and 256-wide trees) on the
    same map, at the same tolerances but for the covariance's off-diagonal
    terms, held to 1e-3 of sqrt(c_ii c_jj) (at 16 the cross terms near 0
    differ by up to 1.7e-3 of themselves, 6.5e-5 of that scale: more
    pixels summed at poses ~1e-6 apart);
  - with nothing tracked the photometric stage is an exact no-op;
  - render_overlay byte for byte; colorize's masks and colours equal on
    the same image, pose and points; last_bgr (the frame snapshot and its
    lazy resize) equal at 1x and 2x the camera's size;
  - update_staged against the JAX package's: equal tracked, added and
    map size, the frame step's bounds on the state, the overlay within
    0.5% of its pixels; against the port's fused update on forked states,
    the JAX package's own bounds (tests/test_vio.py).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastlivo_tpu import vio as jvio
from fastlivo_tpu.config import CameraConfig as JCameraConfig
from fastlivo_tpu.config import CapacityConfig as JCapacity
from fastlivo_tpu.config import Config as JConfig
from fastlivo_tpu.ops import so3 as jso3
from fastlivo_tpu.ops.voxel_filter import voxel_downsample_device as jvoxel
from fastlivo_tpu.state import identity_state as jidentity

from fastlivo_tpu_torch import convert
from fastlivo_tpu_torch import vio as tvio
from fastlivo_tpu_torch.config import CameraConfig, CapacityConfig, Config
from fastlivo_tpu_torch.io.synthetic import SyntheticDataset
from fastlivo_tpu_torch.ops import linalg, photometric, so3

W, H, F = 320, 256, 200.0


def make_cfg(cfg_cls, cam_cls, cap_cls):
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
    s = jidentity()
    return s._replace(rot=jnp.asarray(rot) @ jso3.exp(jnp.asarray(drot)),
                      pos=jnp.asarray(pos) + jnp.asarray(dpos))


def tstate(s):
    return convert.state_from_arrays({f: np.asarray(v) for f, v in s._asdict().items()}, "cpu")


def cloud(ds, seed, n=6000):
    return ds.room.sample_surface(n, np.random.default_rng(seed)).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    ds = SyntheticDataset(cam_size=(W, H), cam_f=F, cam_hz=10.0)
    jv = jvio.Vio(make_cfg(JConfig, JCameraConfig, JCapacity))
    for k, t in enumerate((2.0, 2.1, 2.2)):
        s = jstate(ds, t)
        jv.set_last_cloud(cloud(ds, k))
        jv.update(s, s, ds.render_image(t))
    assert int(jv.vmap.n_pts) > 50 and jv.last_stats["tracked"] > 10
    t1 = 2.3
    prior = jstate(ds, t1, dpos=(0.012, -0.01, 0.008), drot=(0.003, -0.002, 0.004))
    tcfg = make_cfg(Config, CameraConfig, CapacityConfig)
    tv = tvio.Vio(tcfg, device="cpu")
    tv.vmap = convert.visual_map_from_arrays(
        {f: np.asarray(v) for f, v in jv.vmap._asdict().items()}, "cpu")
    tv.fid = jv.fid
    gray = jv._to_gray(ds.render_image(t1))
    pts = np.zeros((tcfg.capacity.max_raw_points, 3), np.float32)
    c = cloud(ds, 9)
    pts[:len(c)] = c
    rot32 = np.asarray(prior.rot, np.float32)
    rcw = np.asarray(jv.Rci) @ rot32.T
    pcw = -rcw @ np.asarray(prior.pos, np.float32) + np.asarray(jv.Pci)
    return dict(ds=ds, jv=jv, tv=tv, prior=prior, gray=gray, cloud=pts,
                n=len(c), rcw=rcw.astype(np.float32), pcw=pcw.astype(np.float32))


def stage_inputs(sc):
    """The frame's downsampled cloud and voxel set, from the JAX package
    (its fused step passes the 0.2 m leaf as a constant)."""
    jv = sc["jv"]
    mask = np.arange(len(sc["cloud"])) < sc["n"]
    pg, pm = jax.jit(lambda c, m: jvoxel(c, m, 0.2, jv.max_pg))(sc["cloud"], mask)
    vox, vm = jvio._dedup_voxels(pg, pm, jv.max_pg // 2)
    return [np.array(a) for a in (pg, pm, vox, vm)], mask


def test_voxel_filter_and_dedup_match_jax(scene):
    (pg, pm, vox, vm), mask = stage_inputs(scene)
    c = torch.from_numpy(scene["cloud"])
    tpg, tpm = tvio.voxel_downsample_device(
        c, torch.from_numpy(mask), None, scene["tv"].max_pg,
        inv_leaf=torch.tensor(5.0))
    np.testing.assert_array_equal(tpm.numpy(), pm)
    np.testing.assert_allclose(tpg.numpy(), pg, rtol=1e-6, atol=1e-6)
    tvox, tvm = tvio._dedup_voxels(torch.from_numpy(pg), torch.from_numpy(pm), len(vm))
    np.testing.assert_array_equal(tvm.numpy(), vm)
    np.testing.assert_array_equal(tvox.numpy(), vox)
    assert vm.sum() > 100


def tracked_both(sc):
    (pg, pm, vox, vm), _ = stage_inputs(sc)
    jv, tv = sc["jv"], sc["tv"]
    kw = dict(grid_size=jv.grid_size, patch_size=jv.patch_size, gw=jv.gw, gh=jv.gh)
    tj = jvio.select_tracked(jv.vmap, jv.cam, jnp.asarray(sc["rcw"]), jnp.asarray(sc["pcw"]),
                             jnp.asarray(sc["gray"]), jnp.asarray(pg), jnp.asarray(pm),
                             jnp.asarray(vox), jnp.asarray(vm),
                             outlier_threshold=jv._out_thre_dev, ncc_thre=jv._ncc_thre_dev, **kw)
    t = torch.from_numpy
    tt = tvio.select_tracked(tv.vmap, tv.cam, t(sc["rcw"]), t(sc["pcw"]), t(sc["gray"]),
                             t(pg), t(pm), t(vox), t(vm), tv._out_thre_dev,
                             tv._ncc_thre_dev, **kw)
    return tj, tt, (pg, pm), kw


def test_select_tracked_matches_jax(scene):
    tj, tt, _, _ = tracked_both(scene)
    valid = np.asarray(tj.valid)
    assert valid.sum() > 10
    np.testing.assert_array_equal(tt.valid.numpy(), valid)
    np.testing.assert_array_equal(tt.idx.numpy(), np.asarray(tj.idx))
    np.testing.assert_array_equal(tt.search_level.numpy(), np.asarray(tj.search_level))
    np.testing.assert_allclose(tt.patch.numpy()[valid], np.asarray(tj.patch)[valid], atol=1e-3)
    np.testing.assert_allclose(tt.pos.numpy()[valid], np.asarray(tj.pos)[valid], rtol=1e-6)
    np.testing.assert_array_equal(tt.cell_value.numpy(), np.asarray(tj.cell_value))


def test_select_new_points_matches_jax(scene):
    tj, tt, (pg, pm), kw = tracked_both(scene)
    jv, tv = scene["jv"], scene["tv"]
    a = jvio.select_new_points(jv.cam, jnp.asarray(scene["rcw"]), jnp.asarray(scene["pcw"]),
                               jnp.asarray(scene["gray"]), jnp.asarray(pg), jnp.asarray(pm),
                               tj.cell_value, **kw)
    t = torch.from_numpy
    b = tvio.select_new_points(tv.cam, t(scene["rcw"]), t(scene["pcw"]), t(scene["gray"]),
                               t(pg), t(pm), tt.cell_value, **kw)
    add = np.asarray(a[3])
    np.testing.assert_array_equal(b[3].numpy(), add)
    np.testing.assert_array_equal(b[0].numpy()[add], np.asarray(a[0])[add])
    np.testing.assert_allclose(b[2].numpy()[add], np.asarray(a[2])[add], rtol=1e-4)


@pytest.mark.parametrize("robust", ["none", "huber", "tukey"])
def test_photometric_update_levels_matches_jax(scene, robust):
    tj, tt, _, _ = tracked_both(scene)
    jv, tv = scene["jv"], scene["tv"]
    prior = scene["prior"]
    args_j = (jv.Rci, jv.Pci, jv.Jdphi_dR, jv.Jdp_dR)
    fj = jax.jit(lambda s, p, tp, tpa, ts, tva: jvio.photometric_update_levels(
        s, p, jv.cam, jnp.asarray(scene["gray"]), tp, tpa, ts, tva, *args_j,
        img_point_cov=jv._ipc_dev, patch_size=8, levels=(2, 1, 0),
        max_iter=6, robust=robust))
    sj, Gj, _, ej, itj = fj(prior, prior, tj.pos, tj.patch, tj.search_level, tj.valid)
    pt = tstate(prior)
    st, Gt, _, et, itt = tvio.photometric_update_levels(
        pt, pt, tv.cam, torch.from_numpy(scene["gray"]), tt.pos, tt.patch,
        tt.search_level, tt.valid, tv.Rci, tv.Pci, tv.Jdphi_dR, tv.Jdp_dR,
        tv._ipc_dev, 8, levels=(2, 1, 0), max_iter=6, robust=robust)
    assert itt == int(itj) >= 3
    np.testing.assert_allclose(st.rot.numpy(), np.asarray(sj.rot), atol=1e-6)
    np.testing.assert_allclose(st.pos.numpy(), np.asarray(sj.pos), atol=1e-5)
    np.testing.assert_allclose(Gt.numpy(), np.asarray(Gj), atol=1e-4)
    np.testing.assert_allclose(float(et), float(ej), rtol=1e-4)
    # the update pulled the perturbed prior toward the truth
    _, pos_true = scene["ds"].traj.pose(2.3)
    assert np.linalg.norm(st.pos.numpy() - pos_true) < np.linalg.norm(
        np.asarray(prior.pos) - pos_true)


def test_photometric_update_one_level_matches_jax(scene):
    tj, tt, _, _ = tracked_both(scene)
    jv, tv = scene["jv"], scene["tv"]
    prior = scene["prior"]
    sj, _, _, _, itj = jvio.photometric_update(
        prior, prior, jv.cam, jnp.asarray(scene["gray"]), tj.pos, tj.patch,
        tj.search_level, tj.valid, jv.Rci, jv.Pci, jv.Jdphi_dR, jv.Jdp_dR,
        img_point_cov=jv._ipc_dev, patch_size=8, level=1, max_iter=6)
    pt = tstate(prior)
    st, _, _, _, itt = tvio.photometric_update(
        pt, pt, tv.cam, torch.from_numpy(scene["gray"]), tt.pos, tt.patch,
        tt.search_level, tt.valid, tv.Rci, tv.Pci, tv.Jdphi_dR, tv.Jdp_dR,
        tv._ipc_dev, patch_size=8, level=1, max_iter=6)
    assert itt == int(itj) >= 1
    np.testing.assert_allclose(st.rot.numpy(), np.asarray(sj.rot), atol=1e-6)
    np.testing.assert_allclose(st.pos.numpy(), np.asarray(sj.pos), atol=1e-5)


def test_photometric_update_runs_through_the_wrapper(scene, monkeypatch):
    """Every iteration's measurement goes through
    ops/photometric.photometric_err_H (the fused kernel's wrapper; on the
    CPU its plain version), once per iteration, at the level in force."""
    _, tt, _, _ = tracked_both(scene)
    tv = scene["tv"]
    calls = []
    real = tvio.photometric_err_H

    def spy(*a, **kw):
        calls.append(a[12])  # the pyramid level
        return real(*a, **kw)

    monkeypatch.setattr(tvio, "photometric_err_H", spy)
    pt = tstate(scene["prior"])
    _, _, _, _, its = tvio.photometric_update_levels(
        pt, pt, tv.cam, torch.from_numpy(scene["gray"]), tt.pos, tt.patch,
        tt.search_level, tt.valid, tv.Rci, tv.Pci, tv.Jdphi_dR, tv.Jdp_dR,
        tv._ipc_dev, 8, max_iter=6)
    assert len(calls) == its >= 3 and real is photometric.photometric_err_H
    assert calls[0] == 2 and calls[-1] == 0 and calls == sorted(calls, reverse=True)


@pytest.mark.parametrize("level", [0, 2])
@pytest.mark.parametrize("robust", ["none", "huber", "tukey"])
def test_photometric_err_H_plain_matches_jax(scene, level, robust):
    """One iteration's measurement at the perturbed prior against the JAX
    package's first iteration of that level (`photometric_update_levels`
    with max_iter=1, which steps from the prior by -K·Hᵀz): the per-point
    and mean errors directly; HᵀH through G = K·HᵀH and Hᵀz through the
    step, with the port's exact f64 gain on the port's HᵀH. The port
    projects with explicit product sums (the kernel's order) where the
    JAX package multiplies matrices: the pixel positions agree to a few
    ulp, which moves a squared patch error by up to ~1e-4 of itself."""
    tj, tt, _, _ = tracked_both(scene)
    jv, tv = scene["jv"], scene["tv"]
    prior = scene["prior"]
    sj, Gj, perr_j, err_j, itj = jvio.photometric_update_levels(
        prior, prior, jv.cam, jnp.asarray(scene["gray"]), tj.pos, tj.patch,
        tj.search_level, tj.valid, jv.Rci, jv.Pci, jv.Jdphi_dR, jv.Jdp_dR,
        img_point_cov=jv._ipc_dev, patch_size=8, levels=(level,), max_iter=1,
        robust=robust)
    assert int(itj) == 1
    pt = tstate(prior)
    err, HTH6, HTz, perr = photometric.photometric_err_H_plain(
        torch.from_numpy(scene["gray"]), tt.pos, tt.patch[:, level], tt.search_level,
        tt.valid, pt.rot, pt.pos, tv.Rci, tv.Pci, tv.Jdphi_dR, tv.Jdp_dR, tv.cam,
        level, 8, robust)
    valid = tt.valid.numpy()
    assert valid.sum() > 10 and float(err) > 0
    np.testing.assert_allclose(perr.numpy(), np.asarray(perr_j), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(float(err), float(err_j), rtol=1e-5)
    P_ = pt.cov / float(tv.cfg.img_point_cov)
    H64 = HTH6.double()
    K = linalg.kalman_gain6_f64(P_, H64)
    np.testing.assert_allclose((K @ H64).numpy(), np.asarray(Gj), atol=1e-4)
    dx = -(K @ HTz.double())  # a step of ~8 mm and ~4 mrad here
    np.testing.assert_allclose((pt.pos + dx[3:6]).numpy(), np.asarray(sj.pos), atol=2e-6)
    rot = pt.rot @ so3.exp(dx[0:3])
    np.testing.assert_allclose(rot.numpy(), np.asarray(sj.rot), atol=1e-6)


def frame_step_both(sc, jmap, tmap, P=None):
    jv, tv = sc["jv"], sc["tv"]
    prior = sc["prior"]
    meta = np.array([sc["n"], jv.fid], np.int32)
    kw = dict(grid_size=jv.grid_size, patch_size=P or jv.patch_size, gw=jv.gw, gh=jv.gh,
              ncc_en=False, max_iter=6, max_pg=jv.max_pg)
    oj = jvio.vio_frame_step(jmap, jv.cam, prior, prior, jnp.asarray(sc["gray"]),
                             jnp.asarray(meta), jnp.asarray(sc["cloud"]), jv.Rci, jv.Pci,
                             jv.Jdphi_dR, jv.Jdp_dR, jv._out_thre_dev, jv._ncc_thre_dev,
                             jv._ipc_dev, **kw)
    pt = tstate(prior)
    ot = tvio.vio_frame_step(tmap, tv.cam, pt, pt, torch.from_numpy(sc["gray"]),
                             torch.from_numpy(meta), torch.from_numpy(sc["cloud"]),
                             tv.Rci, tv.Pci, tv.Jdphi_dR, tv.Jdp_dR, tv._out_thre_dev,
                             tv._ncc_thre_dev, tv._ipc_dev, **kw)
    return oj, ot, pt


def test_vio_frame_step_matches_jax(scene):
    tmap = convert.visual_map_from_arrays(
        {f: np.asarray(v) for f, v in scene["jv"].vmap._asdict().items()}, "cpu")
    oj, ot, _ = frame_step_both(scene, scene["jv"].vmap, tmap)
    assert int(ot[7]) == int(oj[7]) > 10  # n_tracked
    assert int(ot[8]) == int(oj[8])  # n_added
    assert ot[9] == int(oj[9])  # iterations
    sj, stj = oj[0], np.asarray(oj[10])
    np.testing.assert_allclose(ot[0].pos.numpy(), np.asarray(sj.pos), atol=1e-5)
    np.testing.assert_allclose(ot[0].cov.numpy(), np.asarray(sj.cov), rtol=1e-3, atol=1e-10)
    stt = ot[10].numpy()
    assert stt.shape == (29,) and stt.dtype == np.float64
    np.testing.assert_array_equal(stt[[0, 1, 3, 28]], stj[[0, 1, 3, 28]])
    np.testing.assert_allclose(stt[4:16], stj[4:16], atol=1e-5)
    assert int(ot[1].n_pts) == int(oj[1].n_pts)


@pytest.mark.parametrize("P", [10, 16])
def test_vio_frame_step_matches_jax_at_wide_patches(scene, P):
    tmap = convert.visual_map_from_arrays(
        {f: np.asarray(v) for f, v in scene["jv"].vmap._asdict().items()}, "cpu")
    oj, ot, _ = frame_step_both(scene, scene["jv"].vmap, tmap, P)
    assert int(ot[7]) == int(oj[7]) > 10  # n_tracked
    assert int(ot[8]) == int(oj[8])  # n_added
    assert ot[9] == int(oj[9])  # iterations
    sj, stj = oj[0], np.asarray(oj[10])
    np.testing.assert_allclose(ot[0].pos.numpy(), np.asarray(sj.pos), atol=1e-5)
    cj, ct = np.asarray(sj.cov), ot[0].cov.numpy()
    np.testing.assert_allclose(np.diag(ct), np.diag(cj), rtol=1e-3, atol=1e-10)
    scale = np.sqrt(np.outer(np.diag(cj), np.diag(cj)))
    assert (np.abs(ct - cj) <= 1e-10 + 1e-3 * scale).all()
    stt = ot[10].numpy()
    np.testing.assert_array_equal(stt[[0, 1, 3, 28]], stj[[0, 1, 3, 28]])
    np.testing.assert_allclose(stt[4:16], stj[4:16], atol=1e-5)
    assert int(ot[1].n_pts) == int(oj[1].n_pts)


def test_empty_frame_is_an_exact_noop(scene):
    """Zero tracked points: three levels of one iteration each, the state
    and covariance unchanged, in both packages."""
    jv, tv = scene["jv"], scene["tv"]
    jmap = jv._fresh_vmap()
    oj, ot, pt = frame_step_both(scene, jmap, tv._fresh_vmap())
    prior = scene["prior"]
    assert int(oj[7]) == int(ot[7]) == 0
    assert int(oj[9]) == ot[9] == 3
    np.testing.assert_array_equal(np.asarray(oj[0].pos), np.asarray(prior.pos))
    np.testing.assert_array_equal(np.asarray(oj[0].cov), np.asarray(prior.cov))
    for f in ("rot", "pos", "vel", "bg", "ba", "grav", "cov"):
        np.testing.assert_array_equal(getattr(ot[0], f).numpy(), getattr(pt, f).numpy(), f)
    assert int(ot[8]) == int(oj[8]) > 0  # the empty map takes new points


@pytest.mark.parametrize("kind", ["bgr_u8", "mono_u8", "mono_u16", "bgr_f32",
                                  "mono_half", "mono_resize"])
def test_gray_frame_matches_jax(scene, kind):
    """`Vio._gray_device`: integer frames at the camera's size convert on
    the device, others on the host; every form equal to the JAX package's."""
    rng = np.random.default_rng(7)
    shape = {"mono_half": (2 * H, 2 * W), "mono_resize": (H + 40, W - 24)}.get(kind, (H, W))
    if kind.startswith("bgr"):
        shape = shape + (3,)
    hi, dt = {"mono_u16": (4096, np.uint16), "bgr_f32": (255, np.float32)}.get(kind, (256, np.uint8))
    img = rng.integers(0, hi, shape).astype(dt)
    if dt == np.float32:
        img += rng.random(shape, dtype=np.float32)
    got = scene["tv"]._gray_device(img)
    assert got.dtype == torch.float32 and got.shape == (H, W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(scene["jv"]._gray_device(img)))


def test_vio_update_reads_one_stats_row(scene):
    """`Vio.update` on the port: the frame counter, stats and pose."""
    tv = scene["tv"]
    ds = scene["ds"]
    v = tvio.Vio(tv.cfg, device="cpu")
    s = tstate(jstate(ds, 2.0))
    img = ds.render_image(2.0)
    assert v.update(s, s, img) is s and v.fid == 1  # no cloud yet: push only
    assert int(v.vmap.img_fid[0]) == 0
    v.set_last_cloud(cloud(ds, 0))
    out = v.update(s, s, img)
    assert v.fid == 2 and v.last_stats["added"] > 20 and v._n_pts_host > 20
    assert v.last_rcw.shape == (3, 3) and np.isfinite(out.cov.numpy()).all()
    v.reset_map()
    assert int(v.vmap.n_pts) == 0 and v.fid == 2


def fork(v: tvio.Vio) -> tvio.Vio:
    """A second Vio on the same state: the port writes its visual map
    (the image pool included) in place, so a shallow copy would share it."""
    f = copy.copy(v)
    f.vmap = type(v.vmap)(*(t.clone() for t in v.vmap))
    f._pending = []
    return f


def port_vio_like(jv, debug=False):
    """A port Vio holding the JAX Vio's visual map and frame counter."""
    cfg = make_cfg(Config, CameraConfig, CapacityConfig)
    cfg.debug = debug
    tv = tvio.Vio(cfg, device="cpu")
    tv.vmap = convert.visual_map_from_arrays(
        {f: np.asarray(v) for f, v in jv.vmap._asdict().items()}, "cpu")
    tv.fid = jv.fid
    return tv


def test_render_overlay_matches_jax_byte_for_byte():
    rng = np.random.default_rng(3)
    gray = rng.uniform(0, 255, (H, W)).astype(np.float32)
    n = 64
    px = np.stack([rng.uniform(-10, W + 10, n), rng.uniform(-10, H + 10, n)], 1)
    px[:4] = [[0.2, 0.7], [W - 0.5, H - 0.1], [3.0, H - 2.0], [W + 5.9, 10.0]]
    px = px.astype(np.float32)
    err = rng.uniform(0, 16000, n).astype(np.float32)
    valid = rng.random(n) > 0.2
    got = tvio.render_overlay(gray, px, err, valid)
    want = jvio.render_overlay(gray, px, err, valid)
    assert got.dtype == np.uint8 and got.shape == (H, W, 3)
    np.testing.assert_array_equal(got, want)
    assert (got[..., 1] == 255).sum() > 0 and (got[..., 2] == 255).sum() > 0


def test_colorize_matches_jax(scene):
    """The same image, frame pose and points: equal masks and equal
    colours (world2cam in f32, eager on both sides, rounds alike; the
    bilinear sample is the same f64 numpy on the host)."""
    jv = copy.copy(scene["jv"])
    tv = port_vio_like(jv)
    rng = np.random.default_rng(5)
    bgr = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
    jv.last_bgr = jv._resize_color(bgr)
    tv.last_bgr = tv._resize_color(bgr)
    tv.last_rcw, tv.last_pcw = jv.last_rcw, jv.last_pcw
    pts = np.concatenate([cloud(scene["ds"], 11, 20000),
                          rng.uniform(-20, 20, (500, 3))]).astype(np.float32)
    m_t, rgb_t = tv.colorize(pts)
    m_j, rgb_j = jv.colorize(pts)
    np.testing.assert_array_equal(m_t, m_j)
    assert 300 < m_t.sum() < len(pts)
    np.testing.assert_array_equal(rgb_t, rgb_j)
    # before any frame pose: nothing is painted
    m0, rgb0 = tvio.Vio(tv.cfg, device="cpu").colorize(pts)
    assert not m0.any() and rgb0.shape == (len(pts), 3)


@pytest.mark.parametrize("scale", [1, 2])
def test_last_bgr_matches_jax(scene, scale):
    """The frame snapshot and its lazy resize to the camera's size, for a
    colour frame at 1x and 2x the camera's resolution."""
    rng = np.random.default_rng(scale)
    img = rng.integers(0, 256, (scale * H, scale * W, 3)).astype(np.uint8)
    v = tvio.Vio(scene["tv"].cfg, device="cpu")
    s = tstate(jstate(scene["ds"], 2.0))
    v.update(s, s, img)  # no cloud yet: the push only, and the snapshot
    want = scene["jv"]._resize_color(img.copy())
    img[:] = 0  # the caller reuses its buffer
    got = v.last_bgr
    assert got.dtype == np.float32 and got.shape == (H, W, 3)
    np.testing.assert_array_equal(got, want)
    assert v.last_bgr is got  # resized once


def staged_pair(sc, debug):
    """The JAX and port staged paths on the same map, cloud and prior."""
    jv = copy.copy(sc["jv"])
    jv.cfg = copy.copy(jv.cfg)
    jv.cfg.debug = debug
    tv = port_vio_like(jv, debug)
    c = cloud(sc["ds"], 9)
    jv.set_last_cloud(c)
    tv.set_last_cloud(c)
    img = sc["ds"].render_image(2.3)
    out_j = jv.update_staged(sc["prior"], sc["prior"], img)
    pt = tstate(sc["prior"])
    out_t = tv.update_staged(pt, pt, img)
    return jv, tv, out_j, out_t


@pytest.mark.parametrize("debug", [False, True])
def test_update_staged_matches_jax(scene, debug):
    """Port update_staged against JAX update_staged: equal tracked and
    added counts and map size; posterior position within 1e-5, rotation
    within 1e-6, covariance within rtol 1e-3 (the frame step's bounds);
    the frame pose within 1e-5; under debug the overlay within 0.5% of
    its pixels (a tracked point a rounding away from a pixel edge moves
    its disc by one pixel)."""
    jv, tv, sj, st = staged_pair(scene, debug)
    assert tv.last_stats["tracked"] == jv.last_stats["tracked"] > 10
    assert tv.last_stats["added"] == jv.last_stats["added"]
    assert int(tv.vmap.n_pts) == int(jv.vmap.n_pts)
    assert tv.fid == jv.fid
    np.testing.assert_allclose(st.pos.numpy(), np.asarray(sj.pos), atol=1e-5)
    np.testing.assert_allclose(st.rot.numpy(), np.asarray(sj.rot), atol=1e-6)
    np.testing.assert_allclose(st.cov.numpy(), np.asarray(sj.cov), rtol=1e-3, atol=1e-10)
    np.testing.assert_allclose(tv.last_rcw, jv.last_rcw, atol=1e-5)
    np.testing.assert_allclose(tv.last_pcw, jv.last_pcw, atol=1e-5)
    if debug:
        assert tv.last_overlay.shape == jv.last_overlay.shape == (H, W, 3)
        diff = np.any(tv.last_overlay != jv.last_overlay, axis=-1).mean()
        assert diff <= 5e-3, diff
    else:
        assert tv.last_overlay is None and jv.last_overlay is None


def test_update_staged_matches_fused(scene):
    """Port staged against port fused on forked states over three frames,
    at the JAX package's own bounds (tests/test_vio.py): position and
    rotation within 5e-4, covariance within 1e-4, tracked within 2, map
    size within 5%; the debug overlay is drawn on both paths."""
    ds = scene["ds"]
    cfg = make_cfg(Config, CameraConfig, CapacityConfig)
    cfg.debug = True
    v = tvio.Vio(cfg, device="cpu")
    s = tstate(jstate(ds, 2.0))
    v.set_last_cloud(cloud(ds, 0))
    v.update(s, s, ds.render_image(2.0))  # bootstrap
    for k in range(1, 4):
        t = 2.0 + 0.1 * k
        sp = tstate(jstate(ds, t, dpos=(0.01, -0.008, 0.006)))
        v.set_last_cloud(cloud(ds, k))
        img = ds.render_image(t)
        ref = fork(v)
        out_f = v.update(sp, sp, img)
        out_s = ref.update_staged(sp, sp, img)
        np.testing.assert_allclose(out_f.pos.numpy(), out_s.pos.numpy(), atol=5e-4)
        np.testing.assert_allclose(out_f.rot.numpy(), out_s.rot.numpy(), atol=5e-4)
        np.testing.assert_allclose(out_f.cov.numpy(), out_s.cov.numpy(), atol=1e-4)
        assert abs(v.last_stats["tracked"] - ref.last_stats["tracked"]) <= 2
        assert v.last_stats["tracked"] > 10
        nf, ns = int(v.vmap.n_pts), int(ref.vmap.n_pts)
        assert abs(nf - ns) <= max(3, 0.05 * ns), (nf, ns)
        assert v.last_overlay.shape == ref.last_overlay.shape == (H, W, 3)
        assert v.last_overlay is not ref.last_overlay
