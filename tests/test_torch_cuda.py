"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Also: the device voxel filter is deterministic on the card. Contract of
the fused 5-NN + plane-fit kernel against its plain version
(tests/test_torch_knn_plane.py): nd2 at rtol 1e-5; planes at rtol 5e-3 /
atol 5e-4 up to sign where both gates pass; gate mismatches under 1%.
The patch + gradient kernel is bit-exact against its plain version (both
round every product; the kernel is built with -fmad=false), and so is
the fused LIO search against its plain composition
knn5_plane_plain(knn_candidates(...)). The fused photometric measurement
holds HᵀH and Hᵀz each within 1e-4 of its largest entry and err, perr
within rtol 1e-5 of its plain version (its sums over the G·P² rows run in another order);
with nothing to measure err and HT are exactly 0. Its partials (what a
mesh sums: [HT | Σperr | n_meas]) hold the same bounds, Σperr at rtol
1e-5 and n_meas equal, on a full slab and on a slab with no valid cell
(n_meas 1, the rest 0).

Also the slice's paths on the card: block replay within 5 mm of the
per-frame path (the bound of tests/test_replay.py), deferred and
block-packed readback bit-identical to the synchronous path, and a
checkpoint written on the card that loads on the CPU unchanged. The hash
and dense maps: their operations on the card array-identical to the
CPU's, the standalone knn5_plane kernel bit-exact against its plain
version on their candidate blocks, and their pipelines searching through
it (never the tiled kernel).

The camera frame's host-side surfaces on the card: Vio.colorize and
Vio.update_staged against the CPU, and a LIVO run with the debug overlay
and the RGB cloud against the CPU's. Over a mesh: LIO and LIVO worlds of
one on NCCL, bit for bit the single-device path.
"""
import numpy as np
import pytest
import torch

from fastlivo_tpu_torch import camera
from fastlivo_tpu_torch.config import CameraConfig, CapacityConfig, Config
from fastlivo_tpu_torch.io.synthetic import SyntheticDataset
from fastlivo_tpu_torch.ops import image, knn_plane, patches_grads, photometric, so3
from fastlivo_tpu_torch.ops import tiled_map as tm
from fastlivo_tpu_torch.pipeline import Pipeline

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def random_block(n=700, m=27, seed=0, drop=0.3):
    """Candidate blocks around each query, most candidates flattened onto
    a local plane (the shape of tests/test_pallas_lio.py::_random_block),
    with rows that have no neighbour, fewer than five, and distance ties."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    cand = (q[:, None, :] + rng.normal(0, 0.8, (n, m, 3))).astype(np.float32)
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    d = -np.sum(nrm * q, axis=1)
    off = np.sum(cand * nrm[:, None, :], axis=-1) + d[:, None]
    cand -= (off * (rng.random((n, m)) < 0.8))[:, :, None] * nrm[:, None, :]
    found = rng.random((n, m)) > drop
    found[:5] = False  # no neighbour at all
    found[5:10, 3:] = False  # fewer than five
    cand[10:20, 1] = cand[10:20, 0]  # duplicate candidates: distance ties
    return cand, found, q


def assert_contract(pab_a, ok_a, nd2_a, pab_b, ok_b, nd2_b, min_both=200):
    """The kernel contract between two (pabcd, plane_ok, nd2_5) triples."""
    np.testing.assert_allclose(nd2_a, nd2_b, rtol=1e-5, atol=1e-6)
    sel = nd2_b <= 5.0  # the 5th-NN distance gate: the behavioural selector
    flip = np.sign(np.sum(pab_a[:, :3] * pab_b[:, :3], axis=1))[:, None]
    both = sel & ok_a & ok_b
    assert both.sum() > min_both
    np.testing.assert_allclose(pab_a[both], (pab_b * flip)[both], rtol=5e-3, atol=5e-4)
    mism = sel & (ok_a != ok_b)
    assert mism.mean() < 0.01, f"{mism.sum()} gate mismatches"


@pytest.mark.parametrize("m", [27, 125])
def test_knn5_plane_kernel_matches_plain(cuda, m):
    cand, found, q = (torch.from_numpy(a).to(cuda) for a in random_block(5000, m, 4))
    before = knn_plane.knn5_plane.launches
    got = [t.cpu().numpy() for t in knn_plane.knn5_plane(cand, found, q)]
    assert knn_plane.knn5_plane.launches == before + 1
    want = [t.cpu().numpy() for t in knn_plane.knn5_plane_plain(cand, found, q)]
    assert_contract(*got, *want, min_both=1000)


def test_knn5_plane_refuses_bad_inputs(cuda):
    cand, found, q = (torch.from_numpy(a).to(cuda) for a in random_block(64, 27, 1))
    with pytest.raises(TypeError):
        knn_plane.knn5_plane(cand.double(), found, q)
    with pytest.raises(ValueError):
        knn_plane.knn5_plane(cand[:, :20], found[:, :20], q)


def test_pipeline_runs_through_the_kernel(cuda):
    cfg = Config()
    cfg.img_enable = False
    cfg.capacity = CapacityConfig(max_points=4096, max_raw_points=8192,
                                  tiled_dir_dims=(32, 32, 16), tiled_pool=1024)
    ds = SyntheticDataset(duration=3.5, points_per_scan=4096, lidar_noise=0.004, seed=3)
    pipe = Pipeline(cfg)
    for beg, pts, t_rel in ds.lidar_scans_fast():
        pipe.push_lidar(beg, pts, t_rel)
    for t, acc, gyr in ds.imu_stream():
        pipe.push_imu(t, acc, gyr)
    before = knn_plane.knn5_plane_tiled.launches, knn_plane.knn5_plane.launches
    outs = pipe.spin()
    launches = knn_plane.knn5_plane_tiled.launches - before[0]
    steady = [o for o in outs if o.iters > 0]
    assert len(steady) > 5 and launches >= len(steady)
    assert knn_plane.knn5_plane.launches == before[1]  # the search is fused
    base = ds.traj.base_pos
    e = [np.linalg.norm(o.pos - (ds.traj.pose(o.t)[1] - base))
         for o in outs if o.t >= ds.traj.t_static + 0.5]
    assert np.sqrt(np.mean(np.square(e))) < 0.02


def test_voxel_filter_deterministic_and_matches_cpu(cuda):
    from fastlivo_tpu_torch.ops.voxel_filter import voxel_downsample_device

    rng = np.random.default_rng(2)
    p = rng.uniform(-20, 20, (30000, 3)).astype(np.float32)
    p[:10000] = p[10000:20000] + rng.normal(0, 0.05, (10000, 3)).astype(np.float32)
    valid = rng.random(30000) > 0.05
    args = (torch.from_numpy(p), torch.from_numpy(valid), torch.tensor(0.5))
    want = voxel_downsample_device(*args, 16384)
    runs = [voxel_downsample_device(*(a.to(cuda) for a in args), 16384)
            for _ in range(3)]
    for out, mask in runs[1:]:
        assert torch.equal(out, runs[0][0]) and torch.equal(mask, runs[0][1])
    np.testing.assert_array_equal(runs[0][1].cpu().numpy(), want[1].numpy())
    np.testing.assert_allclose(runs[0][0].cpu().numpy(), want[0].numpy(),
                               rtol=1e-6, atol=1e-6)


def patch_inputs(H=512, W=640, K=192, seed=0):
    """A textured image and K centres, a quarter of them within 32 px of a
    border (the tap grids clamp), with scales 1..16."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = (100 + 50 * np.sin(0.21 * xx) * np.cos(0.17 * yy)
           + rng.normal(0, 5, (H, W))).astype(np.float32)
    pc = np.stack([rng.uniform(0, W - 1, K), rng.uniform(0, H - 1, K)], 1)
    q = K // 4
    pc[:q, 0] = rng.uniform(0, 32, q)
    pc[q:2 * q, 1] = rng.uniform(H - 33, H - 1, q)
    scale = rng.choice([1, 2, 4, 8, 16], K)
    return (torch.from_numpy(img), torch.from_numpy(pc.astype(np.float32)),
            torch.from_numpy(scale.astype(np.int32)))


@pytest.mark.parametrize("P", [4, 8])
def test_patches_and_grads_kernel_matches_plain(cuda, P):
    img, pc, scale = (t.to(cuda) for t in patch_inputs(seed=P))
    before = patches_grads.patches_and_grads.launches
    got = patches_grads.patches_and_grads(img, pc, P, scale)
    assert patches_grads.patches_and_grads.launches == before + 1
    want = image.patches_and_grads(img, pc, P, scale)
    for g, w in zip(got, want):
        assert g.shape == (192, P, P)
        assert torch.equal(g, w), (g - w).abs().max()


def test_patches_and_grads_refuses_bad_inputs(cuda):
    img, pc, scale = (t.to(cuda) for t in patch_inputs(K=16))
    with pytest.raises(TypeError):
        patches_grads.patches_and_grads(img.double(), pc, 8, scale)
    with pytest.raises(ValueError):
        patches_grads.patches_and_grads(img, pc[:, :1], 8, scale)
    with pytest.raises(ValueError):
        patches_grads.patches_and_grads(img, pc, 8, scale[:4])
    with pytest.raises(ValueError):
        patches_grads.patches_and_grads(img, pc, 32, scale)
    with pytest.raises(ValueError):
        patches_grads.patches_and_grads(img[:, ::2], pc, 8, scale)
    with pytest.raises(ValueError):
        patches_grads.patches_and_grads(img, pc.cpu(), 8, scale.cpu())


LW, LH, LF = 320, 256, 200.0
RCL = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])


def small_livo_cfg():
    cfg = Config()
    cfg.grid_size = 32
    cfg.outlier_threshold = 300.0
    cfg.img_point_cov = 100.0
    cfg.camera = CameraConfig(width=LW, height=LH, fx=LF, fy=LF, cx=(LW - 1) / 2.0,
                              cy=(LH - 1) / 2.0, d=[0.0, 0.0, 0.0, 0.0])
    cfg.Rcl = RCL.ravel().tolist()
    cfg.capacity = CapacityConfig(max_points=4096, max_raw_points=8192,
                                  tiled_dir_dims=(32, 32, 16), tiled_pool=1024,
                                  vmap_points=8192, vmap_table_size=1 << 15,
                                  frame_ring=16, max_cands=4096)
    return cfg


def small_livo_data(duration=4.0):
    return SyntheticDataset(duration=duration, points_per_scan=4096, lidar_noise=0.004,
                            seed=5, cam_hz=10.0, cam_size=(LW, LH), cam_f=LF, Rcl=RCL)


def test_livo_pipeline_runs_through_the_kernel(cuda):
    cfg = small_livo_cfg()
    ds = small_livo_data()
    pipe = Pipeline(cfg)
    assert pipe.vio.device.type == "cuda"
    for beg, pts, t_rel in ds.lidar_scans_fast():
        pipe.push_lidar(beg, pts, t_rel)
    for t, acc, gyr in ds.imu_stream():
        pipe.push_imu(t, acc, gyr)
    for t, img in ds.images():
        pipe.push_img(t, img)
    before = (photometric.photometric_err_H.launches,
              patches_grads.patches_and_grads.launches)
    outs = pipe.spin()
    launches = photometric.photometric_err_H.launches - before[0]
    assert pipe.vio.steps > 10 and launches >= 3 * pipe.vio.steps
    assert patches_grads.patches_and_grads.launches == before[1]  # fused
    assert int(pipe.vio.vmap.n_pts) > 50 and pipe.vio.last_stats["tracked"] > 5
    base = ds.traj.base_pos
    e = [np.linalg.norm(o.pos - (ds.traj.pose(o.t)[1] - base))
         for o in outs if o.t >= ds.traj.t_static + 0.5]
    assert np.sqrt(np.mean(np.square(e))) < 0.06


def surface(n, seed):
    """Points on a gently curved surface over [-8, 8]^2 at negative
    heights: negative voxel and tile coordinates, every 0.5 m voxel of
    the surface occupied."""
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-8, 8, n), rng.uniform(-8, 8, n)
    z = 0.3 * np.sin(0.5 * x) + 0.2 * np.cos(0.3 * y) - 0.6 + rng.normal(0, 0.01, n)
    return np.stack([x, y, z], 1).astype(np.float32)


def search_queries(n=900, seed=11):
    """Queries near the surface, a third of them on voxel boundaries
    (multiples of the 0.5 m voxel in one to three axes)."""
    q = surface(n, seed)
    rng = np.random.default_rng(seed + 1)
    q += rng.normal(0, 0.05, q.shape).astype(np.float32)
    k = n // 3
    snap = rng.random((k, 3)) < 0.5
    snap[:, 0] = True
    q[:k] = np.where(snap, np.round(q[:k] * 2) / 2, q[:k])
    return q


@pytest.mark.parametrize("radius", [1, 2])  # M = 27, 125
@pytest.mark.parametrize("dims", [(32, 32, 16), (2, 2, 2)])  # (2, 2, 2): aliased tiles
def test_knn5_plane_tiled_matches_plain(cuda, radius, dims):
    m = tm.build_host(surface(40000, 3), dims, 256, 0.5, device=cuda)
    q = torch.from_numpy(search_queries(5000)).to(cuda)
    before = knn_plane.knn5_plane_tiled.launches
    got = knn_plane.knn5_plane_tiled(m, q, radius, 0.1)
    assert knn_plane.knn5_plane_tiled.launches == before + 1
    want = knn_plane.knn5_plane_tiled_plain(m, q, radius, 0.1)
    for g, w in zip(got, want):
        assert torch.equal(g, w), (g.float() - w.float()).abs().max()
    assert int(got[1].sum()) > 500  # planes were fitted


def test_knn5_plane_tiled_refuses_bad_inputs(cuda):
    m = tm.build_host(surface(2000, 3), (32, 32, 16), 64, 0.5, device=cuda)
    q = torch.from_numpy(search_queries(64)).to(cuda)
    with pytest.raises(ValueError):
        knn_plane.knn5_plane_tiled(m, q, 3)
    with pytest.raises(TypeError):
        knn_plane.knn5_plane_tiled(m, q.double(), 1)
    with pytest.raises(ValueError):
        knn_plane.knn5_plane_tiled(m._replace(pts=m.pts.cpu()), q, 1)
    with pytest.raises(ValueError):
        knn_plane.knn5_plane_tiled(m, q.t().contiguous().t(), 1)
    n0 = knn_plane.knn5_plane_tiled(m, q[:0], 1)
    assert all(t.shape[0] == 0 for t in n0)


def photometric_inputs(dev, P=8, G=192, seed=0):
    """One photometric iteration's inputs at the path's shapes: a textured
    640x512 image, a camera with some distortion, G tracked points at
    2-8 m (a few behind the camera, some near the borders), reference
    patches of each level sampled where the points project plus noise of
    0.5-40 grey levels (so the robust weights cover their range), search
    levels 0..2 and 85% valid."""
    img = patch_inputs(seed=seed)[0]
    rng = np.random.default_rng(seed)
    cam = camera.from_config(CameraConfig(width=640, height=512, fx=400.0, fy=400.0,
                                          cx=319.5, cy=255.5,
                                          d=[0.01, -0.005, 0.001, 0.0005]), "cpu")
    Rci = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    Pci = np.array([0.05, -0.02, 0.1])
    Pic = -Rci.T @ Pci
    skew_pic = np.array([[0, -Pic[2], Pic[1]], [Pic[2], 0, -Pic[0]], [-Pic[1], Pic[0], 0]])
    rot = so3.exp(torch.tensor([0.05, -0.1, 0.3], dtype=torch.float64))
    pos = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
    z = rng.uniform(2, 8, G)
    px = np.stack([rng.uniform(0, 639, G), rng.uniform(0, 511, G)], 1)
    px[:G // 8, 0] = rng.uniform(0, 24, G // 8)
    pf = np.stack([(px[:, 0] - 319.5) / 400 * z, (px[:, 1] - 255.5) / 400 * z, z], 1)
    pf[-4:, 2] *= -1  # behind the camera
    rcw = Rci.astype(np.float32) @ rot.numpy().astype(np.float32).T
    pcw = -rcw @ pos.numpy().astype(np.float32) + Pci.astype(np.float32)
    tr_pos = ((pf - pcw) @ rcw).astype(np.float32)  # rcwᵀ (pf - pcw), rcw orthonormal
    slevel = rng.integers(0, 3, G).astype(np.int32)
    pc = camera.world2cam(cam, torch.from_numpy(pf.astype(np.float32)))
    sigma = rng.uniform(0.5, 40, G)[:, None, None]
    patch = np.stack([
        image.patches_and_grads(img, pc, P, torch.from_numpy((1 << lv) << slevel))[0].numpy()
        + rng.normal(0, 1, (G, P, P)) * sigma for lv in range(3)], 1).astype(np.float32)
    f32 = dict(dtype=torch.float32, device=dev)
    cam = camera.from_config(CameraConfig(width=640, height=512, fx=400.0, fy=400.0,
                                          cx=319.5, cy=255.5,
                                          d=[0.01, -0.005, 0.001, 0.0005]), dev)
    t = lambda a, **k: torch.as_tensor(a, **(k or f32))  # noqa: E731
    return dict(img=img.to(dev), tr_pos=t(tr_pos), tr_patch=t(patch),
                tr_slevel=t(slevel, device=dev), tr_valid=t(rng.random(G) < 0.85, device=dev),
                rot=rot.to(dev), pos=pos.to(dev), Rci=t(Rci), Pci=t(Pci), Jdphi_dR=t(Rci),
                Jdp_dR=t(-Rci @ skew_pic), cam=cam)


def photometric_call(fn, x, level, P, robust, **kw):
    return fn(x["img"], x["tr_pos"], x["tr_patch"][:, level], x["tr_slevel"], x["tr_valid"],
              x["rot"], x["pos"], x["Rci"], x["Pci"], x["Jdphi_dR"], x["Jdp_dR"], x["cam"],
              level, P, robust, **kw)


@pytest.mark.parametrize("P", [4, 8])
@pytest.mark.parametrize("robust", ["none", "huber", "tukey"])
def test_photometric_err_H_matches_plain(cuda, P, robust):
    x = photometric_inputs(cuda, P=P, seed=P)
    for level in (2, 0):
        before = photometric.photometric_err_H.launches
        err, HTH6, HTz, perr = photometric_call(photometric.photometric_err_H, x, level, P, robust)
        assert photometric.photometric_err_H.launches == before + 1
        want = photometric_call(photometric.photometric_err_H_plain, x, level, P, robust)
        for g, w in ((HTH6, want[1]), (HTz, want[2])):  # each at 1e-4 of its max
            scale = float(w.abs().max())
            assert scale > 0
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0,
                                       atol=1e-4 * scale)
        np.testing.assert_allclose(float(err), float(want[0]), rtol=1e-5)
        np.testing.assert_allclose(perr.cpu().numpy(), want[3].cpu().numpy(), rtol=1e-5,
                                   atol=1e-30)
        again = photometric_call(photometric.photometric_err_H, x, level, P, robust)
        for a, b in zip(again, (err, HTH6, HTz, perr)):
            assert torch.equal(a, b)  # no float atomics: the same every run


def test_photometric_err_H_with_nothing_to_measure(cuda):
    x = photometric_inputs(cuda)
    x["tr_valid"] = torch.zeros_like(x["tr_valid"])
    before = photometric.photometric_err_H.launches
    err, HTH6, HTz, perr = photometric_call(photometric.photometric_err_H, x, 0, 8, "huber")
    assert photometric.photometric_err_H.launches == before + 1
    assert float(err) == 0.0 and not HTH6.any() and not HTz.any() and not perr.any()
    empty = {k: (v[:0] if k.startswith("tr_") else v) for k, v in x.items()}
    err, HTH6, HTz, perr = photometric_call(photometric.photometric_err_H, empty, 0, 8, "none")
    assert photometric.photometric_err_H.launches == before + 1  # K = 0: no launch
    assert float(err) == 0.0 and not HTH6.any() and not HTz.any() and perr.shape == (0,)


@pytest.mark.parametrize("valid", ["full", "none"])
def test_photometric_err_H_partials_match_plain(cuda, valid):
    """The partials a mesh sums, on one rank's slab of 48 cells."""
    x = photometric_inputs(cuda)
    x = {k: (v[:48].contiguous() if k.startswith("tr_") else v) for k, v in x.items()}
    if valid == "none":
        x["tr_valid"] = torch.zeros_like(x["tr_valid"])
    before = photometric.photometric_err_H.launches
    parts, perr = photometric_call(photometric.photometric_err_H, x, 1, 8, "none",
                                   partials=True)
    assert photometric.photometric_err_H.launches == before + 1
    want, wperr = photometric_call(photometric.photometric_err_H_plain, x, 1, 8, "none",
                                   partials=True)
    parts, want = parts.cpu().numpy(), want.cpu().numpy()
    assert parts.shape == want.shape == (44,)
    assert parts[43] == want[43]  # n_meas, clamped to at least 1
    if valid == "none":
        assert parts[43] == 1.0 and not parts[:43].any() and not perr.any()
        return
    scale = np.abs(want[:42]).max()
    np.testing.assert_allclose(parts[:42], want[:42], rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(parts[42], want[42], rtol=1e-5)
    np.testing.assert_allclose(perr.cpu().numpy(), wperr.cpu().numpy(), rtol=1e-5,
                               atol=1e-30)
    err = photometric_call(photometric.photometric_err_H, x, 1, 8, "none")[0]
    assert float(err) == float(np.float32(parts[42]) / np.float32(parts[43]))


def test_photometric_err_H_refuses_bad_inputs(cuda):
    x = photometric_inputs(cuda, G=16)
    call = lambda **kw: photometric_call(  # noqa: E731
        photometric.photometric_err_H, {**x, **kw}, kw.pop("level", 0), 8, "none")
    with pytest.raises(TypeError):
        call(img=x["img"].double())
    with pytest.raises(TypeError):
        call(rot=x["rot"].float())
    with pytest.raises(TypeError):
        call(tr_slevel=x["tr_slevel"].long())
    with pytest.raises(ValueError):
        call(tr_pos=x["tr_pos"][:8])
    with pytest.raises(ValueError):
        call(tr_pos=x["tr_pos"].cpu())
    with pytest.raises(ValueError):
        call(rot=x["rot"].t())
    with pytest.raises(ValueError):
        photometric_call(photometric.photometric_err_H, x, 0, 8, "cauchy")
    with pytest.raises(ValueError):
        photometric_call(photometric.photometric_err_H, x, 0, 32, "none")


LIO_DS = dict(duration=4.0, points_per_scan=4096, lidar_noise=0.004, seed=3)


def small_lio(device, backend="tiled", **kw):
    cfg = Config()
    cfg.img_enable = False
    cfg.capacity = CapacityConfig(max_points=4096, max_raw_points=8192,
                                  tiled_dir_dims=(32, 32, 16), tiled_pool=1024,
                                  map_backend=backend, map_table_size=1 << 16,
                                  dense_dims=(64, 64, 16))
    ds = SyntheticDataset(**LIO_DS)
    pipe = Pipeline(cfg, device=device, **kw)
    for beg, pts, t_rel in ds.lidar_scans_fast():
        pipe.push_lidar(beg, pts, t_rel)
    for t, acc, gyr in ds.imu_stream():
        pipe.push_imu(t, acc, gyr)
    return pipe


@pytest.mark.parametrize("mode", ["scan", "packed"])
def test_block_replay_on_the_card_matches_per_frame(cuda, mode):
    """BlockReplayer (8) and LivoBlockReplayer (8) on the card against the
    per-frame path on the card: same frames, within 5 mm (the bound of
    tests/test_replay.py), through the fused search kernel."""
    from fastlivo_tpu_torch.replay import BlockReplayer, LivoBlockReplayer

    outs_ref = small_lio(cuda).spin()
    pipe = small_lio(cuda)
    before = knn_plane.knn5_plane_tiled.launches
    rep = BlockReplayer if mode == "scan" else LivoBlockReplayer
    outs = rep(pipe, 8).run()
    assert knn_plane.knn5_plane_tiled.launches - before >= 20
    assert len(outs) == len(outs_ref) >= 25
    for a, b in zip(outs, outs_ref):
        assert a.t == b.t and np.linalg.norm(a.pos - b.pos) < 5e-3


def test_async_and_block_read_on_the_card_are_bit_identical(cuda):
    ref = small_lio(cuda)
    ref.collect_cov = True
    outs_ref = ref.spin()
    for mode in ("async", "block"):
        pipe = small_lio(cuda)
        if mode == "async":
            pipe.collect_cov = True
            pipe.async_read = True
            pipe.async_depth = 2
        else:
            pipe.enable_block_read(4)
        outs = pipe.spin() + pipe.finish()
        assert len(outs) == len(outs_ref) >= 25
        for a, b in zip(outs, outs_ref):
            assert a.t == b.t and a.iters == b.iters and a.n_active == b.n_active
            np.testing.assert_array_equal(a.pos, b.pos)
            np.testing.assert_array_equal(a.quat, b.quat)
        if mode == "async":
            for c_a, c_b in zip(pipe.covs, ref.covs):
                np.testing.assert_array_equal(c_a, c_b)


def test_checkpoint_written_on_the_card_loads_on_the_cpu(cuda, tmp_path):
    from fastlivo_tpu_torch.io import checkpoint as ckpt

    pipe = small_lio(cuda)
    pipe.spin()
    ckpt.save(tmp_path / "ck.npz", pipe.state, pipe.map, None, calib=pipe.calib)
    state, m, vmap, calib = ckpt.load(tmp_path / "ck.npz", device="cpu")
    assert vmap is None and state.pos.device.type == "cpu"
    for got, want in ((state, pipe.state), (m, pipe.map), (calib, pipe.calib)):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a.numpy(), b.cpu().numpy())
    cpu = Pipeline(pipe.cfg, device="cpu").warm_start(state, m, None, calib)
    assert cpu.init_done and cpu.map_built


def hash_and_dense_maps(device, T=1 << 16, dims=(64, 64, 16)):
    """The same seeded surface (negative coordinates, voxel-boundary
    queries) in a hash table of T slots and a dense grid of `dims` cells
    on `device`, through the backends' own inserts in three batches."""
    from fastlivo_tpu_torch.ops import dense_map as dm
    from fastlivo_tpu_torch.ops import voxel_map as vm

    pts = torch.from_numpy(surface(30000, 5)).to(device)
    valid = torch.ones(pts.shape[0], dtype=torch.bool, device=device)
    valid[::13] = False
    maps = [vm.empty_map(T, 0.5, device=device), dm.empty_dense_map(dims, 0.5, device=device)]
    for mod, i in ((vm, 0), (dm, 1)):
        for sl in (slice(0, 10000), slice(10000, 20000), slice(20000, 30000)):
            maps[i] = mod.insert(maps[i], pts[sl], valid[sl])
    return maps


@pytest.mark.parametrize("radius", [1, 2])  # M = 27, 125
def test_knn5_plane_on_hash_and_dense_blocks_bit_exact(cuda, radius):
    from fastlivo_tpu_torch.ops import dense_map as dm
    from fastlivo_tpu_torch.ops import voxel_map as vm

    q = torch.from_numpy(search_queries(5000)).to(cuda)
    for mod, m in zip((vm, dm), hash_and_dense_maps(cuda)):
        cand, found = mod.knn_candidates(m, q, radius, 12)
        before = knn_plane.knn5_plane.launches
        got = knn_plane.knn5_plane(cand, found, q, 0.1)
        assert knn_plane.knn5_plane.launches == before + 1
        want = knn_plane.knn5_plane_plain(cand, found, q, 0.1)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (mod.__name__, (g.float() - w.float()).abs().max())
        assert int(got[1].sum()) > 500  # planes were fitted


def test_map_ops_on_the_card_equal_the_cpu(cuda):
    """insert (with a duplicate claim), knn_candidates, delete_boxes and
    rebuild of the hash map, and the dense grid's insert (with aliased
    cells), knn_candidates and delete_boxes: every array on the card
    equals the CPU's."""
    from fastlivo_tpu_torch.ops import dense_map as dm
    from fastlivo_tpu_torch.ops import voxel_map as vm

    on_card = hash_and_dense_maps(cuda, T=1 << 11, dims=(16, 16, 8))
    on_cpu = hash_and_dense_maps("cpu", T=1 << 11, dims=(16, 16, 8))
    q = torch.from_numpy(search_queries(3000))
    lo = torch.tensor([[-8.0, 0.0, -3.0]])
    hi = torch.tensor([[8.0, 8.0, 3.0]])

    def same(a, b, what):
        for x, y in zip(a, b):
            assert torch.equal(x.cpu(), y), what

    for mod, mc, mh in zip((vm, dm), on_card, on_cpu):
        same(mc, mh, f"{mod.__name__} insert")
        if mod is vm:
            assert int(mc.count) > 0.3 * mc.check.shape[0]  # long probe chains
        same(mod.knn_candidates(mc, q.to(cuda), 1, 12), mod.knn_candidates(mh, q, 1, 12),
             f"{mod.__name__} knn_candidates")
        mc = mod.delete_boxes(mc, lo.to(cuda), hi.to(cuda))
        mh = mod.delete_boxes(mh, lo, hi)
        same(mc, mh, f"{mod.__name__} delete_boxes")
        if mod is vm:
            same(vm.rebuild(mc), vm.rebuild(mh), "rebuild")


@pytest.mark.parametrize("backend", ["hash", "dense"])
def test_other_backends_run_through_the_standalone_kernel(cuda, backend):
    """A hash or dense pipeline searches through knn5_plane, never the
    tiled kernel, and tracks the ground truth (ATE < 2 cm)."""
    pipe = small_lio(cuda, backend)
    before = knn_plane.knn5_plane_tiled.launches, knn_plane.knn5_plane.launches
    outs = pipe.spin()
    assert knn_plane.knn5_plane_tiled.launches == before[0]
    steady = [o for o in outs if o.iters > 0]
    assert len(steady) > 5 and knn_plane.knn5_plane.launches - before[1] >= len(steady)
    ds = SyntheticDataset(**LIO_DS)
    base = ds.traj.base_pos
    e = [np.linalg.norm(o.pos - (ds.traj.pose(o.t)[1] - base))
         for o in outs if o.t >= ds.traj.t_static + 0.5]
    assert np.sqrt(np.mean(np.square(e))) < 0.02


def vio_state(ds, t, dpos=(0.0, 0.0, 0.0), device="cpu"):
    from fastlivo_tpu_torch.state import identity_state

    rot, pos = ds.traj.pose(t)
    s = identity_state(device)
    return s._replace(rot=torch.as_tensor(rot, dtype=torch.float64, device=device),
                      pos=torch.as_tensor(np.asarray(pos) + dpos, dtype=torch.float64,
                                          device=device))


def room_cloud(ds, seed, n=6000):
    return ds.room.sample_surface(n, np.random.default_rng(seed)).astype(np.float32)


def test_colorize_on_the_card_matches_the_cpu(cuda):
    """Vio.colorize with its world2cam on the card: the CPU's masks and
    colours within 1e-2 (of 255) on the same image, pose and points."""
    from fastlivo_tpu_torch.vio import Vio

    ds = small_livo_data()
    rng = np.random.default_rng(5)
    bgr = rng.integers(0, 256, (LH, LW, 3)).astype(np.uint8)
    pts = np.concatenate([room_cloud(ds, 11, 20000), rng.uniform(-20, 20, (500, 3))])
    res = []
    for dev in (cuda, "cpu"):
        v = Vio(small_livo_cfg(), device=dev)
        s = vio_state(ds, 2.0, device=dev)
        v.set_last_cloud(room_cloud(ds, 0))
        v.update(s, s, ds.render_image(2.0))  # sets the frame pose
        v.last_bgr = v._resize_color(bgr)
        res.append(v.colorize(pts.astype(np.float32)))
    (m_c, rgb_c), (m_h, rgb_h) = res
    np.testing.assert_array_equal(m_c, m_h)
    assert m_c.sum() > 300
    np.testing.assert_allclose(rgb_c[m_c], rgb_h[m_h], atol=1e-2)


def test_update_staged_on_the_card_matches_the_cpu(cuda):
    """Vio.update_staged on the card against the CPU over three frames:
    its photometric iterations launch photometric_err_H (at least three
    per frame); tracked within 1, map size within 1%, position and
    rotation within 1e-4."""
    from fastlivo_tpu_torch.vio import Vio

    ds = small_livo_data()
    runs = []
    for dev in (cuda, "cpu"):
        cfg = small_livo_cfg()
        cfg.debug = True
        v = Vio(cfg, device=dev)
        s = vio_state(ds, 2.0, device=dev)
        v.set_last_cloud(room_cloud(ds, 0))
        v.update_staged(s, s, ds.render_image(2.0))  # bootstrap
        outs, launches = [], []
        for k in range(1, 4):
            t = 2.0 + 0.1 * k
            sp = vio_state(ds, t, dpos=(0.01, -0.008, 0.006), device=dev)
            v.set_last_cloud(room_cloud(ds, k))
            before = photometric.photometric_err_H.launches
            outs.append((v.update_staged(sp, sp, ds.render_image(t)), dict(v.last_stats),
                         int(v.vmap.n_pts)))
            launches.append(photometric.photometric_err_H.launches - before)
        runs.append((outs, launches, v))
    (card, l_card, v_card), (cpu, l_cpu, _) = runs
    assert min(l_card) >= 3 and l_cpu == [0, 0, 0]
    for (sa, st_a, n_a), (sb, st_b, n_b) in zip(card, cpu):
        assert st_b["tracked"] > 10 and abs(st_a["tracked"] - st_b["tracked"]) <= 1
        assert abs(n_a - n_b) <= 0.01 * n_b
        np.testing.assert_allclose(sa.pos.cpu().numpy(), sb.pos.numpy(), atol=1e-4)
        np.testing.assert_allclose(sa.rot.cpu().numpy(), sb.rot.numpy(), atol=1e-4)
    assert v_card.last_overlay.shape == (LH, LW, 3)


def test_debug_and_rgb_cloud_on_the_card(cuda):
    """A LIVO run with `debug` and `pcd_save_en` on the card and on the
    CPU: camera reads stay synchronous under `async_read`; the overlays
    differ in at most 2% of their pixels and the RGB clouds have the same
    chunks, row counts within 2%."""
    import contextlib
    import io

    res = []
    for dev in (cuda, "cpu"):
        cfg = small_livo_cfg()
        cfg.debug = cfg.pcd_save_en = True
        pipe = Pipeline(cfg, device=dev)
        pipe.async_read = True
        ds = small_livo_data(3.0)
        for beg, pts, t_rel in ds.lidar_scans_fast():
            pipe.push_lidar(beg, pts, t_rel)
        for t, acc, gyr in ds.imu_stream():
            pipe.push_imu(t, acc, gyr)
        for t, img in ds.images():
            pipe.push_img(t, img)
        with contextlib.redirect_stdout(io.StringIO()):  # debug_show's dump
            pipe.spin()
            assert not pipe.vio._pending
            pipe.finish()
        res.append(pipe)
    card, cpu = res
    ov_c, ov_h = card.vio.last_overlay, cpu.vio.last_overlay
    assert ov_c.shape == ov_h.shape == (LH, LW, 3) and (ov_c[..., 1] == 255).sum() > 100
    assert np.any(ov_c != ov_h, axis=-1).mean() <= 0.02
    assert len(card.rgb_cloud) == len(cpu.rgb_cloud) >= 10
    n_c, n_h = (sum(len(c) for c in p.rgb_cloud) for p in (card, cpu))
    assert abs(n_c - n_h) <= 0.02 * n_h


def mesh_lio_inputs():
    """small_lio's configuration and its stream, drawn once."""
    cfg = Config()
    cfg.img_enable = False
    cfg.capacity = CapacityConfig(max_points=4096, max_raw_points=8192,
                                  tiled_dir_dims=(32, 32, 16), tiled_pool=1024)
    ds = SyntheticDataset(**LIO_DS)
    return cfg, list(ds.lidar_scans_fast()), list(ds.imu_stream())


def single_device(cfg, scans, imu, device):
    pipe = Pipeline(cfg, device=device)
    for beg, pts, t_rel in scans:
        pipe.push_lidar(beg, pts, t_rel)
    for t, acc, gyr in imu:
        pipe.push_imu(t, acc, gyr)
    return pipe.spin() + pipe.finish()


def test_mesh_of_one_on_nccl_is_the_single_device_path(cuda):
    """A world of one on NCCL (its own process) against the single-device
    path on the card: every frame bit for bit, through the fused search."""
    from fastlivo_tpu_torch.parallel.launch import launch, replay_rank

    cfg, scans, imu = mesh_lio_inputs()
    ref = single_device(cfg, scans, imu, cuda)
    (got,) = launch(replay_rank, 1, (cfg, scans, imu, None, False), backend="nccl",
                    timeout=120, deadline=300)
    assert len(got["t"]) == len(ref) >= 25
    np.testing.assert_array_equal(got["t"], [o.t for o in ref])
    np.testing.assert_array_equal(got["pos"], np.array([o.pos for o in ref]))
    np.testing.assert_array_equal(got["quat"], np.array([o.quat for o in ref]))
    np.testing.assert_array_equal(got["iters"], [o.iters for o in ref])
    assert got["knn5_plane_tiled"] >= sum(o.iters > 0 for o in ref) > 20


@pytest.mark.parametrize("sharded", [False, True], ids=["replicated", "sharded_map"])
def test_mesh_of_two_sharing_the_card(cuda, sharded):
    """Two gloo ranks on cuda:0 (NCCL refuses two ranks on one card), the
    collectives staged through the host: within 1 mm of the single-device
    path, the fused search launched in every rank."""
    from fastlivo_tpu_torch.parallel.launch import launch, replay_rank

    cfg, scans, imu = mesh_lio_inputs()
    ref = np.array([o.pos for o in single_device(cfg, scans, imu, cuda)])
    res = launch(replay_rank, 2, (cfg, scans, imu, "cuda:0", sharded), backend="gloo",
                 timeout=120, deadline=300)
    for r in res:
        assert len(r["pos"]) == len(ref) >= 25
        assert np.abs(r["pos"] - ref).max() < 1e-3
        assert r["knn5_plane_tiled"] > 20 and r["n_dropped"] == 0
    np.testing.assert_array_equal(res[0]["pos"], res[1]["pos"])
    assert res[0]["pool_tiles"] == (512 if sharded else 1024)


def test_livo_mesh_of_one_on_nccl_is_the_single_device_path(cuda):
    """A LIVO world of one on NCCL, replicated and with the pool in slabs:
    every frame bit for bit the single-device LIVO path, with as many
    photometric_err_H launches."""
    from fastlivo_tpu_torch.parallel.launch import launch

    from torch_mesh_ranks import livo_mesh_rank

    cfg = small_livo_cfg()
    ds = small_livo_data()
    scans, imu, images = list(ds.lidar_scans_fast()), list(ds.imu_stream()), ds.images()
    pipe = Pipeline(cfg, device=cuda)
    for beg, pts, t_rel in scans:
        pipe.push_lidar(beg, pts, t_rel)
    for t, acc, gyr in imu:
        pipe.push_imu(t, acc, gyr)
    for t, img in images:
        pipe.push_img(t, img)
    before = photometric.photometric_err_H.launches
    ref = pipe.spin() + pipe.finish()
    launches = photometric.photometric_err_H.launches - before
    (got,) = launch(livo_mesh_rank, 1, (cfg, scans, imu, images), backend="nccl",
                    timeout=120, deadline=300)
    for r in got:
        assert len(r["t"]) == len(ref) >= 25
        np.testing.assert_array_equal(r["pos"], np.array([o.pos for o in ref]))
        np.testing.assert_array_equal(r["quat"], np.array([o.quat for o in ref]))
        assert r["photometric_err_H"] == launches >= 3 * pipe.vio.steps > 30
        assert r["vmap_points"] == int(pipe.vio.vmap.n_pts)
