"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Also: the device voxel filter is deterministic on the card. Contract of
the fused 5-NN + plane-fit kernel against its plain version
(tests/test_torch_knn_plane.py): nd2 at rtol 1e-5; planes at rtol 5e-3 /
atol 5e-4 up to sign where both gates pass; gate mismatches under 1%;
the slab-staged kernel is also bit-exact against it. The patch +
gradient kernel is bit-exact against its plain version (both round every
product; the kernel is built with -fmad=false), and so are the fused LIO
searches (tiled; hash and dense) against their plain compositions
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
knn5_plane_hashed (never knn5_plane, the tiled kernel or
knn_candidates); cache_knn through one gather per frame and knn5_plane.

The photometric cascade bit-equal to the host loop vio.photometric_loop
with the step kernel, also at one tracked point, at more points than the
grid's blocks and on a level that ends by a rollback; the step kernel
within 1e-12 of photometric_step_plain, also at the branch edges of Log
and Exp; the measurement kernel's sum of its per-point partials bit for
bit in photometric.partials_sum's order at G = 1, 7, 8, 192 and 193.

IMU propagation: the imu_propagate kernel within 1e-10 of the plain loop
imu.propagate_plain on the card (its 18x18 products through cuBLAS) over
tests/torch_imu_cases.py's groups, bit-equal across launches, one launch
per entry-point call and per propagated group of a LIO and a LIVO run.

The camera frame's host-side surfaces on the card: Vio.colorize and
Vio.update_staged against the CPU, and a LIVO run with the debug overlay
and the RGB cloud against the CPU's. Over a mesh: LIO and LIVO worlds of
one on NCCL, bit for bit the single-device path.

The LIO cascade (ops/lio_cascade.lio_cascade): every output bit-equal to
the host loop lio.lio_loop with the step kernel, on a random map, on a
16384-point frame, with no valid point, at max_iter 1, on a frame
that converges at its first iteration, with more chunks than blocks
and with more than 64² chunks; equal iterations and the pose
within 1e-9 with photometric_step_plain; lio_update on one card one
launch with no host read on the tiled map, the host loop on the others;
bad inputs refused.

The LIO frame's map stages: tiled_delete_boxes bit-equal to
delete_boxes_plain on built and compacted maps (stale slots past n_alloc)
with the tracker's boxes and with 1 to 300 boxes whose faces lie on cell
centres; voxel_centroids bit-equal to voxel_centroids_plain run on the
CPU (a LIO scan, a camera cloud, -0.0, NaN and inf rows, overflow, no
valid row, 600000 rows, one voxel of 5000 rows, a run across every tile
end, N = 1, N = one tile + 1, max_out = 1); both writing only their
outputs, the centroid's scratch left at 0; the whole steady
lidar_frame_step and delete_boxes with device boxes without a
synchronising call.
"""
import contextlib
import itertools

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
    """The slab-staged kernel on random blocks: bit-exact against its plain
    version (so also within the contract), for N a multiple of its slab
    of 32 queries and not (a ragged last slab, whose bytes past its last
    whole 16 are copied by lanes), down to one query."""
    cand, found, q = (torch.from_numpy(a).to(cuda) for a in random_block(5007, m, 4))
    for n in (4992, 5007, 37, 1):
        before = knn_plane.knn5_plane.launches
        got = knn_plane.knn5_plane(cand[:n], found[:n], q[:n])
        assert knn_plane.knn5_plane.launches == before + 1
        want = knn_plane.knn5_plane_plain(cand[:n], found[:n], q[:n])
        for g, w in zip(got, want):
            assert torch.equal(g, w), (n, (g.float() - w.float()).abs().max())
    got = [t.cpu().numpy() for t in knn_plane.knn5_plane(cand, found, q)]
    want = [t.cpu().numpy() for t in knn_plane.knn5_plane_plain(cand, found, q)]
    assert_contract(*got, *want, min_both=1000)


@pytest.mark.parametrize("m", [27, 125])
def test_knn5_plane_kernel_stages_unaligned_inputs(cuda, m):
    """Inputs whose base is not 16-byte aligned (contiguous views one
    element into larger tensors) are read by each thread from device
    memory, not staged: bit-exact too."""
    cand, found, q = (torch.from_numpy(a).to(cuda) for a in random_block(999, m, 6))
    views = []
    for t in (cand, found, q):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        assert v.is_contiguous() and v.data_ptr() % 16
        views.append(v)
    got = knn_plane.knn5_plane(*views)
    want = knn_plane.knn5_plane_plain(cand, found, q)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


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
    from fastlivo_tpu_torch.ops import lio_cascade

    before = (lio_cascade.lio_cascade.launches, knn_plane.knn5_plane_tiled.launches,
              knn_plane.knn5_plane.launches)
    outs = pipe.spin()
    launches = lio_cascade.lio_cascade.launches - before[0]
    steady = [o for o in outs if o.iters > 0]
    # one cascade per EKF, its search inside: no search launch of its own
    assert len(steady) > 5 and launches == len(steady)
    assert (knn_plane.knn5_plane_tiled.launches, knn_plane.knn5_plane.launches) == before[1:]
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
    with pytest.raises(ValueError):  # any P >= 1 is taken
        patches_grads.patches_and_grads(img, pc, 0, scale)
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
    before = (photometric.photometric_cascade.launches, photometric.photometric_err_H.launches,
              photometric.photometric_step.launches, patches_grads.patches_and_grads.launches)
    outs = pipe.spin()
    launches = photometric.photometric_cascade.launches - before[0]
    assert launches == pipe.vio.steps > 10  # the whole cascade: one launch a frame
    assert (photometric.photometric_err_H.launches, photometric.photometric_step.launches,
            patches_grads.patches_and_grads.launches) == before[1:]  # fused
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


@pytest.mark.parametrize("G", [1, 7, 8, 192, 193])
def test_photometric_err_H_sums_partials_in_the_fixed_order(cuda, G):
    """The measurement kernel's last block sums the G per-point partials
    it leaves in its scratch in photometric.partials_sum's order: HT, Σperr
    and n_meas bit for bit at G = 1, 7, 8 (the eight chains), 192 and 193,
    and err their quotient."""
    x = photometric_inputs(cuda, G=G, seed=G)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    partial = torch.empty((G, 44), device=cuda)
    out, perr = torch.empty(45, device=cuda), torch.empty(G, device=cuda)
    cam, tp = x["cam"], x["tr_patch"][:, 0]
    ptrs = [t.data_ptr() for t in (
        x["img"], x["tr_pos"], tp, x["tr_slevel"], x["tr_valid"], x["rot"], x["pos"], x["Rci"],
        x["Pci"], x["Jdphi_dR"], x["Jdp_dR"], cam.fx, cam.fy, cam.cx, cam.cy, cam.d, partial,
        photometric._ticket(cuda, stream), out, perr)]
    assert photometric._launcher()(*ptrs, G, 512, 640, 8, 0, tp.stride(0), 0,
                                   photometric.HUBER_K, photometric._recip32(photometric.TUKEY_B),
                                   photometric._recip32(10.0), stream) == 0
    ps = photometric.partials_sum(partial)
    n_meas = torch.clamp((ps[43] * 8.0) * 8.0, min=1.0)
    assert torch.equal(out[:42], ps[:42]) and torch.equal(out[44], ps[42])
    assert torch.equal(out[43], n_meas) and torch.equal(out[42], ps[42] / n_meas)
    assert torch.equal(perr, partial[:, 42])


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


def cascade_args(x, robust="none", levels=(2, 1, 0), max_iter=10):
    """photometric_cascade's arguments on photometric_inputs' scene, from a
    pose ~2 cm and ~5 mrad off the one the reference patches were sampled
    at, toward a prior at that start pose (as the pipeline calls it), with
    P' = cov / img_point_cov of a filter's covariance."""
    dev = x["img"].device
    f64 = dict(dtype=torch.float64, device=dev)
    rot = x["rot"] @ so3.exp(torch.tensor([0.004, -0.003, 0.002], **f64))
    pos = x["pos"] + torch.tensor([0.02, -0.015, 0.01], **f64)
    xs = torch.cat([pos, torch.tensor([0.3, -0.1, 0.0, 1e-3, -2e-3, 5e-4, 0.01, 0.02, -0.01,
                                       0.0, 0.0, -9.81], **f64)])
    rng = np.random.default_rng(3)
    A = rng.normal(size=(18, 18)) * 0.003
    cov = A @ A.T + np.diag(np.r_[np.full(3, 1e-4), np.full(3, 1e-3), np.full(12, 1e-4)])
    P_ = torch.as_tensor(cov / 100.0, **f64)
    return (x["img"], x["tr_pos"], x["tr_patch"], x["tr_slevel"], x["tr_valid"],
            rot.contiguous(), xs, rot.contiguous(), xs.clone(), P_, x["Rci"], x["Pci"],
            x["Jdphi_dR"], x["Jdp_dR"], x["cam"], levels, x["tr_patch"].shape[-1], max_iter,
            robust, 10.0)


@pytest.mark.parametrize("robust", ["none", "huber", "tukey"])
def test_photometric_cascade_matches_the_host_loop(cuda, robust, monkeypatch):
    """The cascade in one launch against the host loop vio.photometric_loop
    on the same inputs: with the step kernel every output bit-equal (the
    same measurement and step code, the same order); with the plain step
    (photometric_step_plain, an LU solve) the same iterations, rot and
    pos within 1e-9, G within 1e-9 of its largest entry, the errors
    within rtol 1e-5. Two launches are bit-equal."""
    from fastlivo_tpu_torch import vio

    args = cascade_args(photometric_inputs(cuda), robust)
    n = [photometric.photometric_cascade.launches, photometric.photometric_err_H.launches,
         photometric.photometric_step.launches]
    got = photometric.photometric_cascade(*args)
    assert photometric.photometric_cascade.launches == n[0] + 1
    assert 1 <= photometric.photometric_cascade.grid <= 192
    loop = vio.photometric_loop(*args)
    its = int(got[5])
    assert its == loop[5] >= 4 and got[5].dtype == torch.int32
    assert photometric.photometric_err_H.launches - n[1] == its
    assert photometric.photometric_step.launches - n[2] == its
    for g, w, name in zip(got, loop, ("rot", "x", "G", "perr", "err")):
        assert torch.equal(g, w), name
    monkeypatch.setattr(vio, "photometric_step", photometric.photometric_step_plain)
    plain = vio.photometric_loop(*args)
    assert plain[5] == its
    np.testing.assert_allclose(got[0].cpu().numpy(), plain[0].cpu().numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got[1].cpu().numpy(), plain[1].cpu().numpy(), rtol=0, atol=1e-9)
    scale = float(plain[2].abs().max())
    assert scale > 0
    np.testing.assert_allclose(got[2].cpu().numpy(), plain[2].cpu().numpy(), rtol=0,
                               atol=1e-9 * scale)
    np.testing.assert_allclose(got[3].cpu().numpy(), plain[3].cpu().numpy(), rtol=1e-5)
    np.testing.assert_allclose(float(got[4]), float(plain[4]), rtol=1e-5)
    again = photometric.photometric_cascade(*args)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_photometric_cascade_edge_cases(cuda):
    """Nothing valid: one iteration a level (err 0 is never above the
    level's start), G = 0 and the errors 0; nothing tracked (G = 0):
    the same, on one block; one level of max_iter 1: one iteration."""
    x = photometric_inputs(cuda)
    none = {**x, "tr_valid": torch.zeros_like(x["tr_valid"])}
    got = photometric.photometric_cascade(*cascade_args(none))
    assert int(got[5]) == 3 and not got[2].any() and not got[3].any() and float(got[4]) == 0
    empty = {k: (v[:0] if k.startswith("tr_") else v) for k, v in x.items()}
    got = photometric.photometric_cascade(*cascade_args(empty))
    assert photometric.photometric_cascade.grid == 1
    assert int(got[5]) == 3 and not got[2].any() and got[3].shape == (0,)
    got = photometric.photometric_cascade(*cascade_args(x, levels=(1,), max_iter=1))
    assert int(got[5]) == 1


@pytest.mark.parametrize("case", ["one_point", "more_points_than_blocks", "rollback"])
def test_photometric_cascade_at_the_grid_edges(cuda, case, monkeypatch):
    """Every output bit-equal to the host loop with the step kernel, equal
    iterations: one tracked point (a grid of one block); 1000 points, more
    than the grid's blocks (blocks measure several points, the reduction
    its longest chains); and one level of up to 30 iterations that ends by
    a rollback (the last measured error above the one kept)."""
    from fastlivo_tpu_torch import vio

    errs, measure = [], vio.photometric_err_H

    def spy(*a, **kw):
        out = measure(*a, **kw)
        errs.append(float(out[0][42] / torch.clamp(out[0][43], min=1.0)))
        return out

    monkeypatch.setattr(vio, "photometric_err_H", spy)

    def both(args):
        got = photometric.photometric_cascade(*args)
        grid = photometric.photometric_cascade.grid
        errs.clear()
        loop = vio.photometric_loop(*args)
        assert int(got[5]) == loop[5] == len(errs)
        for g, w, name in zip(got, loop, ("rot", "x", "G", "perr", "err")):
            assert torch.equal(g, w), name
        return got, grid

    if case == "one_point":
        x = photometric_inputs(cuda, G=8)
        x = {k: (v[:1] if k.startswith("tr_") else v) for k, v in x.items()}
        x["tr_valid"] = torch.ones_like(x["tr_valid"])
        got, grid = both(cascade_args(x))
        assert grid == 1 and int(got[5]) >= 3
    elif case == "more_points_than_blocks":
        assert both(cascade_args(photometric_inputs(cuda, G=1000, seed=4)))[1] < 1000
    else:  # single levels until one rolls back: its last error above the one kept
        rolled = False
        for seed, level, robust in itertools.product(range(4), (2, 1, 0),
                                                     ("tukey", "huber", "none")):
            got, _ = both(cascade_args(photometric_inputs(cuda, seed=seed), robust, (level,),
                                       max_iter=30))
            if errs[-1] > float(got[4]):
                assert int(got[5]) < 30
                rolled = True
                break
        assert rolled


def step_args(dev, seed):
    """A pose, a prior a few mm and mrad away, P' and [HᵀH₆ | Hᵀz] as the
    measurement gives it (f32), seeded with numpy."""
    rng = np.random.default_rng(seed)
    f64 = dict(dtype=torch.float64, device=dev)
    rot = so3.exp(torch.as_tensor(rng.normal(size=3) * 0.8, **f64))
    prior_rot = rot @ so3.exp(torch.as_tensor(rng.normal(size=3) * 3e-3, **f64))
    x = rng.normal(size=15)
    A = rng.normal(size=(18, 18)) * np.r_[np.full(6, 1e-2), np.full(12, 3e-2)]
    J = rng.normal(size=(200, 6)) * rng.uniform(10.0, 300.0, 6)
    HT = np.concatenate([J.T @ J, (J.T @ rng.normal(size=200) * 20.0)[:, None]], 1)
    return (rot.contiguous(), torch.as_tensor(x, **f64), prior_rot.contiguous(),
            torch.as_tensor(x + rng.normal(size=15) * 5e-3, **f64),
            torch.as_tensor((A @ A.T + np.eye(18) * 1e-4) / 100.0, **f64),
            torch.as_tensor(HT, dtype=torch.float32, device=dev))


@pytest.mark.parametrize("seed", range(4))
def test_photometric_step_matches_plain(cuda, seed):
    """The mesh path's one-warp step against photometric_step_plain: rot,
    x and G within 1e-12, the same convergence flag; repeats bit-equal."""
    args = step_args(cuda, seed)
    n0 = photometric.photometric_step.launches
    got = photometric.photometric_step(*args)
    assert photometric.photometric_step.launches == n0 + 1
    want = photometric.photometric_step_plain(*args)
    for g, w, name in zip(got, want, ("rot", "x", "conv", "G")):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name == "conv":
            assert bool(g) == bool(w)
        else:
            assert float((g - w).abs().max()) <= 1e-12, name
    again = photometric.photometric_step(*args)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    HT0 = args[5].clone()
    HT0[:, 6] = 0.0
    conv = photometric.photometric_step(args[0], args[1], args[0], args[1], args[4], HT0)[2]
    assert bool(conv)  # at the prior with no residual: a zero step


# the rotation angle between the pose and the prior: Log's branches (trace
# above 3 - 1e-6: θ = 0; θ below 1e-3: scale 0.5) and, with no measurement
# and the prior's x (sol = vec), Exp's (|sol[:3]|² below 1e-12)
STEP_EDGES = {"identity": 0.0, "theta_5e-4": 5e-4, "theta_below_1e-3": 0.999e-3,
              "theta_above_1e-3": 1.001e-3, "theta_3e-3": 3e-3, "theta_half": 0.5,
              "theta_near_pi": np.pi - 1e-2, "sol_below_1e-6": 0.999e-6,
              "sol_above_1e-6": 1.001e-6}


@pytest.mark.parametrize("case", list(STEP_EDGES))
def test_photometric_step_at_log_exp_edges(cuda, case):
    """The step kernel against photometric_step_plain at the branch edges
    of Log and Exp (the prior's rotation STEP_EDGES[case] from the pose's;
    the "sol_" cases with [HᵀH₆ | Hᵀz] = 0 and the prior's x): rot, x and G
    within 1e-12, the same convergence flag."""
    rot, x, _, prior_x, P_, HT = step_args(cuda, 5)
    axis = torch.tensor([0.3, -0.5, 0.8], dtype=torch.float64, device=cuda)
    prior_rot = (rot @ so3.exp(axis / torch.linalg.norm(axis) * STEP_EDGES[case])).contiguous()
    if case.startswith("sol_"):
        HT, prior_x = torch.zeros_like(HT), x.clone()
    args = (rot, x, prior_rot, prior_x, P_, HT)
    got = photometric.photometric_step(*args)
    want = photometric.photometric_step_plain(*args)
    assert bool(got[2]) == bool(want[2])
    for g, w, name in zip(got, want, ("rot", "x", "conv", "G")):
        if name != "conv":
            assert float((g - w).abs().max()) <= 1e-12, name
    if case.startswith("sol_"):
        assert bool(got[2])


def test_photometric_update_levels_is_one_launch_with_no_host_read(cuda):
    """On one card photometric_update_levels makes exactly one cascade
    launch and no synchronising call (torch's sync debug mode set to
    raise) between its call and its return; no photometric_err_H or
    photometric_step launch."""
    from fastlivo_tpu_torch import vio
    from fastlivo_tpu_torch.state import identity_state

    x = photometric_inputs(cuda)
    a = cascade_args(x)
    s = identity_state(cuda)
    s = s._replace(rot=a[5], pos=a[6][0:3].clone(), vel=a[6][3:6].clone(),
                   bg=a[6][6:9].clone(), ba=a[6][9:12].clone(), grav=a[6][12:15].clone(),
                   cov=a[9] * 100.0)
    ipc = torch.tensor(100.0, dtype=torch.float64, device=cuda)
    call = lambda: vio.photometric_update_levels(  # noqa: E731
        s, s, x["cam"], x["img"], x["tr_pos"], x["tr_patch"], x["tr_slevel"], x["tr_valid"],
        x["Rci"], x["Pci"], x["Jdphi_dR"], x["Jdp_dR"], ipc, 8)
    want = call()  # built and warm
    torch.cuda.synchronize()
    n = [photometric.photometric_cascade.launches, photometric.photometric_err_H.launches,
         photometric.photometric_step.launches]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert [photometric.photometric_cascade.launches, photometric.photometric_err_H.launches,
            photometric.photometric_step.launches] == [n[0] + 1, n[1], n[2]]
    assert got[4].device.type == "cuda" and isinstance(got[4], torch.Tensor)
    assert torch.equal(got[0].pos, want[0].pos) and torch.equal(got[1], want[1])
    assert int(got[4]) >= 3


def test_photometric_cascade_and_step_refuse_bad_inputs(cuda):
    x = photometric_inputs(cuda, G=16)
    a = list(cascade_args(x))

    def cascade(**kw):
        names = ("img", "tr_pos", "tr_patch", "tr_slevel", "tr_valid", "rot", "x",
                 "prior_rot", "prior_x", "P_", "Rci", "Pci", "Jdphi_dR", "Jdp_dR", "cam",
                 "levels", "P", "max_iter", "robust", "robust_scale")
        b = dict(zip(names, a))
        b.update(kw)
        return photometric.photometric_cascade(*b.values())

    n0 = photometric.photometric_cascade.launches
    with pytest.raises(ValueError, match="CUDA"):
        cascade(img=a[0].cpu())
    with pytest.raises(ValueError):
        cascade(tr_pos=a[1].cpu())
    with pytest.raises(TypeError):
        cascade(rot=a[5].float())
    with pytest.raises(ValueError):
        cascade(x=a[6][:12])
    with pytest.raises(ValueError):
        cascade(P_=a[9].t())  # not contiguous
    with pytest.raises(ValueError):
        cascade(tr_patch=a[2][:, :, ::2, :])
    with pytest.raises(ValueError):
        cascade(levels=(3,))  # no such plane
    with pytest.raises(ValueError):
        cascade(levels=())
    with pytest.raises(ValueError):
        cascade(max_iter=0)
    with pytest.raises(ValueError):
        cascade(robust="cauchy")
    assert photometric.photometric_cascade.launches == n0
    s = list(step_args(cuda, 0))
    n0 = photometric.photometric_step.launches
    for k, bad, err in ((5, s[5].double(), TypeError), (4, s[4][:6, :6], ValueError),
                        (1, s[1].cpu(), ValueError), (0, s[0].t(), ValueError)):
        with pytest.raises(err):
            photometric.photometric_step(*(bad if i == k else t for i, t in enumerate(s)))
    assert photometric.photometric_step.launches == n0


LIO_DS = dict(duration=4.0, points_per_scan=4096, lidar_noise=0.004, seed=3)


def small_lio(device, backend="tiled", cache_knn=False, per_group=None, **kw):
    cfg = Config()
    cfg.img_enable = False
    cfg.capacity = CapacityConfig(max_points=4096, max_raw_points=8192,
                                  tiled_dir_dims=(32, 32, 16), tiled_pool=1024,
                                  map_backend=backend, map_table_size=1 << 16,
                                  dense_dims=(64, 64, 16), cache_knn=cache_knn)
    if per_group is not None:
        cfg.capacity.max_imu_per_group = per_group
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
    tests/test_replay.py), each EKF one LIO cascade launch."""
    from fastlivo_tpu_torch.ops import lio_cascade
    from fastlivo_tpu_torch.replay import BlockReplayer, LivoBlockReplayer

    outs_ref = small_lio(cuda).spin()
    pipe = small_lio(cuda)
    before = lio_cascade.lio_cascade.launches
    rep = BlockReplayer if mode == "scan" else LivoBlockReplayer
    outs = rep(pipe, 8).run()
    assert lio_cascade.lio_cascade.launches - before >= 20
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


def counts():
    return {f.__name__: f.launches for f in (
        knn_plane.knn5_plane_tiled, knn_plane.knn5_plane_hashed, knn_plane.knn5_plane)}


def gathers_spied(monkeypatch, mod, calls: list):
    """Record the calls of mod.knn_candidates (the unfused search's
    gather)."""
    real = mod.knn_candidates

    def spy(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(mod, "knn_candidates", spy)


@pytest.mark.parametrize("backend", ["hash", "dense"])
def test_hash_and_dense_pipelines_run_through_the_fused_search(cuda, backend, monkeypatch):
    """A hash or dense pipeline searches through the fused walk of
    knn5_plane_hashed inside one lio_cascade launch an EKF (counted under
    its map): never a search launch of its own (knn5_plane_hashed, the
    standalone knn5_plane or the tiled kernel), never the backend's
    knn_candidates; it tracks the ground truth (ATE < 2 cm)."""
    from fastlivo_tpu_torch.ops import dense_map as dm
    from fastlivo_tpu_torch.ops import lio_cascade
    from fastlivo_tpu_torch.ops import voxel_map as vm

    pipe = small_lio(cuda, backend)
    calls = []
    gathers_spied(monkeypatch, {"hash": vm, "dense": dm}[backend], calls)
    before = counts()
    c0 = (lio_cascade.lio_cascade.launches, lio_cascade.lio_cascade.by_map[backend])
    outs = pipe.spin()
    launched = {k: v - before[k] for k, v in counts().items()}
    cascades = (lio_cascade.lio_cascade.launches - c0[0],
                lio_cascade.lio_cascade.by_map[backend] - c0[1])
    steady = [o for o in outs if o.iters > 0]
    assert len(steady) > 5 and cascades[0] == cascades[1] >= len(steady)
    assert launched["knn5_plane_hashed"] == 0
    assert launched["knn5_plane"] == launched["knn5_plane_tiled"] == 0 and not calls
    ds = SyntheticDataset(**LIO_DS)
    base = ds.traj.base_pos
    e = [np.linalg.norm(o.pos - (ds.traj.pose(o.t)[1] - base))
         for o in outs if o.t >= ds.traj.t_static + 0.5]
    assert np.sqrt(np.mean(np.square(e))) < 0.02


@pytest.mark.parametrize("backend", ["tiled", "hash"])
def test_cache_knn_runs_through_knn5_plane(cuda, backend, monkeypatch):
    """Under cache_knn the search still gathers once per frame (the
    backend's knn_candidates) and re-ranks that block with knn5_plane at
    every search; neither fused search runs."""
    from fastlivo_tpu_torch.ops import voxel_map as vm

    pipe = small_lio(cuda, backend, cache_knn=True)
    calls = []
    gathers_spied(monkeypatch, {"tiled": tm, "hash": vm}[backend], calls)
    before = counts()
    outs = pipe.spin()
    launched = {k: v - before[k] for k, v in counts().items()}
    steady = [o for o in outs if o.iters > 0]
    assert len(steady) > 5 and len(steady) <= len(calls) <= len(outs)
    assert launched["knn5_plane"] >= len(calls)
    assert launched["knn5_plane_tiled"] == launched["knn5_plane_hashed"] == 0


def colliding_keys(T: int):
    """Two voxel coordinates in [-6, 6)^3 whose first probe slot in a
    table of T slots is the same."""
    from fastlivo_tpu_torch.ops import voxel_map as vm

    k = np.stack(np.meshgrid(*[np.arange(-6, 6)] * 3, indexing="ij"), -1).reshape(-1, 3)
    slot = vm._slot_check(torch.from_numpy(k.astype(np.int32)), T - 1)[0].numpy()
    order = np.argsort(slot, kind="stable")
    i = np.nonzero(slot[order][1:] == slot[order][:-1])[0][0]
    return k[order[[i, i + 1]]]


def search_maps(device, T=1 << 12, dims=(16, 16, 8)):
    """The hash table (T slots) and the dense grid (`dims`) of the fused
    search's tests, from one seeded surface (negative coordinates) through
    the backends' own inserts in three batches: two voxels of one first
    slot inserted in one batch (a duplicate claim), then delete_boxes of
    80 scattered voxels, which leaves holes inside the hash map's probe
    chains; the dense grid spans 8 x 8 x 4 m of the 16 x 16 m surface, so
    its cells alias. (The deleted voxels are single ones, not a box edge:
    five picks along a straight edge are collinear, any normal across the
    line fits them, and two correct fits, the JAX kernel's with its
    polynomial acos and the plain version's, then part ways.) Returns
    ({"hash": map, "dense": map}, the two voxels' centres (2, 3))."""
    from fastlivo_tpu_torch.ops import dense_map as dm
    from fastlivo_tpu_torch.ops import voxel_map as vm

    pair = ((colliding_keys(T) + 0.5) * 0.5).astype(np.float32)
    pts = torch.from_numpy(np.concatenate([pair, surface(20000, 5)])).to(device)
    valid = torch.ones(pts.shape[0], dtype=torch.bool, device=device)
    valid[7::13] = False
    pick = np.random.default_rng(8).choice(np.arange(2, pts.shape[0]), 80, replace=False)
    centre = (torch.floor(pts[pick] / 0.5) + 0.5) * 0.5
    lo, hi = centre - 0.1, centre + 0.1
    maps = {}
    for name, mod, m in (("hash", vm, vm.empty_map(T, 0.5, device=device)),
                         ("dense", dm, dm.empty_dense_map(dims, 0.5, device=device))):
        for sl in (slice(0, 7000), slice(7000, 14000), slice(14000, None)):
            m = mod.insert(m, pts[sl], valid[sl])
        maps[name] = mod.delete_boxes(m, lo, hi)
    return maps, pair


def hashed_queries(pair, n=16384):
    """search_queries(n) with the two colliding voxels' centres first."""
    q = search_queries(n, seed=13)
    q[:2] = pair
    return q


def search_traps(m, q, radius, max_probe=12) -> int:
    """How many candidate rows meet the map's trap: on the hash map a voxel
    found behind an empty slot of its chain, on the dense grid a cell that
    holds another voxel (aliased, so not found)."""
    from fastlivo_tpu_torch.ops import dense_map as dm
    from fastlivo_tpu_torch.ops import voxel_map as vm

    q = q.to(m.check.device)
    cand = vm.voxel_of(q, m.voxel_size)[:, None, :] + vm.neighbor_offsets(radius, q.device)
    if isinstance(m, dm.DenseMap):
        cell, chk = dm._cell_check(m, cand)
        cur = m.check[cell.long()]
        return int(((cur != vm.EMPTY_CHECK) & (cur != chk)).sum())
    mask = m.check.shape[0] - 1
    slot, chk = vm._slot_check(cand, mask)
    slot = slot.long()
    found = torch.zeros_like(slot, dtype=torch.bool)
    hole = torch.zeros_like(found)
    behind = torch.zeros_like(found)
    for _ in range(max_probe):
        cur = m.check[slot]
        hit = (cur == chk) & ~found
        behind |= hit & hole
        found |= hit
        hole |= (cur == vm.EMPTY_CHECK) & ~found
        slot = (slot + 1) & mask
    return int(behind.sum())


@pytest.mark.parametrize("radius", [1, 2])  # M = 27, 125
@pytest.mark.parametrize("backend,probe", [("hash", 12), ("hash", 32), ("dense", 12)])
def test_knn5_plane_hashed_matches_plain(cuda, backend, probe, radius):
    """The fused search on the hash map and the dense grid, bit-exact
    against its plain composition knn5_plane_plain(knn_candidates(...)) on
    every output, at N = 0, 1, 37 and 16384, on maps with holes inside
    probe chains, a duplicate claim, negative coordinates and aliased
    cells."""
    maps, pair = search_maps(cuda)
    m = maps[backend]
    q = torch.from_numpy(hashed_queries(pair)).to(cuda)
    assert search_traps(m, q, radius, probe) > 0
    for n in (0, 1, 37, q.shape[0]):
        before = knn_plane.knn5_plane_hashed.launches
        got = knn_plane.knn5_plane_hashed(m, q[:n], radius, 0.1, probe)
        assert knn_plane.knn5_plane_hashed.launches == before + (n > 0)
        want = knn_plane.knn5_plane_hashed_plain(m, q[:n], radius, 0.1, probe)
        for g, w in zip(got, want):
            assert g.shape[0] == n and torch.equal(g, w), \
                (n, (g.float() - w.float()).abs().max())
    assert int(got[1].sum()) > 2000  # planes were fitted


def test_knn5_plane_hashed_probes_an_unaligned_table(cuda):
    """A hash table whose check words do not start on 16 bytes (a view one
    word into a larger tensor) is probed one word a load: bit-exact
    too."""
    maps, pair = search_maps(cuda)
    m = maps["hash"]
    buf = torch.empty(m.check.shape[0] + 1, dtype=torch.int32, device=cuda)
    check = buf[1:]
    check.copy_(m.check)
    assert check.data_ptr() % 16
    m = m._replace(check=check)
    q = torch.from_numpy(hashed_queries(pair, 5000)).to(cuda)
    for radius in (1, 2):
        got = knn_plane.knn5_plane_hashed(m, q, radius, 0.1, 12)
        want = knn_plane.knn5_plane_hashed_plain(m, q, radius, 0.1, 12)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


def test_knn5_plane_hashed_refuses_bad_inputs(cuda):
    maps, pair = search_maps(cuda)
    q = torch.from_numpy(hashed_queries(pair, 64)).to(cuda)
    h, d = maps["hash"], maps["dense"]
    with pytest.raises(ValueError):
        knn_plane.knn5_plane_hashed(h, q, 3)
    with pytest.raises(TypeError):
        knn_plane.knn5_plane_hashed(h, q.double(), 1)
    with pytest.raises(TypeError):
        knn_plane.knn5_plane_hashed(d._replace(log2_dims=d.log2_dims.long()), q, 1)
    with pytest.raises(ValueError):
        knn_plane.knn5_plane_hashed(h._replace(pts=h.pts.cpu()), q, 1)
    with pytest.raises(ValueError):
        knn_plane.knn5_plane_hashed(h, q.t().contiguous().t(), 1)
    with pytest.raises(TypeError):
        knn_plane.knn5_plane_hashed(tm.build_host(surface(200, 1), (8, 8, 8), 8, 0.5,
                                                  device=cuda), q, 1)
    n0 = knn_plane.knn5_plane_hashed(d, q[:0], 1)
    assert all(t.shape[0] == 0 for t in n0)


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
    its three photometric_update calls a frame (one level each) launch
    photometric_cascade once each; tracked within 1, map size within 1%,
    position and rotation within 1e-4."""
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
            before = photometric.photometric_cascade.launches
            outs.append((v.update_staged(sp, sp, ds.render_image(t)), dict(v.last_stats),
                         int(v.vmap.n_pts)))
            launches.append(photometric.photometric_cascade.launches - before)
        runs.append((outs, launches, v))
    (card, l_card, v_card), (cpu, l_cpu, _) = runs
    assert l_card == [3, 3, 3] and l_cpu == [0, 0, 0]
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


def test_livo_mesh_of_one_on_nccl_is_the_single_device_path(cuda, monkeypatch):
    """A LIVO world of one on NCCL, replicated and with the pool in slabs:
    every frame bit for bit the single-device LIVO path (one cascade
    launch a camera frame), its host loop launching photometric_err_H and
    photometric_step once per iteration of the single device's
    cascades (and the step once per iteration of each lidar frame's LIO
    host loop)."""
    from fastlivo_tpu_torch import vio
    from fastlivo_tpu_torch.parallel.launch import launch

    from torch_mesh_ranks import livo_mesh_rank

    its = []
    real = vio.photometric_cascade

    def record(*a, **kw):
        out = real(*a, **kw)
        its.append(out[5])
        return out

    monkeypatch.setattr(vio, "photometric_cascade", record)

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
    ref = pipe.spin() + pipe.finish()
    assert len(its) == pipe.vio.steps > 10
    iterations = sum(int(k) for k in its)
    (got,) = launch(livo_mesh_rank, 1, (cfg, scans, imu, images), backend="nccl",
                    timeout=120, deadline=300)
    for r in got:
        assert len(r["t"]) == len(ref) >= 25
        np.testing.assert_array_equal(r["pos"], np.array([o.pos for o in ref]))
        np.testing.assert_array_equal(r["quat"], np.array([o.quat for o in ref]))
        assert r["photometric_err_H"] == iterations >= 3 * len(its)
        assert r["photometric_step"] == iterations + int(np.sum(r["iters"]))
        assert r["photometric_cascade"] == 0
        assert r["vmap_points"] == int(pipe.vio.vmap.n_pts)


def imu_inputs(name, device):
    """tests/torch_imu_cases.py's case on `device`: (state, calib, wires,
    acc0, gyr0), acc0 and gyr0 the pipeline's f32 zeros."""
    import torch_imu_cases as cases

    st, cal, wires, a0, g0 = cases.case(name)
    return (cases.torch_state(st, device), cases.torch_calib(cal, device),
            [torch.from_numpy(w).to(device) for w in wires],
            torch.from_numpy(a0).to(device), torch.from_numpy(g0).to(device))


IMU_CASES = ["b8", "b32_padded", "b64", "leading_skipped", "no_valid_pair", "negative_tail",
             "small_angle", "chain_of_three", "b256", "b300", "b512", "b1024"]


@pytest.mark.parametrize("name", IMU_CASES)
def test_imu_propagate_kernel_matches_plain(cuda, name):
    """The kernel against the plain loop on the card (its 18x18 products
    through cuBLAS), group by group of the case with the state and
    acc / gyro carried: every output within 1e-10 absolute."""
    from fastlivo_tpu_torch import imu
    from fastlivo_tpu_torch.ops import imu_scan

    s, calib, wires, a, g = imu_inputs(name, cuda)
    sp, ap, gp = s, a, g
    for w in wires:
        s, pack, a, g = imu_scan.imu_propagate(s, w, a, g, calib)
        torch.cuda.synchronize()
        sp, pack_p, ap, gp = imu.propagate_wire_plain(sp, w, ap, gp, calib)
        for got, want in zip((*s, pack, a, g), (*sp, pack_p, ap, gp)):
            assert got.dtype == want.dtype == torch.float64 and got.shape == want.shape
            assert float((got - want).abs().max()) <= 1e-10


def test_imu_propagate_is_deterministic_and_counted(cuda):
    """Two launches on the same inputs are bit-equal; propagate_wire,
    propagate_packed and propagate each launch the kernel exactly once,
    and propagate's PoseTable holds the pack's rows."""
    import torch_imu_cases as cases

    from fastlivo_tpu_torch import imu
    from fastlivo_tpu_torch.ops import imu_scan

    s, calib, (w,), a, g = imu_inputs("b32_padded", cuda)
    n0 = imu_scan.imu_propagate.launches
    one = imu.propagate_wire(s, w, a, g, calib)
    assert imu_scan.imu_propagate.launches == n0 + 1
    two = imu.propagate_wire(s, w, a, g, calib)
    assert imu_scan.imu_propagate.launches == n0 + 2
    for x, y in zip((*one[0], *one[1:]), (*two[0], *two[1:])):
        assert torch.equal(x, y)
    packed = imu.propagate_packed(s, *cases.wire_arrays(w)[:6], a, g, calib,
                                  row0_off=w[-1, 1])
    assert imu_scan.imu_propagate.launches == n0 + 3 and torch.equal(packed[1], one[1])
    st, pose, a2, g2 = imu.propagate(s, *cases.wire_arrays(w)[:6], a, g, calib,
                                     row0_off=float(cases.ROW0_OFF))
    assert imu_scan.imu_propagate.launches == n0 + 4
    assert torch.equal(pose.offs, one[1][:-1, 0]) and torch.equal(pose.gyr, one[1][:-1, 19:22])
    assert torch.equal(st.cov, one[0].cov) and torch.equal(a2, one[2])


def test_imu_propagate_refuses_bad_inputs(cuda):
    from fastlivo_tpu_torch.ops import imu_scan

    s, calib, (w,), a, g = imu_inputs("b8", cuda)
    with pytest.raises(TypeError):
        imu_scan.imu_propagate(s._replace(cov=s.cov.float()), w, a, g, calib)
    with pytest.raises(TypeError):
        imu_scan.imu_propagate(s, w.double(), a, g, calib)
    with pytest.raises(ValueError):  # no pair: the one wire length refused
        imu_scan.imu_propagate(s, torch.zeros((1, 9), device=cuda), a, g, calib)
    with pytest.raises(ValueError):
        imu_scan.imu_propagate(s._replace(pos=s.pos.cpu()), w, a, g, calib)


@pytest.mark.parametrize("camera", [False, True], ids=["lio", "livo"])
def test_pipeline_propagates_through_the_kernel(cuda, camera, monkeypatch):
    """A short LIO and LIVO run: one imu_propagate launch per propagated
    group (lidar and image groups), the plain loop never runs, and the
    path tracks the ground truth."""
    from fastlivo_tpu_torch import imu
    from fastlivo_tpu_torch.ops import imu_scan

    groups, plain = [], []
    real = imu.propagate_wire

    def wire_spy(*a, **kw):
        groups.append(a[1].shape[0])
        return real(*a, **kw)

    def plain_spy(*a, **kw):
        plain.append(a)
        raise AssertionError("the plain loop ran on the card")

    monkeypatch.setattr(imu, "propagate_wire", wire_spy)
    monkeypatch.setattr(imu, "propagate_plain", plain_spy)
    if camera:
        ds = small_livo_data()
        pipe = Pipeline(small_livo_cfg(), device=cuda)
        for beg, pts, t_rel in ds.lidar_scans_fast():
            pipe.push_lidar(beg, pts, t_rel)
        for t, acc, gyr in ds.imu_stream():
            pipe.push_imu(t, acc, gyr)
        for t, img in ds.images():
            pipe.push_img(t, img)
    else:
        ds, pipe = SyntheticDataset(**LIO_DS), small_lio(cuda)
    n0 = imu_scan.imu_propagate.launches
    outs = pipe.spin()
    launched = imu_scan.imu_propagate.launches - n0
    assert not plain and launched == len(groups) >= len(outs) > 25
    if camera:
        assert launched > len(outs) + 10 and pipe.vio.steps > 10  # image groups too
    base = ds.traj.base_pos
    e = [np.linalg.norm(o.pos - (ds.traj.pose(o.t)[1] - base))
         for o in outs if o.t >= ds.traj.t_static + 0.5]
    assert np.sqrt(np.mean(np.square(e))) < (0.06 if camera else 0.02)


def fast_imu_runs(cuda, per_group, imu_hz=4000.0):
    """A LIO run with a fast IMU at capacity.max_imu_per_group
    `per_group`, on the card and on the CPU: (card outputs, CPU outputs,
    imu_propagate launches of each, IMU buckets, undistort launches of
    each, the card pipeline)."""
    from fastlivo_tpu_torch import imu as imu_mod
    from fastlivo_tpu_torch.ops import imu_scan

    outs, groups, buckets, und, pipes = [], [], [], [], []
    for dev in (cuda, "cpu"):
        cfg = Config()
        cfg.img_enable = False
        cfg.capacity = CapacityConfig(max_points=4096, max_raw_points=8192,
                                      tiled_dir_dims=(32, 32, 16), tiled_pool=1024,
                                      max_imu_per_group=per_group)
        ds = SyntheticDataset(duration=3.0, points_per_scan=4096, lidar_noise=0.004, seed=3,
                              imu_hz=imu_hz)
        pipe = Pipeline(cfg, device=dev)
        for beg, pts, t_rel in ds.lidar_scans_fast():
            pipe.push_lidar(beg, pts, t_rel)
        for t, acc, gyr in ds.imu_stream():
            pipe.push_imu(t, acc, gyr)
        n0, u0 = imu_scan.imu_propagate.launches, imu_mod.undistort.launches
        outs.append(pipe.spin() + pipe.finish())
        groups.append(imu_scan.imu_propagate.launches - n0)
        und.append(imu_mod.undistort.launches - u0)
        buckets.append(pipe._imu_bucket)
        pipes.append(pipe)
    return outs[0], outs[1], groups, buckets, und, pipes[0]


def test_pipeline_at_4khz_imu_with_512_pair_groups(cuda):
    """A LIO run with a 4 kHz IMU and capacity.max_imu_per_group 512
    (~400 pairs a 10 Hz group, the 512 bucket): one imu_propagate launch
    per propagated group, no refusal, positions within 1 mm of the same
    run on the CPU."""
    card, cpu, groups, buckets, _, _ = fast_imu_runs(cuda, 512)
    assert groups[1] == 0 and groups[0] >= len(card) >= 20
    assert buckets == [512, 512]
    np.testing.assert_array_equal([o.t for o in card], [o.t for o in cpu])
    d = np.abs(np.array([o.pos for o in card]) - np.array([o.pos for o in cpu])).max()
    assert d < 1e-3, d


def test_pipeline_at_max_imu_per_group_1024(cuda, monkeypatch):
    """A LIO run at capacity.max_imu_per_group 1024 (an 8 kHz IMU: ~800
    pairs a 10 Hz group): its scan pose table has 8200 rows, past the
    undistortion's shared-memory stage, and every scan is undistorted by
    one undistort launch (the global layout) and none by the plain
    version's code; positions within 1 mm of the same run on the CPU."""
    from fastlivo_tpu_torch import imu as imu_mod

    real, on_card = imu_mod.undistort_plain, []

    def plain(s_end, pose, pts, *a):
        on_card.append(pts.device.type == "cuda")
        return real(s_end, pose, pts, *a)

    monkeypatch.setattr(imu_mod, "undistort_plain", plain)
    card, cpu, groups, buckets, und, pipe = fast_imu_runs(cuda, 1024, imu_hz=8000.0)
    assert pipe.max_scan_poses == 8200 > imu_mod.UNDISTORT_STAGE_M
    assert buckets[0] == buckets[1] and buckets[0] > 512
    assert groups[0] >= len(card) >= 20 and und[0] > len(card) and und[1] == 0
    assert on_card and not any(on_card)  # the CPU run's only
    np.testing.assert_array_equal([o.t for o in card], [o.t for o in cpu])
    d = np.abs(np.array([o.pos for o in card]) - np.array([o.pos for o in cpu])).max()
    assert d < 1e-3, d


def lio_case(device, case):
    """A tiled map and a scan (body frame = IMU frame) for the LIO
    cascade, with a prior off the truth: "random" (random_block's local
    planes, 5000 points, radius 1), "random_r2" (radius 2), "frame" (16384
    points of the curved surface, the path's batch), "no_valid" (nothing
    valid), "max_iter_1", "converged" (noise-free points at the true
    pose: the first step converges), "many_chunks" (40000 points: more
    chunks than the grid's blocks, past one group of 64 chunk sums),
    "past_4096_chunks" (300000 points: a third level of chunk sums).
    Returns (map, body, pmask, rot, x, P', max_iter, radius)."""
    from fastlivo_tpu_torch.ops import so3 as so3_ops

    f64 = dict(dtype=torch.float64, device=device)
    radius, max_iter = (2 if case == "random_r2" else 1), (1 if case == "max_iter_1" else 4)
    if case.startswith("random"):
        cand, found, q = random_block(5000, 27, seed=1)
        m = tm.build_host(cand[found], (128, 128, 64), 2048, 0.5, device=device)
        body = q
    else:
        world = surface(120000, 7)
        rng = np.random.default_rng(8)
        if case == "converged":  # a flat floor, the scan on it exactly
            world[:, 2] = np.float32(-0.6)
        m = tm.build_host(world, (32, 32, 16), 1024, 0.5, device=device)
        n = {"many_chunks": 40000, "past_4096_chunks": 300000}.get(case, 16384)
        body = world[rng.choice(len(world), n, replace=n > len(world))]
        if case != "converged":
            body = body + rng.normal(0, 0.005, body.shape).astype(np.float32)
    body = torch.from_numpy(np.ascontiguousarray(body)).to(device)
    pmask = torch.ones(body.shape[0], dtype=torch.bool, device=device)
    pmask[::17] = False
    if case == "no_valid":
        pmask[:] = False
    if case == "converged":
        rot, x = torch.eye(3, **f64), torch.zeros(15, **f64)
    else:
        rot = so3_ops.exp(torch.tensor([0.004, -0.003, 0.006], **f64))
        x = torch.zeros(15, **f64)
        x[0:3] = torch.tensor([0.03, -0.02, 0.015], **f64)
    P_ = torch.eye(18, **f64) * (0.01 / 0.001)
    return m, body, pmask, rot.contiguous(), x, P_, max_iter, radius


def lio_host_loop(m, body, bns, pmask, rot, x, P_, max_iter, radius, plain_search=False):
    """lio.lio_loop from the pose (rot, x), the prior, its search
    knn5_plane_tiled (knn5_plane_tiled_plain with `plain_search`) and its
    step lio's photometric_step."""
    from fastlivo_tpu_torch import lio

    knn = knn_plane.knn5_plane_tiled_plain if plain_search else knn_plane.knn5_plane_tiled
    return lio.lio_loop(lambda pw: knn(m, pw, radius, lio.PLANE_THRESH), body, bns, pmask, rot,
                        x, rot, x, P_, max_iter)


def lio_cascade_and_loop(m, body, pmask, rot, x, P_, max_iter, radius):
    """The cascade and the host loop (the step kernel) on the same inputs."""
    from fastlivo_tpu_torch import lio
    from fastlivo_tpu_torch.ops import lio_cascade

    bns = torch.sqrt(torch.sqrt(torch.sum(body * body, dim=-1)))
    got = lio_cascade.lio_cascade(m, body, bns, pmask, rot, x, rot, x, P_, max_iter, radius,
                                  lio.PLANE_THRESH, lio.GATES, lio.CONV)
    return got, lio_host_loop(m, body, bns, pmask, rot, x, P_, max_iter, radius), bns


def assert_lio_equal(got, loop, label):
    """The cascade's outputs `got` bit-equal to a host loop's `loop`."""
    assert int(got[6]) == loop[6], (label, int(got[6]), loop[6])
    for g, w, name in zip(got[:6], loop[:6], ("rot", "x", "G", "sel", "pabcd", "plane_ok")):
        assert torch.equal(g, w), (label, name, (g.double() - w.double()).abs().max())


@pytest.mark.parametrize("case", ["random", "random_r2", "frame", "no_valid", "max_iter_1",
                                  "converged", "many_chunks", "past_4096_chunks"])
def test_lio_cascade_matches_the_host_loop(cuda, case, monkeypatch):
    """Every output bit-equal to lio_loop with the step kernel, its search
    knn5_plane_tiled and also knn5_plane_tiled_plain (so the walk the
    cascade shares with knn5_plane_tiled is held against plain torch at
    every iteration's pose); all plain (the plain search and
    photometric_step_plain) the same iterations and the pose within 1e-9."""
    from fastlivo_tpu_torch import lio
    from fastlivo_tpu_torch.ops import lio_cascade

    args = lio_case(cuda, case)
    got, loop, bns = lio_cascade_and_loop(*args)
    its = int(got[6])
    nch = -(-args[1].shape[0] // lio_cascade.CHUNK)
    if case in ("many_chunks", "past_4096_chunks"):  # blocks own several chunks
        assert lio_cascade.lio_cascade.grid < nch and nch > (4096 if case[0] == "p" else 64)
    assert got[6].dtype == torch.int32
    assert_lio_equal(got, loop, (case, "knn5_plane_tiled"))
    m, body, pmask, rot, x, P_, max_iter, radius = args
    plain_search = lio_host_loop(m, body, bns, pmask, rot, x, P_, max_iter, radius, True)
    assert_lio_equal(got, plain_search, (case, "knn5_plane_tiled_plain"))
    monkeypatch.setattr(lio, "photometric_step", photometric.photometric_step_plain)
    plain = lio_host_loop(m, body, bns, pmask, rot, x, P_, max_iter, radius, True)
    assert plain[6] == its
    d = max(float((got[0] - plain[0]).abs().max()), float((got[1] - plain[1]).abs().max()))
    assert d <= 1e-9, d
    if case == "no_valid":
        assert not got[3].any() and its == 2  # nothing measured: converged at once
    elif case == "max_iter_1":  # iterCount -1 and 0, the second a rematch
        assert its == 2
    elif case == "converged":
        assert its == 2 and int(got[3].sum()) > 10000
    else:  # selected rows fed the updates
        assert int(got[3].sum()) > (10000 if case == "frame" else 100)
        assert 2 <= its <= max_iter + 1


@pytest.mark.parametrize("route", ["tiled", "hash", "dense", "cache_knn", "ref"])
def test_lio_update_on_the_card_takes_the_cascade_on_the_tiled_map(cuda, route):
    """lio_update on one card: on the tiled, hash and dense maps with the
    TLS fit one lio_cascade launch (counted by map), no search launch and
    no synchronising call (torch's sync debug mode set to raise), iters a
    device int; with cache_knn and with plane_fit ref the host loop."""
    from fastlivo_tpu_torch import lio
    from fastlivo_tpu_torch.ops import lio_cascade
    from fastlivo_tpu_torch.state import identity_state

    m, body, pmask, rot, x, P_, max_iter, radius = lio_case(cuda, "frame")
    if route in ("hash", "dense"):
        m = hash_and_dense_maps(cuda)[route == "dense"]
    s = identity_state(cuda)
    s = s._replace(rot=rot, pos=x[0:3].clone(), cov=P_ * 0.001)
    eye = torch.eye(3, device=cuda)
    call = lambda: lio.lio_update(  # noqa: E731
        s, m, body, pmask, eye, torch.zeros(3, device=cuda), 0.001, max_iter=max_iter,
        knn_radius=radius, cache_knn=route == "cache_knn",
        plane_fit="ref" if route == "ref" else "tls")
    want = call()  # built and warm
    torch.cuda.synchronize()
    cascade = route in ("tiled", "hash", "dense")
    counts = lambda: (lio_cascade.lio_cascade.launches,  # noqa: E731
                      lio_cascade.lio_cascade.by_map.get(route, 0),
                      knn_plane.knn5_plane_tiled.launches, knn_plane.knn5_plane_hashed.launches)
    n0 = counts()
    if cascade:
        torch.cuda.set_sync_debug_mode("error")
    try:
        got = call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n1 = counts()
    assert torch.equal(got.state.pos, want.state.pos)
    if cascade:
        assert n1 == (n0[0] + 1, n0[1] + 1, n0[2], n0[3])
        assert isinstance(got.iters, torch.Tensor) and got.iters.device.type == "cuda"
    else:
        assert n1[0] == n0[0] and isinstance(got.iters, int)
    assert int(got.n_active) > 1000


def test_lio_cascade_refuses_bad_inputs(cuda):
    from fastlivo_tpu_torch import lio
    from fastlivo_tpu_torch.ops import lio_cascade

    m, body, pmask, rot, x, P_, max_iter, _ = lio_case(cuda, "random")
    bns = torch.ones(body.shape[0], device=cuda)
    good = dict(m=m, p_imu=body, bns=bns, pmask=pmask, rot=rot, x=x, prior_rot=rot,
                prior_x=x, P_=P_, max_iter=max_iter, radius=1, threshold=lio.PLANE_THRESH,
                gates=lio.GATES, conv=lio.CONV)
    n0 = lio_cascade.lio_cascade.launches
    for kw, err in ((dict(p_imu=body.cpu()), ValueError), (dict(radius=3), ValueError),
                    (dict(p_imu=body.double()), TypeError), (dict(bns=bns[:10]), ValueError),
                    (dict(pmask=pmask.to(torch.uint8)), TypeError),
                    (dict(rot=rot.float()), TypeError), (dict(x=x[:12]), ValueError),
                    (dict(P_=P_.t()[:, :17]), ValueError),
                    (dict(m=m._replace(pts=m.pts.cpu())), ValueError)):
        with pytest.raises(err):
            lio_cascade.lio_cascade(**{**good, **kw})
    assert lio_cascade.lio_cascade.launches == n0


def hashed_lio_case(device, backend, radius, probe=12):
    """The "frame" case's scan (16384 points of the curved surface, 0.5 cm
    of noise, every 17th masked) and start pose, on the hash map (T = 2^16
    slots, `probe` slots a voxel; a box deleted from it, so that its
    chains have holes) or the dense grid (64 x 64 x 16 cells of 0.5 m over
    a 16 m surface: aliased cells) of hash_and_dense_maps. Returns (map,
    body, pmask, rot, x, P', max_iter, radius, probe)."""
    from fastlivo_tpu_torch.ops import voxel_map as vm

    _, body, pmask, rot, x, P_, max_iter, _ = lio_case(device, "frame")
    m = hash_and_dense_maps(device)[backend == "dense"]
    if backend == "hash":
        m = vm.delete_boxes(m, torch.tensor([[-3.0, -3.0, -2.0]], device=device),
                            torch.tensor([[-1.0, 2.0, 1.0]], device=device))
    return m, body, pmask, rot, x, P_, max_iter, radius, probe


def hashed_host_loop(m, body, bns, pmask, rot, x, P_, max_iter, radius, probe,
                     plain_search=False):
    """lio.lio_loop with the search knn5_plane_hashed (its plain
    composition with `plain_search`) on the hash or dense map."""
    from fastlivo_tpu_torch import lio

    knn = knn_plane.knn5_plane_hashed_plain if plain_search else knn_plane.knn5_plane_hashed
    return lio.lio_loop(lambda pw: knn(m, pw, radius, lio.PLANE_THRESH, probe), body, bns,
                        pmask, rot, x, rot, x, P_, max_iter)


@pytest.mark.parametrize("radius", [1, 2])  # M = 27, 125
@pytest.mark.parametrize("backend,probe", [("hash", 12), ("hash", 32), ("dense", 12)])
def test_lio_cascade_on_hash_and_dense_matches_the_host_loop(cuda, backend, probe, radius,
                                                            monkeypatch):
    """The cascade on the hash map (holes in its chains) and the dense grid
    (aliased cells): every output bit-equal to lio_loop with the step
    kernel and iters equal, its search knn5_plane_hashed and also its
    plain composition (knn_candidates + knn5_plane_plain, so the walk the
    cascade shares with knn5_plane_hashed is held against torch at every
    iteration's pose); all plain the same iterations and the pose within
    1e-9. One launch, counted under its map; no knn5_plane_hashed
    launch."""
    from fastlivo_tpu_torch import lio
    from fastlivo_tpu_torch.ops import lio_cascade

    m, body, pmask, rot, x, P_, max_iter, radius, probe = hashed_lio_case(
        cuda, backend, radius, probe)
    bns = torch.sqrt(torch.sqrt(torch.sum(body * body, dim=-1)))
    n = (lio_cascade.lio_cascade.launches, lio_cascade.lio_cascade.by_map[backend],
         knn_plane.knn5_plane_hashed.launches)
    got = lio_cascade.lio_cascade(m, body, bns, pmask, rot, x, rot, x, P_, max_iter, radius,
                                  lio.PLANE_THRESH, lio.GATES, lio.CONV, probe)
    assert (lio_cascade.lio_cascade.launches, lio_cascade.lio_cascade.by_map[backend],
            knn_plane.knn5_plane_hashed.launches) == (n[0] + 1, n[1] + 1, n[2])
    its = int(got[6])
    for plain_search in (False, True):
        loop = hashed_host_loop(m, body, bns, pmask, rot, x, P_, max_iter, radius, probe,
                                plain_search)
        assert_lio_equal(got, loop, (backend, probe, radius, plain_search))
    monkeypatch.setattr(lio, "photometric_step", photometric.photometric_step_plain)
    plain = hashed_host_loop(m, body, bns, pmask, rot, x, P_, max_iter, radius, probe, True)
    assert plain[6] == its
    d = max(float((got[0] - plain[0]).abs().max()), float((got[1] - plain[1]).abs().max()))
    assert d <= 1e-9, d
    assert int(got[3].sum()) > 10000 and 2 <= its <= max_iter + 1
    again = lio_cascade.lio_cascade(m, body, bns, pmask, rot, x, rot, x, P_, max_iter, radius,
                                    lio.PLANE_THRESH, lio.GATES, lio.CONV, probe)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


def test_lio_cascade_refuses_bad_hashed_maps(cuda):
    from fastlivo_tpu_torch import lio
    from fastlivo_tpu_torch.ops import lio_cascade

    m, body, pmask, rot, x, P_, max_iter, _, _ = hashed_lio_case(cuda, "hash", 1)
    d = hash_and_dense_maps(cuda)[1]
    bns = torch.ones(body.shape[0], device=cuda)
    good = dict(m=m, p_imu=body, bns=bns, pmask=pmask, rot=rot, x=x, prior_rot=rot,
                prior_x=x, P_=P_, max_iter=max_iter, radius=1, threshold=lio.PLANE_THRESH,
                gates=lio.GATES, conv=lio.CONV)
    n0 = lio_cascade.lio_cascade.launches
    for kw, err in ((dict(m=m._replace(check=m.check[:-1])), ValueError),
                    (dict(m=m._replace(pts=m.pts.double())), TypeError),
                    (dict(m=d._replace(log2_dims=d.log2_dims.long())), TypeError),
                    (dict(m=m, max_probe=-1), ValueError), (dict(m=object()), TypeError)):
        with pytest.raises(err):
            lio_cascade.lio_cascade(**{**good, **kw})
    assert lio_cascade.lio_cascade.launches == n0


def hashed_cascade_write_only(dev, backend):
    """test_kernels_write_only_their_outputs' lio_cascade on the hash map
    and the dense grid, at 16379 rows and M = 27."""
    import ctypes

    from fastlivo_tpu_torch import lio
    from fastlivo_tpu_torch.ops import lio_cascade as lc
    from fastlivo_tpu_torch.ops import voxel_map as vm

    n = 16379
    m, body, pmask, rot, x, P_, max_iter, radius, probe = hashed_lio_case(dev, backend, 1)
    body, pmask = body[:n].contiguous(), pmask[:n].contiguous()
    bns = torch.sqrt(torch.sqrt(torch.sum(body * body, dim=-1)))
    offs = vm.neighbor_offsets(radius, dev)
    l2 = m.log2_dims if backend == "dense" else torch.zeros(3, dtype=torch.int32, device=dev)
    maps = [m.check, m.pts, m.voxel_size, l2, offs]
    f64 = dict(dtype=torch.float64, device=dev)
    part_s, gsum_s, tick_s = lc.scratch_shapes(n)
    outs = [torch.empty(part_s, device=dev), torch.empty(gsum_s, device=dev),
            torch.zeros(tick_s, dtype=torch.int32, device=dev), torch.empty((3, 3), **f64),
            torch.empty(15, **f64), torch.empty((18, 6), **f64),
            torch.empty(n, dtype=torch.bool, device=dev), torch.empty((n, 4), device=dev),
            torch.empty(n, dtype=torch.bool, device=dev),
            torch.empty((), dtype=torch.int32, device=dev)]
    grid = ctypes.c_int(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    got = launch_guarded(lambda *v: lc._hashed_launcher()(
        *[t.data_ptr() for t in v], n, offs.shape[0], m.check.shape[0],
        0 if backend == "hash" else 1, probe, max_iter, lio.PLANE_THRESH, *lio.GATES, *lio.CONV,
        ctypes.byref(grid), stream), maps + [body, bns, pmask, P_, rot, x, rot, x], outs)
    assert not got[2].any()  # the group tickets left at 0
    got = got[3:]
    for plain_search in (False, True):
        loop = hashed_host_loop(m, body, bns, pmask, rot, x, P_, max_iter, radius, probe,
                                plain_search)
        assert_lio_equal(got, loop, (backend, plain_search))


GUARD = 64  # sentinel elements before and after each array (keeps 16-byte alignment)


def guarded(t):
    """t's values inside a buffer whose GUARD elements before and after
    hold a sentinel (NaN for floats, 0xA5 bytes otherwise). Returns
    (buffer, the contiguous view of t's shape)."""
    u8 = t.dtype == torch.bool
    dtype = torch.uint8 if u8 else t.dtype
    fill = float("nan") if dtype.is_floating_point else (
        0xA5 if dtype == torch.uint8 else -0x5A5A5A5)
    buf = torch.full((t.numel() + 2 * GUARD,), fill, dtype=dtype, device=t.device)
    v = buf[GUARD:GUARD + t.numel()]
    v = (v.view(torch.bool) if u8 else v).view(t.shape)
    v.copy_(t)
    return buf, v


def launch_guarded(launch, inputs, outputs):
    """`launch(*input views, *output views)` (a kernel's C entry point on
    the views' pointers) on copies of inputs and outputs inside guarded
    buffers. Asserts it returned 0, wrote no byte of any input and no byte
    of the outputs' guard bands; returns the output views."""
    ins, outs = [guarded(t) for t in inputs], [guarded(t) for t in outputs]
    before = [b.view(torch.uint8).clone() for b, _ in ins + outs]
    assert launch(*[v for _, v in ins + outs]) == 0
    torch.cuda.synchronize()
    for k, ((b, _), b0) in enumerate(zip(ins + outs, before)):
        after, nb = b.view(torch.uint8), GUARD * b.element_size()
        if k < len(ins):
            assert torch.equal(after, b0), f"input {k} written"
        else:
            assert torch.equal(after[:nb], b0[:nb]) and torch.equal(after[-nb:], b0[-nb:]), \
                f"output {k - len(ins)}: a guard band written"
    return [v for _, v in outs]


@pytest.mark.parametrize("kernel", ["knn5_plane_27", "knn5_plane_125", "knn5_plane_tiled",
                                    "lio_cascade", "vio_select", "vio_observations",
                                    "tiled_delete_boxes", "voxel_centroids",
                                    "tiled_insert_keys", "tiled_insert_tiles",
                                    "tiled_insert_cells", "undistort", "vio_select_p16",
                                    "vio_select_pool_12289", "vio_observations_3264",
                                    "undistort_8200", "lio_cascade_hash", "lio_cascade_dense",
                                    "vio_select_p24", "vio_select_p64", "photometric_err_H_p24",
                                    "photometric_err_H_p96", "patches_and_grads_p96"])
def test_kernels_write_only_their_outputs(cuda, kernel):
    """The stand-in for compute-sanitizer's memcheck, which refuses the
    card machine ("Device not supported"): each kernel launched on its
    inputs and outputs inside guard-banded buffers at a ragged size (16379
    rows: the TMA slab path's partial last slab, the cascade's partial
    last chunk) writes no input and nothing outside its outputs, and its
    outputs equal the plain version's bit for bit. The camera-frame
    kernels at the main path's widths: vio_select's scratch and outputs
    are its outputs; vio_observations writes the map in place, so the map
    arrays are its outputs and after the launch every byte of them equals
    the plain version's map (nothing written outside its writes). The
    LIO frame's map stages: tiled_delete_boxes writes the pool's cell
    checks in place (its output, every byte equal to the plain version's
    after the launch); voxel_centroids at 16379 rows into 8191, its
    scratch (ticket, finished blocks, tile status words) back at 0. The
    insert's two launches on a compacted map at 16379 rows, each on the
    plain passes' inputs (the map arrays they write in place are their
    outputs, every byte equal to the plain passes' after the launch):
    tiled_insert_keys; tiled_insert_tiles, which writes the winner flags
    in rows[4] and runs the cells pass too, over 48 blocks, its scratch
    (ticket, marked tiles, ranked tiles, finished blocks, status words)
    back at 0, on the map as built and (tiled_insert_cells) on one whose
    pool overflows; undistort at 16379 points. The layouts past the
    shared-memory stages: vio_select at patch size 16 (the 256-wide tree)
    and on a pool of 12289 slots (the last id read in place),
    vio_observations at 3264 rows (its insert arrays and plans in the
    global scratch, an output here, back at 0 after the launch), undistort
    on an 8200-row table (searched in global memory). The instances past
    those: lio_cascade on the hash map (with holes) and on the dense grid;
    vio_select at patch size 24 (the wide tree, its cells in shared
    memory) and 64 (in the launch's device scratch, an output here);
    photometric_err_H at 24 and at 96 (the taps read in place), and
    patches_and_grads at 96."""
    import ctypes

    from fastlivo_tpu_torch import lio
    from fastlivo_tpu_torch.ops import lio_cascade as lc

    if kernel.startswith("vio_"):
        return vio_write_only(cuda, kernel)
    if kernel.startswith("photometric") or kernel.startswith("patches"):
        return camera_write_only(cuda, kernel)
    if kernel.startswith("lio_cascade_"):
        return hashed_cascade_write_only(cuda, kernel.split("_")[-1])
    if kernel in ("tiled_delete_boxes", "voxel_centroids"):
        return map_stage_write_only(cuda, kernel)
    if kernel.startswith("tiled_insert") or kernel.startswith("undistort"):
        return frame_kernel_write_only(cuda, kernel)

    ptr = lambda *ts: [t.data_ptr() for t in ts]  # noqa: E731
    stream = torch.cuda.current_stream(cuda).cuda_stream
    n = 16379
    out3 = lambda: [torch.empty((n, 4), device=cuda), torch.empty(n, dtype=torch.bool,  # noqa
                                                                  device=cuda),
                    torch.empty(n, device=cuda)]
    if kernel in ("knn5_plane_27", "knn5_plane_125"):
        m = int(kernel.split("_")[-1])
        ins = [torch.from_numpy(a).to(cuda) for a in random_block(n, m, 9)]
        got = launch_guarded(lambda c, f, q, pa, ok, nd: knn_plane._launcher()(
            *ptr(c, f, q, pa, ok, nd), n, m, 0.1, stream), ins, out3())
        want = knn_plane.knn5_plane_plain(*ins)
    else:
        mp, body, pmask, rot, x, P_, max_iter, radius = lio_case(cuda, "frame")
        body, pmask = body[:n].contiguous(), pmask[:n].contiguous()
        offs = tm.neighbor_offsets(radius, cuda)
        maps = [mp.dir_check, mp.dir_slot, mp.cell_check, mp.pts, mp.voxel_size, mp.log2_dims,
                offs]
        T = mp.slot_key.shape[0]
        if kernel == "knn5_plane_tiled":
            got = launch_guarded(lambda q, *r: knn_plane._tiled_launcher()(
                *ptr(q, *r), n, offs.shape[0], T, 0.1, stream), [body] + maps, out3())
            want = knn_plane.knn5_plane_tiled_plain(mp, body, radius, 0.1)
        else:
            bns = torch.sqrt(torch.sqrt(torch.sum(body * body, dim=-1)))
            f64 = dict(dtype=torch.float64, device=cuda)
            part_s, gsum_s, tick_s = lc.scratch_shapes(n)
            outs = [torch.empty(part_s, device=cuda), torch.empty(gsum_s, device=cuda),
                    torch.zeros(tick_s, dtype=torch.int32, device=cuda),
                    torch.empty((3, 3), **f64), torch.empty(15, **f64),
                    torch.empty((18, 6), **f64)] + out3()[1:2] + out3()[0:1] + out3()[1:2] \
                + [torch.empty((), dtype=torch.int32, device=cuda)]
            grid = ctypes.c_int(0)
            got = launch_guarded(lambda *v: lc._launcher()(
                *ptr(*v), n, offs.shape[0], T, max_iter, lio.PLANE_THRESH, *lio.GATES, *lio.CONV,
                ctypes.byref(grid), stream), maps + [body, bns, pmask, P_, rot, x, rot, x], outs)
            assert not got[2].any()  # the group tickets left at 0
            got = got[3:6] + got[6:9] + [got[9]]  # rot, x, G, sel, pabcd, plane_ok, its
            for plain_search in (False, True):
                loop = lio_host_loop(mp, body, bns, pmask, rot, x, P_, max_iter, radius,
                                     plain_search)
                assert_lio_equal(got, loop, plain_search)
            got, want = got[:6], loop[:6]
    for g, w in zip(got, want):
        assert torch.equal(g, w)



# --- the camera frame's selection and map upkeep (vio_select, vio_observations)

FW, FH, FF = 640, 512, 400.0  # the main path's camera: 16 x 12 cells of 40 px


def full_cam(device, W=FW, H=FH):
    """The main path's camera, or one of W x H pixels with its focal
    length (a narrower view)."""
    f = FF
    return camera.from_config(CameraConfig(width=W, height=H, fx=f, fy=f, cx=(W - 1) / 2.0,
                                           cy=(H - 1) / 2.0, d=[0.0, 0.0, 0.0, 0.0]), device)


def clone_map(vm):
    return vm._replace(**{f: getattr(vm, f).clone() for f in vm._fields})


def bit_equal(x, y) -> bool:
    """Equal bits (NaN at the same places counts as equal)."""
    if x.shape != y.shape or x.dtype != y.dtype:
        return False
    if not x.dtype.is_floating_point:
        return torch.equal(x, y)
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
    same = x.view(bits) == y.view(bits)
    return bool((same | (torch.isnan(x) & torch.isnan(y))).all())


def texture(rng, H=FH, W=FW):
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img = 128.0 + 50.0 * np.sin(xx / 7.0 + rng.uniform(0, 6)) * np.cos(yy / 11.0)
    img += 30.0 * np.sin((xx + 2 * yy) / 23.0) + rng.normal(0, 6.0, (H, W))
    return np.clip(img, 0, 255).astype(np.float32)


def small_pose(rng, scale=1.0):
    rot = so3.exp(torch.as_tensor(rng.normal(0, 0.03 * scale, 3), dtype=torch.float64))
    return (rot.numpy().astype(np.float32),
            rng.normal(0, 0.15 * scale, 3).astype(np.float32))


def project(cam, pts, rcw, pcw):
    pc = torch.as_tensor(pts @ rcw.T + pcw, device=cam.fx.device)
    return camera.world2cam(cam, pc).cpu().numpy().astype(np.float32)


def random_vio_frame(dev, u8=True, seed=0, frames=24, ncc=False, P=8, grid=40, W=FW, H=FH,
                     ring=256):
    """A visual map at the shipped capacities (65536 points x 20
    observations, 2^18 slots x 8, a pool of `ring` (256) W x H (640x512)
    images, u8 or f32), grown by the port's own map operations on the
    card: `frames`
    noisy copies of one texture pushed at poses within ~1 mrad and ~5 mm
    of the identity (so that the warped patches match and cells track),
    192 points a frame in front of the camera (some of them with a value
    of 0 or below), the first three frames' points observed again every
    frame (their rings fill) and 150 random others; then a frame of the
    texture at a state and extrinsics whose camera pose is near the
    identity (vio._cam_pose of rot, pos, Rci, Pci), its scan cloud (8192
    rows: noisy copies of map points and free points) and voxels. Returns
    the vio_select arguments as a dict."""
    from fastlivo_tpu_torch import vio
    from fastlivo_tpu_torch import visual_map as tvm

    rng = np.random.default_rng(seed)
    cam = full_cam(dev, W, H)
    vm = tvm.empty_visual_map(n_points=1 << 16, n_obs=20, table_size=1 << 18, voxel_cap=8,
                              ring=ring, height=H, width=W,
                              img_dtype=torch.uint8 if u8 else None, device=dev)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    base = texture(rng, H, W)
    for f in range(frames):
        img = base + rng.normal(0, 2.0, base.shape).astype(np.float32)
        vm = tvm.push_image(vm, t(img), f)
        rcw, pcw = small_pose(rng, 0.03)
        z = rng.uniform(2.0, 8.0, 192)
        pts = np.stack([z * rng.uniform(-0.6, 0.6, 192), z * rng.uniform(-0.45, 0.45, 192),
                        z], -1).astype(np.float32)
        val = rng.uniform(-5.0, 50.0, 192).astype(np.float32)
        vm = tvm.add_points(vm, t(pts), t(project(cam, pts, rcw, pcw)), t(rcw), t(pcw),
                            t(val), f, t(rng.random(192) < 0.9))
        n = int(vm.n_pts)
        if f > 0:
            idx = np.unique(np.concatenate([np.arange(min(n, 576)),
                                            rng.integers(0, n, 150)])).astype(np.int32)
            K = len(idx)
            ppos = vm.pos[t(idx).long()].cpu().numpy()
            vm = tvm.add_observations(
                vm, t(idx), t(project(cam, ppos, rcw, pcw)), t(rcw), t(pcw),
                t(rng.uniform(0, 50, K).astype(np.float32)), f,
                t(rng.integers(0, 3, K).astype(np.int32)), t(rng.random(K) < 0.9))
    gray = t(base)
    f64 = dict(dtype=torch.float64, device=dev)
    srot = so3.exp(torch.as_tensor(rng.normal(0, 0.0009, 3), **f64)).contiguous()
    spos = torch.as_tensor(rng.normal(0, 0.0045, 3), **f64)
    Rci = so3.exp(torch.as_tensor(rng.normal(0, 0.0009, 3), **f64)).float().contiguous()
    Pci = torch.as_tensor(rng.normal(0, 0.003, 3), dtype=torch.float32, device=dev)
    n = int(vm.n_pts)
    M = 8192
    pos = vm.pos[:n].cpu().numpy()
    pg = np.zeros((M, 3), np.float32)
    k = min(n, 3000)
    pg[:k] = pos[rng.permutation(n)[:k]] + rng.normal(0, 0.05, (k, 3))
    z = rng.uniform(1.0, 10.0, 2000)
    pg[k:k + 2000] = np.stack([z * rng.uniform(-0.9, 0.9, 2000),
                               z * rng.uniform(-0.7, 0.7, 2000), z], -1)
    pg_mask = np.arange(M) < k + 2000
    pg_mask[rng.integers(0, k + 2000, 300)] = False
    pg, pg_mask = t(pg.astype(np.float32)), t(pg_mask)
    vox, vox_mask = vio._dedup_voxels(pg, pg_mask, M // 2)
    f32 = dict(dtype=torch.float32, device=dev)
    return dict(vm=vm, cam=cam, rot=srot, pos=spos, Rci=Rci, Pci=Pci, img=gray, pg=pg,
                pg_mask=pg_mask,
                vox=vox, vox_mask=vox_mask, outlier_threshold=torch.tensor(300.0, **f32),
                ncc_thre=torch.tensor(0.5, **f32), grid_size=grid, patch_size=P,
                gw=W // grid, gh=H // grid, ncc_en=ncc)


def obs_args(a, sel, seed=1):
    """vio_observations' arguments after vio_select's outputs `sel` on the
    frame `a`: a posterior state 0.6 m from the prior (so that the tracked
    rows pass the Δp gate and write their rings), the prior camera pose
    from `sel`, the pool's last frame id."""
    tracked, (npos, npx, nscore, nadd), (rcw, pcw) = sel
    rng = np.random.default_rng(seed)
    dev = a["img"].device
    f64 = dict(dtype=torch.float64, device=dev)
    drot = so3.exp(torch.as_tensor(rng.normal(0, 0.003, 3), **f64))
    dpos = rng.normal(0, 0.015, 3) + np.array([0.6, 0.0, 0.0])
    rot2 = (drot @ a["rot"]).contiguous()
    pos2 = a["pos"] + torch.as_tensor(dpos, **f64)
    fid = (a["vm"].img_fid.max()).to(torch.int32)
    return (a["cam"], a["img"], rot2, pos2, a["Rci"], a["Pci"], tracked.idx, tracked.valid,
            tracked.search_level, rcw, pcw, npos, npx, nscore, nadd, fid)


def assert_select_equal(got, want):
    from fastlivo_tpu_torch.vio import TrackedSet

    for f in TrackedSet._fields:
        assert bit_equal(getattr(got[0], f), getattr(want[0], f)), f
    for name, x, y in zip(("pos", "px", "score", "add", "rcw", "pcw"), [*got[1], *got[2]],
                          [*want[1], *want[2]]):
        assert bit_equal(x, y), name


def assert_obs_equal(got, want):
    from fastlivo_tpu_torch.visual_map import VisualMap

    for f in VisualMap._fields:
        assert bit_equal(getattr(got[0], f), getattr(want[0], f)), f
    assert bit_equal(got[1], want[1]) and bit_equal(got[2], want[2])
    assert bit_equal(got[3][0], want[3][0]) and bit_equal(got[3][1], want[3][1])


def select_both(a):
    from fastlivo_tpu_torch.ops import vio_select as vs

    kw = {k: v for k, v in a.items() if k != "vm"}
    got = vs.vio_select(a["vm"], **kw)
    want = vs.vio_select_plain(a["vm"], **kw)
    return got, want


def obs_both(vm, args):
    from fastlivo_tpu_torch.ops import vio_observations as vo

    got = vo.vio_observations(clone_map(vm), *args)
    want = vo.vio_observations_plain(clone_map(vm), *args)
    return got, want


@pytest.mark.parametrize("u8", [True, False], ids=["u8", "f32"])
@pytest.mark.parametrize("ncc", [False, True], ids=["ncc_off", "ncc_on"])
def test_vio_select_and_observations_match_plain_on_a_random_map(cuda, u8, ncc):
    """At the main path's widths on a random visual map: vio_select
    bit-equal to select_tracked + select_new_points, and vio_observations
    (from a copy of the map) bit-equal to prep_observations +
    add_observations + add_points in every map field, the pixels and the
    scores; cells tracked, points added, full rings evicted."""
    from fastlivo_tpu_torch.ops import vio_select as vs

    a = random_vio_frame(cuda, u8=u8, seed=3 + u8, ncc=ncc)
    n0 = vs.vio_select.launches
    got, want = select_both(a)
    assert vs.vio_select.launches == n0 + 1
    assert_select_equal(got, want)
    tracked, new, _ = got
    assert int(tracked.valid.sum()) > 20 and int(new[3].sum()) > 5
    full = a["vm"].n_obs[tracked.idx.long()] >= a["vm"].obs_fid.shape[1]
    assert int((full & tracked.valid).sum()) > 0  # some writes evict
    g2, w2 = obs_both(a["vm"], obs_args(a, got))
    assert_obs_equal(g2, w2)
    assert int(g2[0].n_pts) > int(a["vm"].n_pts)


def select_refused():
    """The plain selection's code (vio_select_plain and what it calls)."""
    from fastlivo_tpu_torch import vio
    from fastlivo_tpu_torch.ops import vio_select as vs

    return plain_refused((vs, "vio_select_plain"), (vio, "select_tracked"),
                         (vio, "select_new_points"), (vio, "_cam_pose"))


def observations_refused():
    """The plain upkeep's code (vio_observations_plain and what it calls)."""
    from fastlivo_tpu_torch import vio
    from fastlivo_tpu_torch import visual_map as tvm
    from fastlivo_tpu_torch.ops import vio_observations as vo

    return plain_refused((vo, "vio_observations_plain"), (vio, "prep_observations"),
                         (tvm, "add_observations"), (tvm, "add_points"), (vio, "_cam_pose"))


@pytest.mark.parametrize("u8", [True, False], ids=["u8", "f32"])
@pytest.mark.parametrize("ncc", [False, True], ids=["ncc_off", "ncc_on"])
def test_vio_select_takes_patch_sizes_2_to_16(cuda, u8, ncc):
    """Every patch size from 2 to 16 on one random map (the tree widths
    64, 128 and 256 of vio._patch_sum): vio_select one launch, the plain
    version's code not reached, every output bit-equal to the plain
    version's (each TrackedSet field, the new points, the pose); cells
    tracked at every width."""
    from fastlivo_tpu_torch.ops import vio_select as vs

    a = random_vio_frame(cuda, u8=u8, seed=41 + u8, ncc=ncc)
    tracked = {}
    for P in range(2, 17):
        a["patch_size"] = P
        kw = {k: v for k, v in a.items() if k != "vm"}
        n0 = vs.vio_select.launches
        with select_refused():
            got = vs.vio_select(a["vm"], **kw)
        assert vs.vio_select.launches == n0 + 1
        want = vs.vio_select_plain(a["vm"], **kw)
        assert got[0].patch.shape == (192, 3, P, P)
        try:
            assert_select_equal(got, want)
        except AssertionError as e:
            raise AssertionError(f"patch_size {P}: {e}") from e
        tracked[P] = int(got[0].valid.sum())
    for widths in (range(2, 9), range(9, 12), range(12, 17)):
        assert sum(tracked[P] for P in widths) > 0, tracked


def pool_past_stage(a, R):
    """The frame `a`'s map with its pool of `ring` slots moved to the last
    `ring` slots of a pool of R (the rest empty: fid -1, zero images) and
    every observation's slot moved with it."""
    vm = a["vm"]
    r0, H, W = vm.imgs.shape
    off = R - r0
    imgs = torch.zeros((R, H, W), dtype=vm.imgs.dtype, device=vm.imgs.device)
    imgs[off:] = vm.imgs
    fid = torch.full((R,), -1, dtype=torch.int32, device=vm.imgs.device)
    fid[off:] = vm.img_fid
    return dict(a, vm=vm._replace(imgs=imgs, img_fid=fid, obs_slot=vm.obs_slot + off))


@pytest.mark.parametrize("R", [12288, 12289, 12312])
def test_vio_select_takes_pools_past_12288_slots(cuda, R):
    """A pool of R 128x128 u8 images (~200 MB at 12289), the map's 24
    frames in its last slots: 12288 (every id staged in shared memory),
    12289 (the last one read from global memory), 12312 (all 24): one
    vio_select launch, the plain code not reached, bit-equal to the plain
    version; the same frame with its 24-slot pool gives the same outputs
    (the slots' move changes nothing)."""
    from fastlivo_tpu_torch.ops import vio_select as vs

    a = random_vio_frame(cuda, seed=19, W=128, H=128, grid=16, ring=24, frames=24)
    b = pool_past_stage(a, R)
    kw = {k: v for k, v in b.items() if k != "vm"}
    n0 = vs.vio_select.launches
    with select_refused():
        got = vs.vio_select(b["vm"], **kw)
    assert vs.vio_select.launches == n0 + 1
    assert_select_equal(got, vs.vio_select_plain(b["vm"], **kw))
    assert_select_equal(got, vs.vio_select(a["vm"], **kw))
    assert int(got[0].valid.sum()) > 0


def obs_rows_args(cuda, B, seed=17):
    """vio_observations' arguments for B rows (cells) on a random map:
    tracked rows of distinct points, the invalid rows' indices anywhere
    in the pool (some of them the rows the new points take), new points
    sharing voxels. Returns (the map, the arguments, the index, valid)."""
    a = random_vio_frame(cuda, seed=seed, frames=8)
    vm = a["vm"]
    rng = np.random.default_rng(seed + 6)
    NP, n = vm.pos.shape[0], int(vm.n_pts)
    t = lambda x, **kw: torch.as_tensor(x, device=cuda, **kw)  # noqa: E731
    idx = rng.integers(0, NP, B).astype(np.int32)
    idx[rng.integers(0, B, 64)] = rng.integers(n, n + 300, 64)  # aliasing new rows
    k = min(n, 1200)
    rows = rng.permutation(B)[:k]
    idx[rows] = rng.permutation(n)[:k]
    valid = np.zeros(B, bool)
    valid[rows] = rng.random(k) < 0.8
    z = rng.uniform(2.0, 8.0, B)
    npos = np.stack([z * rng.uniform(-0.6, 0.6, B), z * rng.uniform(-0.45, 0.45, B), z], -1)
    npos[1::3] = npos[0::3][:len(npos[1::3])]  # shared voxels
    f64 = dict(dtype=torch.float64)
    rot2 = (so3.exp(t(rng.normal(0, 0.003, 3), **f64)) @ a["rot"]).contiguous()
    pos2 = a["pos"] + t(rng.normal(0, 0.015, 3) + [0.6, 0.0, 0.0], **f64)
    args = (a["cam"], a["img"], rot2, pos2, a["Rci"], a["Pci"], t(idx), t(valid),
            t(rng.integers(0, 3, B).astype(np.int32)), a["Rci"].clone(), a["Pci"].clone(),
            t(npos.astype(np.float32)), t(rng.uniform(0, 600, (B, 2)).astype(np.float32)),
            t(rng.uniform(0, 50, B).astype(np.float32)), t(rng.random(B) < 0.5),
            (vm.img_fid.max()).to(torch.int32))
    return vm, args, idx, valid


def scratch_is_zero(dev) -> bool:
    """The stream's scratch (photometric._ticket), which every launch
    leaves at 0."""
    t = photometric._tickets.get((dev, torch.cuda.current_stream(dev).cuda_stream))
    return t is None or not bool(t.any())


@pytest.mark.parametrize("B", [2049, 3264])
def test_vio_observations_past_2048_rows(cuda, B):
    """Past the insert block's shared memory (2048 rows): 2049, and 3264
    (a 640x512 camera at grid 10, 64 x 51 cells), one vio_observations
    launch each, the plain code not reached, every map field bit-equal to
    the plain version's, also with the point pool full but for 100 rows
    and with n_pts 50 below the map's last point; the global scratch
    left at 0."""
    from fastlivo_tpu_torch.ops import vio_observations as vo

    vm, args, idx, valid = obs_rows_args(cuda, B)
    NP, n = vm.pos.shape[0], int(vm.n_pts)
    shrunk = vm._replace(n_pts=torch.tensor(n - 50, dtype=torch.int32, device=cuda))
    full = vm._replace(n_pts=torch.tensor(NP - 100, dtype=torch.int32, device=cuda))
    for m in (vm, full, shrunk):
        n0 = vo.vio_observations.launches
        with observations_refused():
            got = vo.vio_observations(clone_map(m), *args)
        assert vo.vio_observations.launches == n0 + 1
        torch.cuda.synchronize()
        assert scratch_is_zero(cuda)
        assert_obs_equal(got, vo.vio_observations_plain(clone_map(m), *args))
        if m is vm:
            assert int(got[0].n_pts) > n + 500 and vo.vio_observations.grid >= 2
        if m is full:
            assert int(got[0].n_pts) == NP


def test_vio_kernels_at_patch_4_and_320_cells(cuda):
    """4x4 patches (a YAML config's default) and 32-pixel cells (20 x 16 =
    320 cells, more rows than the upkeep block's 256 threads): both
    kernels bit-equal to their plain versions."""
    a = random_vio_frame(cuda, seed=8, P=4, grid=32, ncc=True)
    got, want = select_both(a)
    assert_select_equal(got, want)
    assert got[0].patch.shape == (320, 3, 4, 4) and int(got[0].valid.sum()) > 20
    g2, w2 = obs_both(a["vm"], obs_args(a, got))
    assert_obs_equal(g2, w2)
    assert int(g2[0].n_pts) > int(a["vm"].n_pts)


def test_vio_kernels_with_nothing_tracked_or_added(cuda):
    """No candidate voxel and no scan row: nothing tracked, nothing
    added, every cell value 0, the map unchanged; both bit-equal to the
    plain versions. And a full point pool: the new points dropped."""
    a = random_vio_frame(cuda, seed=5, frames=4)
    a["vox_mask"] = torch.zeros_like(a["vox_mask"])
    a["pg_mask"] = torch.zeros_like(a["pg_mask"])
    got, want = select_both(a)
    assert_select_equal(got, want)
    assert not bool(got[0].valid.any()) and not bool(got[1][3].any())
    assert not bool(got[0].cell_value.any())
    before = clone_map(a["vm"])
    g2, w2 = obs_both(a["vm"], obs_args(a, got))
    assert_obs_equal(g2, w2)
    assert all(bit_equal(getattr(g2[0], f), getattr(before, f)) for f in before._fields)
    # the pool of points full but for 3 rows: 3 of the new points kept
    b = random_vio_frame(cuda, seed=6, frames=4)
    got = select_both(b)[0]
    assert int(got[1][3].sum()) > 3
    vm = b["vm"]._replace(n_pts=torch.tensor(b["vm"].pos.shape[0] - 3, dtype=torch.int32,
                                             device=cuda))
    g3, w3 = obs_both(vm, obs_args(b, got))
    assert_obs_equal(g3, w3)
    assert int(g3[0].n_pts) == vm.pos.shape[0]


def claim_case(dev, case, rng):
    """vio_observations' map and arguments on a random frame with new
    points placed for the voxel-claim cases: `one_voxel`, six new points
    in one new voxel (a leader and its followers); `shared_slot`, two new
    voxels whose probe chains start at one free slot (a contested claim,
    the later voxel in key order keeps it, the other probes on); `rounds`,
    three new voxels whose first three probed slots hold other checks
    (claimed in the fourth round, with followers) beside new voxels that
    settle in the first round and points of voxels already in the map."""
    from fastlivo_tpu_torch import visual_map as tvm
    from fastlivo_tpu_torch.ops import vio_select as vs
    from fastlivo_tpu_torch.ops.voxel_map import _slot_check

    a = random_vio_frame(dev, seed=13, frames=6)
    kw = {k: v for k, v in a.items() if k != "vm"}
    args = list(obs_args(a, vs.vio_select(a["vm"], **kw)))
    vm = clone_map(a["vm"])
    T = vm.vox_keys.shape[0]
    keys = vm.vox_keys.cpu().numpy()
    B = args[6].shape[0]
    npos = np.zeros((B, 3), np.float32)
    nadd = np.zeros(B, bool)
    # candidate voxels 2-8 m ahead, none of them in the map yet
    grid = np.stack(np.meshgrid(np.arange(-6, 6), np.arange(-4, 4), np.arange(4, 16),
                                indexing="ij"), -1).reshape(-1, 3).astype(np.int32)
    slot, check = (x.cpu().numpy() for x in _slot_check(torch.from_numpy(grid), T - 1))
    new = ~np.isin(check, keys)
    free = (keys == tvm.EMPTY) & (np.roll(keys, -1) == tvm.EMPTY)

    def put(rows, vox):  # new points at random places inside voxel `vox`
        npos[rows] = (vox + rng.uniform(0.05, 0.95, (len(rows), 3))) * 0.5
        nadd[rows] = True

    if case == "one_voxel":
        v = grid[np.flatnonzero(new)[0]]
        put(np.arange(10, 16), v)
        want = {"voxels": 1}
    elif case == "shared_slot":
        first = {}
        for i in np.flatnonzero(new & free[slot]):
            j = first.setdefault(slot[i], i)
            if j != i and check[i] != check[j]:
                break
        else:
            raise AssertionError("no two new voxels share a free first slot")
        put(np.array([3, 4]), grid[j])
        put(np.array([40, 41, 42]), grid[i])
        want = {"voxels": 2, "slots": (slot[i], (slot[i] + 1) % T)}
    else:
        idx = np.flatnonzero(new)
        busy = idx[:3]
        keys = keys.copy()
        for k, i in enumerate(busy):  # three other checks ahead of each
            for r in range(3):
                keys[(slot[i] + r) % T] = 1000 + 10 * k + r
        for k, i in enumerate(busy):
            put(np.arange(20 + 4 * k, 23 + 4 * k), grid[i])
        for k, i in enumerate(idx[3:9]):  # the first round
            put(np.array([60 + k]), grid[i])
        vm = vm._replace(vox_keys=torch.as_tensor(keys, device=dev))
        want = {"voxels": 9, "busy": [slot[i] for i in busy]}
    # and points of voxels the map already holds
    old = vm.pos[:int(vm.n_pts)][:4].cpu().numpy()
    npos[100:104] = old
    nadd[100:104] = True
    args[11] = torch.as_tensor(npos, device=dev)
    args[14] = torch.as_tensor(nadd, device=dev)
    return vm, tuple(args), want


@pytest.mark.parametrize("case", ["one_voxel", "shared_slot", "rounds"])
def test_vio_observations_voxel_claims(cuda, case):
    """The voxel hash's claim rounds in the kernel (claim_case): bit-equal
    to the plain version in every map field; every new voxel holds its
    points in row order, the contested slot went to one voxel and the
    other took the next, the busy chains were claimed past the other
    checks."""
    from fastlivo_tpu_torch.ops.voxel_map import _slot_check

    rng = np.random.default_rng(21)
    vm, args, want = claim_case(cuda, case, rng)
    got, ref = obs_both(vm, args)
    assert_obs_equal(got, ref)
    m = got[0]
    n0, n1 = int(vm.n_pts), int(m.n_pts)
    nadd = args[14].cpu().numpy()
    assert n1 == n0 + int(nadd.sum())
    keys = torch.floor(args[11][args[14]] / 0.5).to(torch.int32)
    T = m.vox_keys.shape[0]
    slot, check = _slot_check(keys, T - 1)
    added = (m.vox_keys != vm.vox_keys).sum().item()
    assert added == want["voxels"]
    VC = m.vox_idx.shape[1]
    for k in range(keys.shape[0]):  # each new point's row in its voxel
        s = [(int(slot[k]) + r) % T for r in range(12)]
        hit = [x for x in s if int(m.vox_keys[x]) == int(check[k])]
        assert hit
        cnt = int(m.vox_count[hit[0]])
        if cnt <= VC:
            assert n0 + k in m.vox_idx[hit[0]][:cnt].tolist()
    if case == "shared_slot":
        a, b = want["slots"]
        assert int(m.vox_keys[a]) != int(vm.vox_keys[a]) != int(m.vox_keys[b])
    if case == "rounds":
        for s0 in want["busy"]:
            assert int(m.vox_keys[(s0 + 3) % T]) != int(vm.vox_keys[(s0 + 3) % T])


def test_vio_observations_at_2048_rows(cuda):
    """B = 2048 rows (the shared-memory layout's last size): tracked rows
    of distinct points, the invalid rows' indices anywhere in the pool
    (some of them the rows the new points take), new points sharing
    voxels; bit-equal to the plain version, also with the point pool full
    but for 100 rows, and with n_pts 50 below the map's last point
    (tracked rows that the new points then take again, their rings partly
    filled). One row more (2049, the global layout) is one launch too,
    the plain code not reached, bit-equal."""
    from fastlivo_tpu_torch.ops import vio_observations as vo

    B = 2048
    vm, args, idx, valid = obs_rows_args(cuda, B)
    NP, n = vm.pos.shape[0], int(vm.n_pts)
    got, want = obs_both(vm, args)
    assert_obs_equal(got, want)
    assert int(got[0].n_pts) > n + 500
    assert vo.vio_observations.grid >= 2
    full = vm._replace(n_pts=torch.tensor(NP - 100, dtype=torch.int32, device=cuda))
    got, want = obs_both(full, args)
    assert_obs_equal(got, want)
    assert int(got[0].n_pts) == NP
    shrunk = vm._replace(n_pts=torch.tensor(n - 50, dtype=torch.int32, device=cuda))
    retaken = valid & (idx >= n - 50) & (idx < n)
    assert retaken.sum() > 10 and (vm.n_obs[n - 50:n] > 1).any()
    got, want = obs_both(shrunk, args)
    assert_obs_equal(got, want)
    more = (*args[:6], *(torch.cat([x, x[:1]]) for x in args[6:9]), *args[9:11],
            *(torch.cat([x, x[:1]]) for x in args[11:15]), args[15])
    n0 = vo.vio_observations.launches
    with observations_refused():
        got = vo.vio_observations(clone_map(vm), *more)
    assert vo.vio_observations.launches == n0 + 1
    assert_obs_equal(got, vo.vio_observations_plain(clone_map(vm), *more))
    assert scratch_is_zero(cuda)


def livo_calls(dev, monkeypatch, u8=True, frames=6):
    """Vio.update at the main path's widths over `frames` camera frames of
    the synthetic room; every vio_select call recorded with a copy of the
    map (which vio_observations writes in place later) and the next
    vio_observations call's arguments."""
    from fastlivo_tpu_torch import vio
    from fastlivo_tpu_torch.io.synthetic import SyntheticDataset

    cfg = Config()
    cfg.img_enable = True
    cfg.outlier_threshold = 300.0
    cfg.img_point_cov = 100.0
    cfg.camera = CameraConfig(width=FW, height=FH, fx=FF, fy=FF, cx=(FW - 1) / 2.0,
                              cy=(FH - 1) / 2.0, d=[0.0, 0.0, 0.0, 0.0])
    cfg.Rcl = RCL.ravel().tolist()
    cfg.capacity.frame_ring_u8 = u8
    ds = SyntheticDataset(duration=4.0, cam_size=(FW, FH), cam_f=FF, cam_hz=10.0, Rcl=RCL)
    calls = []
    real_sel, real_obs = vio.vio_select, vio.vio_observations

    def sel(vm, *a, **kw):
        snap = clone_map(vm)
        out = real_sel(vm, *a, **kw)
        calls.append({"select": (snap, a, kw, out)})
        return out

    def obs(vm, *a):
        calls[-1]["obs"] = a
        return real_obs(vm, *a)

    monkeypatch.setattr(vio, "vio_select", sel)
    monkeypatch.setattr(vio, "vio_observations", obs)
    v = vio.Vio(cfg, device=dev)
    for k in range(frames):
        t = 2.0 + 0.1 * k
        s = vio_state(ds, t, dpos=(0.004 * (k > 0), -0.003 * (k > 0), 0.0), device=dev)
        v.set_last_cloud(room_cloud(ds, k, n=24000))
        v.update(s, s, ds.render_image(t))
    return calls, v, ds


@pytest.mark.parametrize("u8", [True, False], ids=["u8", "f32"])
def test_vio_kernels_match_plain_on_a_map_grown_by_livo(cuda, monkeypatch, u8):
    """Every camera frame of a LIVO run (Vio.update, 640x512, shipped
    capacities): the recorded vio_select call bit-equal to the plain
    version on its copy of the map, and vio_observations on two copies of
    that map (the kernel's, the plain version's) bit-equal in every field;
    the run's own outputs equal the replayed kernel's."""
    from fastlivo_tpu_torch.ops import vio_select as vs

    calls, v, _ = livo_calls(cuda, monkeypatch, u8)
    assert len(calls) == v.steps >= 5 and v.last_stats["tracked"] > 10
    for rec in calls:
        snap, a, kw, out = rec["select"]
        assert_select_equal(out, vs.vio_select_plain(clone_map(snap), *a, **kw))
        g2, w2 = obs_both(snap, rec["obs"])
        assert_obs_equal(g2, w2)


def test_camera_frame_is_one_select_and_one_observations_launch(cuda, monkeypatch):
    """On one card vio_frame_step launches vio_select, photometric_cascade
    and vio_observations once each, and makes no synchronising call
    (torch's sync debug mode set to raise) between its call and its
    return; its n_tracked, n_added and iterations equal the plain
    route's (vio.frame_kernels_apply patched to False) on a copy of the
    map."""
    from fastlivo_tpu_torch import vio
    from fastlivo_tpu_torch.ops import vio_observations as vo
    from fastlivo_tpu_torch.ops import vio_select as vs

    calls, v, ds = livo_calls(cuda, monkeypatch, frames=4)
    snap, a, kw, _ = calls[-1]["select"]
    cam, gray = a[0], a[5]
    monkeypatch.setattr(vio, "vio_select", vs.vio_select)
    monkeypatch.setattr(vio, "vio_observations", vo.vio_observations)
    ds_state = vio_state(ds, 2.3, dpos=(0.004, -0.003, 0.0), device=cuda)
    n = min(len(v.last_cloud), v.cloud_cap)
    cloud = np.zeros((v.cloud_cap, 3), np.float32)
    cloud[:n] = v.last_cloud[:n, :3]
    cloud = torch.as_tensor(cloud, device=cuda)
    meta = torch.tensor([n, v.fid], dtype=torch.int32, device=cuda)

    def step(vm):
        return vio.vio_frame_step(
            vm, cam, ds_state, ds_state, gray, meta, cloud, v.Rci, v.Pci, v.Jdphi_dR,
            v.Jdp_dR, v._out_thre_dev, v._ncc_thre_dev, v._ipc_dev, grid_size=v.grid_size,
            patch_size=v.patch_size, gw=v.gw, gh=v.gh, ncc_en=False, max_iter=10,
            max_pg=v.max_pg)

    step(clone_map(snap))  # warm
    torch.cuda.synchronize()
    n = [vs.vio_select.launches, vo.vio_observations.launches,
         photometric.photometric_cascade.launches]
    torch.cuda.set_sync_debug_mode("error")
    try:
        fused = step(clone_map(snap))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert [vs.vio_select.launches, vo.vio_observations.launches,
            photometric.photometric_cascade.launches] == [n[0] + 1, n[1] + 1, n[2] + 1]
    monkeypatch.setattr(vio, "frame_kernels_apply", lambda *a, **kw: False)
    plain = step(clone_map(snap))
    assert [vs.vio_select.launches, vo.vio_observations.launches] == [n[0] + 1, n[1] + 1]
    assert int(fused[7]) == int(plain[7]) > 0 and int(fused[8]) == int(plain[8])
    assert int(fused[9]) == int(plain[9])
    assert bit_equal(fused[10], plain[10])


def test_vio_kernels_refuse_bad_inputs(cuda):
    from fastlivo_tpu_torch.ops import vio_observations as vo
    from fastlivo_tpu_torch.ops import vio_select as vs

    a = random_vio_frame(cuda, seed=7, frames=2)
    kw = {k: v for k, v in a.items() if k != "vm"}
    n0 = vs.vio_select.launches
    for bad, err in ((dict(patch_size=1), ValueError),
                     (dict(pg=a["pg"].double()), TypeError),
                     (dict(pg_mask=a["pg_mask"][:-1]), ValueError),
                     (dict(rot=a["rot"].t()), ValueError),
                     (dict(Rci=a["Rci"].double()), TypeError),
                     (dict(img=a["img"][:, :-1]), ValueError)):
        with pytest.raises(err):
            vs.vio_select(a["vm"], **{**kw, **bad})
    with pytest.raises(TypeError):
        vs.vio_select(a["vm"]._replace(vox_idx=a["vm"].vox_idx.long()), **kw)
    assert vs.vio_select.launches == n0
    vs.vio_select(a["vm"], **{**kw, "patch_size": 17})  # past 16: taken, one launch
    assert vs.vio_select.launches == n0 + 1
    args = obs_args(a, vs.vio_select(a["vm"], **kw))
    n1 = vo.vio_observations.launches
    for k, bad in ((6, args[6].long()), (7, args[7][:-1]), (1, args[1].double()),
                   (2, args[2].float()), (3, args[3][:2])):
        with pytest.raises((TypeError, ValueError)):
            vo.vio_observations(a["vm"], *args[:k], bad, *args[k + 1:])
    assert vo.vio_observations.launches == n1


def vio_write_only(dev, kernel):
    """test_kernels_write_only_their_outputs' camera-frame cases."""
    import ctypes

    from fastlivo_tpu_torch.ops import vio_observations as vo
    from fastlivo_tpu_torch.ops import vio_select as vs

    P = {"vio_select_p16": 16, "vio_select_p24": 24, "vio_select_p64": 64}.get(kernel, 8)
    H, W, grid_px = FH, FW, 40
    if kernel == "vio_select_pool_12289":
        H = W = 128
        grid_px = 16
        a = pool_past_stage(random_vio_frame(dev, seed=19, W=W, H=H, grid=grid_px, ring=24),
                            12289)
    else:
        a = random_vio_frame(dev, seed=11, frames=12, P=P)
    vm, cam = a["vm"], a["cam"]
    NP, KO = vm.obs_fid.shape
    T, VC = vm.vox_idx.shape
    R = vm.img_fid.shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda *ts: [t.data_ptr() for t in ts]  # noqa: E731
    sel = vs.vio_select_plain(vm, **{k: v for k, v in a.items() if k != "vm"})
    i32, f32 = dict(dtype=torch.int32, device=dev), dict(dtype=torch.float32, device=dev)
    G, M = (W // grid_px) * (H // grid_px), a["pg"].shape[0]
    if kernel.startswith("vio_select"):
        Nv = a["vox"].shape[0]
        ins = [vm.pos, vm.value, vm.obs_px, vm.obs_rcw, vm.obs_pcw, vm.obs_slot, vm.obs_fid,
               vm.vox_keys, vm.vox_count, vm.vox_idx, vm.imgs, vm.img_fid, cam.fx, cam.fy,
               cam.cx, cam.cy, cam.d, a["rot"], a["pos"], a["Rci"], a["Pci"], a["img"],
               a["pg"], a["pg_mask"], a["vox"], a["vox_mask"], a["outlier_threshold"],
               a["ncc_thre"]]
        scratch = [torch.empty(G, dtype=torch.int64, device=dev),
                   torch.empty(G, dtype=torch.int64, device=dev), torch.empty(H * W, **i32),
                   torch.empty((Nv * VC, 4), **f32), torch.empty(M, **f32),
                   torch.empty((M, 2), **f32), torch.empty(M, **f32)]
        outs = [torch.empty(G, **i32), torch.empty((G, 3), **f32),
                torch.empty((G, 3, P, P), **f32), torch.empty(G, **i32),
                torch.empty(G, dtype=torch.bool, device=dev), torch.empty(G, **f32),
                torch.empty(G, **f32), torch.empty((G, 3), **f32), torch.empty((G, 2), **f32),
                torch.empty(G, **f32), torch.empty(G, dtype=torch.bool, device=dev),
                torch.empty((3, 3), **f32), torch.empty(3, **f32)]
        # the wide instance's device scratch (P = 64), an output here
        n_wide = vs._launcher().wide_floats(P, G)
        assert (n_wide > 0) == (P == 64)
        wide = [torch.empty(n_wide, **f32)] if n_wide else []
        grid = ctypes.c_int(0)
        got = launch_guarded(lambda *v: vs._launcher()(
            *ptr(*v), *([] if n_wide else [None]), NP, KO, T, VC, R, H, W, M, Nv, grid_px,
            H // grid_px, G, P, 0, 12, 1, ctypes.byref(grid), stream), ins,
            scratch + outs + wide)[len(scratch):len(scratch) + len(outs)]
        want = [*sel[0], *sel[1], *sel[2]]
        names = list(sel[0]._fields) + ["pos", "px", "score", "add", "rcw", "pcw"]
    else:
        if kernel == "vio_observations_3264":
            vm, args, _, _ = obs_rows_args(dev, 3264)
            assert (NP, KO, T, VC, R) == (*vm.obs_fid.shape, *vm.vox_idx.shape,
                                          vm.img_fid.shape[0])
        else:
            args = obs_args(a, sel)
        wm, wopc, wosc, wpose = vo.vio_observations_plain(clone_map(vm), *args)
        (cam, img, rot2, pos2, Rci, Pci, t_idx, t_valid, t_slevel, rcw, pcw, npos, npx, nscore,
         nadd, fid) = args
        B = t_idx.shape[0]
        ins = [vm.n_pts, vm.img_fid, cam.fx, cam.fy, cam.cx, cam.cy, cam.d, img, rot2, pos2,
               Rci, Pci, rcw, pcw, fid, t_idx, t_valid, t_slevel, npos, npx, nscore, nadd]
        names = ["pos", "value", "n_obs", "obs_px", "obs_rcw", "obs_pcw", "obs_slot",
                 "obs_fid", "obs_level", "vox_keys", "vox_count", "vox_idx"]
        launch_fn, size = vo._launcher()
        k = size(B)
        assert (k > 0) == (B > 2048)
        outs = [getattr(vm, f) for f in names] + [
            torch.empty((B, 2), **f32), torch.empty(B, **f32), torch.empty((), **i32),
            torch.empty((3, 3), **f32), torch.empty(3, **f32), torch.empty(B, **i32),
            torch.zeros(max(k, 1), **i32)]

        def launch(n_pts, img_fid, fx, fy, cx, cy, d, img, rot2, pos2, Rci, Pci, rcw, pcw, fid,
                   t_idx, t_valid, t_slevel, npos, npx, nscore, nadd, pos, value, n_obs, obs_px,
                   obs_rcw, obs_pcw, obs_slot, obs_fid, obs_level, vk, vc, vi, opc, osc, npo,
                   rcw2, pcw2, nrow, ws):
            grid = ctypes.c_int(0)
            return launch_fn(*ptr(
                pos, value, n_obs, n_pts, obs_px, obs_rcw, obs_pcw, obs_slot, obs_fid,
                obs_level, vk, vc, vi, img_fid, fx, fy, cx, cy, d, img, rot2, pos2, Rci, Pci,
                rcw, pcw, fid, t_idx, t_valid, t_slevel, npos, npx, nscore, nadd, opc, osc, npo,
                rcw2, pcw2, nrow), ws.data_ptr() if k else None, NP, KO, T, VC, R, FH, FW, B,
                12, ctypes.byref(grid), stream)

        got = launch_guarded(launch, ins, outs)
        assert not got.pop().any()  # the global scratch back at 0
        got = got[:-1]  # nrow, scratch
        want = [getattr(wm, f) for f in names] + [wopc, wosc, wm.n_pts, *wpose]
        names = names + ["opc", "oscore", "n_pts", "rcw2", "pcw2"]
    for g, w, name in zip(got, want, names):
        assert bit_equal(g, w), name


# --- the LIO frame's map stages (tiled_delete_boxes, voxel_centroids) --------

def centre32(v, vs=0.5):
    """The f32 centre of voxel v, as the kernel and the torch code round it."""
    return (np.float32(v) + np.float32(0.5)) * np.float32(vs)


def stage_map(dev, n=200000, pool=4096, dims=(64, 64, 16), seed=0, compacted=False):
    """A tiled map of surface-like points over +-60 m (negative tiles
    included); with `compacted`, a slab cleared and the map compacted, so
    that slots past n_alloc keep stale keys and cells."""
    rng = np.random.default_rng(seed)
    p = np.stack([rng.uniform(-60, 60, n), rng.uniform(-60, 60, n),
                  np.abs(np.sin(0.1 * rng.uniform(-60, 60, n))) * 6 - 3], 1).astype(np.float32)
    m = tm.build_host(p, dims, pool, 0.5, device=dev)
    if compacted:
        lo = torch.tensor([[-60.0, -60.0, -5.0]], device=dev)
        hi = torch.tensor([[-20.0, 60.0, 5.0]], device=dev)
        m = tm.compact(tm.delete_boxes_plain(m, lo, hi))
        assert int(m.n_alloc) < pool and bool((m.slot_key[int(m.n_alloc):] != 0).any())
    return m


def face_boxes(dev, B, seed):
    """B random boxes whose faces lie on cell centres (inclusive on both
    sides), one with a NaN bound when B > 2."""
    rng = np.random.default_rng(seed)
    v = np.sort(rng.integers(-120, 120, (B, 3, 2)), axis=-1)
    v[:, 2] = np.sort(rng.integers(-8, 8, (B, 2)), axis=-1)
    lo, hi = centre32(v[..., 0]), centre32(v[..., 1])
    if B > 2:
        lo[2, 1] = np.nan
    return (torch.from_numpy(lo.astype(np.float32)).to(dev),
            torch.from_numpy(hi.astype(np.float32)).to(dev))


TRACKER_BOXES = [  # lasermap_fov_segment's slabs at Config()'s cube (one per axis side)
    ((-1000.0, -1000.0, -1000.0), (-550.0, 1000.0, 1000.0)),
    ((-1000.0, 550.0, -1000.0), (1000.0, 1000.0, 1000.0)),
    ((-1000.0, -1000.0, -1000.0), (1000.0, 1000.0, -550.0))]


@pytest.mark.parametrize("boxes", ["tracker", "faces_1", "faces_3", "faces_6", "inert",
                                   "faces_40", "faces_300"])
@pytest.mark.parametrize("compacted", [False, True], ids=["built", "compacted"])
def test_tiled_delete_boxes_matches_plain(cuda, boxes, compacted):
    """The kernel clears exactly the plain version's cells, bit for bit,
    in every slot (stale ones past n_alloc included), and writes no other
    field; with 40 boxes (all staged at once, NaN bounds among them) and
    300 (staged in turns), in one wave of blocks."""
    m = stage_map(cuda, compacted=compacted)
    if boxes == "tracker":
        lo, hi = (torch.tensor([b[i] for b in TRACKER_BOXES], device=cuda) for i in (0, 1))
    elif boxes == "inert":
        lo, hi = torch.ones((2, 3), device=cuda), torch.zeros((2, 3), device=cuda)
    else:
        lo, hi = face_boxes(cuda, int(boxes.split("_")[1]), seed=len(boxes))
    want = tm.delete_boxes_plain(clone_map(m), lo, hi)
    n0 = tm.delete_boxes.launches
    got = tm.delete_boxes(clone_map(m), lo, hi)
    torch.cuda.synchronize()
    assert tm.delete_boxes.launches == n0 + 1
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert 0 < tm.delete_boxes.grid <= 8 * sms
    for f, g, w in zip(m._fields, got, want):
        assert torch.equal(g, w), f
    killed = int((want.cell_check == tm.EMPTY_CHECK).sum() - (m.cell_check == tm.EMPTY_CHECK).sum())
    assert (killed > 0) == boxes.startswith("faces")


def test_tiled_delete_boxes_makes_no_synchronising_call(cuda):
    """Given device boxes, delete_boxes is one launch and no synchronising
    call (torch's sync debug mode set to raise)."""
    m = stage_map(cuda)
    lo, hi = face_boxes(cuda, 3, seed=5)
    want = tm.delete_boxes_plain(clone_map(m), lo, hi)
    tm.delete_boxes(clone_map(m), lo, hi)  # built and warm
    got = clone_map(m)
    torch.cuda.synchronize()
    n0 = tm.delete_boxes.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        tm.delete_boxes(got, lo, hi)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tm.delete_boxes.launches == n0 + 1
    assert torch.equal(got.cell_check, want.cell_check)


def filter_case(case, seed=0):
    """(pts (N, 3) f32, valid, leaf or None, inv_leaf or None, max_out) of
    the two callers' shapes and edges."""
    rng = np.random.default_rng(seed)
    n, max_out, leaf, inv = 32768, 16384, 0.5, None
    if case == "camera":  # the camera frame's 0.2 m leaf as a reciprocal
        n, max_out, leaf, inv = 32768, 8192, None, np.float32(1.0) / np.float32(0.2)
    if case == "large":  # 586 tiles: look-back windows of 32 status words
        n = 600000
    p = rng.uniform(-25, 25, (n, 3)).astype(np.float32)
    p[: n // 3] = p[n // 3: 2 * (n // 3)] + rng.normal(0, 0.1, (n // 3, 3))
    valid = rng.random(n) > 0.05
    if case == "lio":
        valid[24000:] = False  # a 24000-point scan in the 32768-row buffer
    if case == "edges":
        p[:64] = np.float32(-0.0)
        p[64:100, 1] = np.float32(-0.0)
        p[100, 0], p[101, 1], p[102, 2], p[103] = np.nan, np.inf, -np.inf, np.nan
        max_out = 3000  # overflow: more voxels than rows
    if case == "all_invalid":
        valid[:] = False
    if case == "long_run":  # one voxel of 5000 rows: a run past several tiles
        p[:5000] = np.float32(0.25) + rng.uniform(-0.2, 0.2, (5000, 3)).astype(np.float32)
        valid[:5000] = True
    if case == "crossing":  # runs of 600 rows: every 1024-row tile ends inside one
        v = np.arange(n) // 600
        p = np.stack([0.5 * v + 0.25, np.full(n, 0.25), np.full(n, 0.25)], 1)
        p = (p + rng.uniform(-0.2, 0.2, (n, 3))).astype(np.float32)
        valid[:] = True
    if case in ("n1", "tile_plus_1"):  # one row; one tile and a row
        n = 1 if case == "n1" else 1025
        p, valid = p[:n], np.ones(n, bool)
    if case == "max_out_1":
        max_out = 1
    return p, valid, leaf, inv, max_out


@pytest.mark.parametrize("case", ["lio", "camera", "edges", "all_invalid", "large",
                                  "long_run", "crossing", "n1", "tile_plus_1", "max_out_1"])
def test_voxel_centroids_match_the_cpu_bit_for_bit(cuda, case, monkeypatch):
    """voxel_downsample_device on the card (one voxel_centroids launch after
    the sort) gives the plain version's bits run on the CPU, and the same
    bits on every launch; the card's plain version (torch.segment_reduce
    on the card) within 1e-6. Also one voxel holding 5000 rows, a run
    across every tile end, N = 1, N = one tile + 1 and max_out = 1."""
    from fastlivo_tpu_torch.ops import voxel_filter as vf

    p, valid, leaf, inv, max_out = filter_case(case)
    args = [torch.from_numpy(p), torch.from_numpy(valid)]
    kw = {}
    if inv is not None:
        kw["inv_leaf"] = torch.tensor(inv)
    lf = None if leaf is None else torch.tensor(leaf, dtype=torch.float32)
    want = vf.voxel_downsample_device(*args, lf, max_out, **kw)
    dargs = [a.to(cuda) for a in args]
    dkw = {k: v.to(cuda) for k, v in kw.items()}
    dlf = None if lf is None else lf.to(cuda)
    n0 = vf.voxel_centroids.launches
    runs = [vf.voxel_downsample_device(*dargs, dlf, max_out, **dkw) for _ in range(2)]
    torch.cuda.synchronize()
    assert vf.voxel_centroids.launches == n0 + 2
    for out, mask in runs:
        assert torch.equal(mask.cpu(), want[1])
        assert torch.equal(out.cpu().view(torch.int32), want[0].view(torch.int32))
    monkeypatch.setattr(vf, "voxel_centroids", vf.voxel_centroids_plain)
    plain = vf.voxel_downsample_device(*dargs, dlf, max_out, **dkw)
    assert torch.equal(plain[1].cpu(), want[1])
    np.testing.assert_allclose(plain[0].cpu().numpy(), want[0].numpy(), rtol=1e-6, atol=1e-6)
    if case in ("lio", "camera", "edges", "large"):
        assert int(want[1].sum()) > 1000
    expect = {"n1": 1, "max_out_1": 1, "crossing": -(-len(p) // 600)}
    if case in expect:
        assert int(want[1].sum()) == expect[case]
    if case == "long_run":
        keys, _ = vf._sorted_keys(*args, lf, None)
        assert int(torch.unique_consecutive(keys, return_counts=True)[1].max()) >= 5000


@pytest.mark.parametrize("cols", [1, 5, 12, 160])
def test_voxel_centroids_any_width_matches_the_cpu(cuda, cols):
    """Rows of 1 to 160 columns through the kernel's general-width
    instance (its tile shrinks so that a tile's rows fit in shared memory:
    1024 rows at 5 columns, 512 at 12, 32 at 160, 1024 tiles then): the
    plain version's bits on the CPU, the scratch back at 0; 161 columns
    raise."""
    from fastlivo_tpu_torch.ops import voxel_filter as vf

    p, valid, leaf, _, max_out = filter_case("lio")
    rng = np.random.default_rng(cols)
    x = np.concatenate([p, rng.normal(0, 5, (len(p), 160)).astype(np.float32)], 1)
    x = torch.from_numpy(np.ascontiguousarray(x[:, :cols]))
    keys, order = vf._sorted_keys(torch.from_numpy(p), torch.from_numpy(valid),
                                  torch.tensor(leaf, dtype=torch.float32), None)
    want = vf.voxel_centroids_plain(keys, order, x, max_out)
    dk, do = keys.to(cuda), order.to(cuda)
    got = vf.voxel_centroids(dk, do, x.to(cuda), max_out)
    torch.cuda.synchronize()
    assert all(bit_equal(g.cpu(), w) for g, w in zip(got, want))
    from fastlivo_tpu_torch.ops import photometric

    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert not photometric._ticket(got[0].device, stream).any()
    if cols == 160:
        with pytest.raises(ValueError):
            vf.voxel_centroids(dk, do, torch.zeros((len(p), 161), device=cuda), max_out)


def test_lidar_frame_step_makes_no_synchronising_call(cuda, monkeypatch):
    """The whole steady lidar_frame_step on one card (the tiled map, the
    LIO cascade, the TLS fit, no cache_knn): the undistortion (one
    undistort launch), the voxel filter (the sort and one voxel_centroids
    launch), the cascade (one lio_cascade launch), the insert (the sort and
    its two launches) and the frame's outputs make no
    synchronising call (torch's sync debug mode set to raise), and give the
    same bits as the same step called without the mode."""
    no_sync_frame_step(cuda, monkeypatch)


def test_lidar_frame_step_at_1024_imu_makes_no_synchronising_call(cuda, monkeypatch):
    """The same at capacity.max_imu_per_group 1024: the scan's 8200-row
    pose table undistorted by one undistort launch in its global layout,
    with no synchronising call."""
    no_sync_frame_step(cuda, monkeypatch, per_group=1024)


def no_sync_frame_step(cuda, monkeypatch, per_group=None):
    from fastlivo_tpu_torch import frame_step, pipeline
    from fastlivo_tpu_torch import imu as imu_mod
    from fastlivo_tpu_torch.ops import lio_cascade
    from fastlivo_tpu_torch.ops import voxel_filter as vf

    calls = []
    real = pipeline.lidar_frame_step

    def spy(*a, **kw):
        calls.append((a[:1] + (clone_map(a[1]),) + a[2:], kw))
        return real(*a, **kw)

    monkeypatch.setattr(pipeline, "lidar_frame_step", spy)
    pipe = small_lio(cuda, per_group=per_group)
    pipe.spin()
    assert len(calls) > 5
    if per_group is not None:
        assert pipe.max_scan_poses == 8 * (per_group + 1)
    a, kw = calls[-1]
    want = frame_step.lidar_frame_step(*(a[:1] + (clone_map(a[1]),) + a[2:]), **kw)
    torch.cuda.synchronize()
    counts = lambda: (vf.voxel_centroids.launches, lio_cascade.lio_cascade.launches,  # noqa
                      knn_plane.knn5_plane_tiled.launches, tm.delete_boxes.launches,
                      tm.insert_keys.launches, tm.insert_tiles.launches,
                      imu_mod.undistort.launches)
    n0 = counts()
    m = clone_map(a[1])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = frame_step.lidar_frame_step(*(a[:1] + (m,) + a[2:]), **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert counts() == (n0[0] + 1, n0[1] + 1, n0[2], n0[3], n0[4] + 1, n0[5] + 1, n0[6] + 1)
    assert isinstance(got[5], torch.Tensor) and got[5].device.type == "cuda"
    for g, w in zip(got[2:], want[2:]):
        assert bit_equal(g, w)
    assert all(torch.equal(g, w) for g, w in zip(got[0], want[0]))
    assert all(torch.equal(g, w) for g, w in zip(got[1], want[1]))


def test_lio_pipeline_runs_the_map_stage_kernels(cuda, monkeypatch):
    """A LIO run on the card clears its boxes through tiled_delete_boxes,
    filters every steady scan through voxel_centroids, undistorts every
    scan (the steady ones and the bootstrap's) through undistort and makes
    every insert (the steady scans' and the one that builds the map)
    through the insert's two launches."""
    from fastlivo_tpu_torch import imu as imu_mod
    from fastlivo_tpu_torch.ops import voxel_filter as vf

    inserts = []
    real = tm.insert
    monkeypatch.setattr(tm, "insert", lambda *a: inserts.append(1) or real(*a))
    pipe = small_lio(cuda)
    count = lambda: (tm.delete_boxes.launches, vf.voxel_centroids.launches,  # noqa: E731
                     imu_mod.undistort.launches, tm.insert_keys.launches,
                     tm.insert_tiles.launches)
    n0 = count()
    outs = pipe.spin()
    steady = [o for o in outs if o.iters > 0]
    n = [b - a for a, b in zip(n0, count())]
    assert len(steady) > 5
    assert n[0] >= len(steady)  # the tracker fires each frame
    assert n[1] == len(steady)
    assert n[2] > len(steady)  # and the bootstrap scans
    assert n[3] == n[4] == len(inserts) > len(steady)


def map_stage_write_only(dev, kernel):
    """test_kernels_write_only_their_outputs' map-stage cases."""
    import ctypes

    from fastlivo_tpu_torch.ops import voxel_filter as vf

    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda *ts: [t.data_ptr() for t in ts]  # noqa: E731
    if kernel == "tiled_delete_boxes":
        m = stage_map(dev, compacted=True)
        lo, hi = face_boxes(dev, 4, seed=3)
        T = m.slot_key.shape[0]
        grid = ctypes.c_int(0)
        got = launch_guarded(lambda sk, vs, a, b, cc: tm._delete_launcher()(
            *ptr(sk, vs, a, b, cc), 4, T, tm.EMPTY_CHECK, tm._sm_count(dev),
            ctypes.byref(grid), stream),
            [m.slot_key, m.voxel_size, lo, hi], [m.cell_check])
        want = [tm.delete_boxes_plain(clone_map(m), lo, hi).cell_check]
    else:
        p, valid, leaf, _, _ = filter_case("edges")
        n, max_out = 16379, 8191
        pts = torch.from_numpy(p[:n]).to(dev)
        keys, order = vf._sorted_keys(pts, torch.from_numpy(valid[:n]).to(dev),
                                      torch.tensor(leaf, device=dev), None)
        launch, size = vf._library()
        outs = [torch.empty((max_out, 3), device=dev),
                torch.empty(max_out, dtype=torch.bool, device=dev),
                torch.zeros(size(n, 3), dtype=torch.int32, device=dev)]  # the scratch
        grid = ctypes.c_int(0)
        got = launch_guarded(lambda k, o, x, *r: launch(
            *ptr(k, o, x, *r), n, 3, max_out, ctypes.byref(grid), stream),
            [keys, order, pts], outs)
        assert not got[2].any()  # the ticket, the block count and the tile status words
        want = vf.voxel_centroids_plain(keys.cpu(), order.cpu(), pts.cpu(), max_out)
        got = [g.cpu() for g in got[:2]]
    for g, w in zip(got, want):
        assert bit_equal(g, w)


# --- the LIO frame's insert and undistortion --------------------------------

def frame_cases():
    import torch_frame_cases

    return torch_frame_cases


def replay_insert(dev, case, step_fn):
    """tests/torch_frame_cases.py's insert stream on a card map and a CPU
    map side by side; step_fn(card map, CPU map, pts, valid) at each
    insert returns the two maps after it."""
    fc = frame_cases()
    dims, pool, steps = fc.insert_case(case)
    mc = tm.empty_tiled_map(dims, pool, fc.VOX, device=dev)
    mh = tm.empty_tiled_map(dims, pool, fc.VOX, device="cpu")
    for step in steps:
        if step[0] == "compact":
            lo, hi = (torch.from_numpy(b[None]) for b in step[1:])
            mc = tm.compact(tm.delete_boxes_plain(mc, lo.to(dev), hi.to(dev)))
            mh = tm.compact(tm.delete_boxes_plain(mh, lo, hi))
            continue
        mc, mh = step_fn(mc, mh, torch.from_numpy(step[1]), torch.from_numpy(step[2]))
    return mc, mh


def insert_launches():
    return (tm.insert_keys.launches, tm.insert_tiles.launches)


def tiles_scratch_clear(dev) -> bool:
    """The stream's scratch (photometric._ticket), which the insert's
    second launch shares with the other ticketed kernels, all 0."""
    from fastlivo_tpu_torch.ops import photometric

    return not photometric._ticket(dev, torch.cuda.current_stream(dev).cuda_stream).any()


def winner_flags(m, rows, sg, order):
    """The flags the tiles pass writes: 1 at each aliased tile winner's
    row, 2 at a fresh one's, from the map before the insert."""
    tile_head = tm._head((sg.to(torch.int64) + tm.KEY_BIAS) >> 9) & (sg < 0)
    run, start = tm._runs(sg)
    win = order[tm._least_in_runs(run, rows[3][order], sg < 0) & tile_head[start]]
    flags = torch.zeros(sg.shape[0], dtype=torch.int32, device=sg.device)
    flags[win] = torch.where(m.dir_check[rows[0][win]] != tm.EMPTY_CHECK, 1, 2).to(torch.int32)
    return flags


@pytest.mark.parametrize("case", ["stream", "aliasing", "overflow", "head_not_ok", "compacted",
                                  "empty", "one_row", "all_invalid", "straddle",
                                  "overflow_mid_tile", "nearest_later", "equal_bits",
                                  "long_run", "dir_2_22"])
def test_tiled_insert_matches_plain(cuda, case):
    """insert on a card map (the keys launch, the sort of 32-bit keys and
    one launch of the tiles and cells passes; at B = 0 that launch alone,
    over 3 blocks, else 3 ceil(B / 1024)) leaves every TiledMap field
    equal to insert_plain's on the card and on the CPU after every batch
    of tests/torch_frame_cases.py's streams: directory aliasing, pool
    overflow (also in the middle of a tile), fresh winners on both sides
    of a tile end, runs whose first row is not ok, a compacted map with
    stale slots, B = 0 and 1, no valid row, nearest rows after farther
    ones, equal distances, runs longer than a tile and across tile ends,
    a directory of 2^22 entries with a row in its last cell; the stream's
    scratch back at 0 after every launch."""
    def step(mc, mh, p, v):
        want_card = tm.insert_plain(clone_map(mc), p.to(cuda), v.to(cuda))
        want_cpu = tm.insert_plain(mh, p, v)
        n0 = insert_launches()
        got = tm.insert(mc, p.to(cuda), v.to(cuda))
        torch.cuda.synchronize()
        B = p.shape[0]
        assert insert_launches() == (n0[0] + (B > 0), n0[1] + 1)
        assert tm.insert_tiles.grid == 3 * max(1, -(-B // 1024)) and tiles_scratch_clear(cuda)
        for f, g, wc, wh in zip(got._fields, got, want_card, want_cpu):
            assert torch.equal(g, wc), f
            assert torch.equal(g.cpu(), wh), f
        return got, want_cpu

    mc, _ = replay_insert(cuda, case, step)
    if case == "overflow":
        assert int(mc.n_dropped) > 0 and int(mc.n_alloc) == mc.slot_key.shape[0]


def frame_insert_batch(dev, n=16384, seed=4):
    """A LIO frame's insert: n rows over the stage map's +-60 m (new tiles
    and stored cells), a tenth of them near-duplicates, 5% invalid."""
    rng = np.random.default_rng(seed)
    p = np.stack([rng.uniform(-70, 70, n), rng.uniform(-70, 70, n),
                  np.abs(np.sin(0.1 * rng.uniform(-60, 60, n))) * 6 - 3], 1)
    k = n // 10
    p[:k] = p[k:2 * k] + rng.normal(0, 0.05, (k, 3))
    return (torch.from_numpy(p.astype(np.float32)).to(dev),
            torch.from_numpy(rng.random(n) > 0.05).to(dev))


@pytest.mark.parametrize("pool", [4096, 1200])
def test_tiled_insert_passes_match_plain_at_frame_size(cuda, pool):
    """At a LIO frame's 16384 rows into a built map (and one whose pool
    overflows): the keys kernel gives the plain pass's int32 keys and
    rows, the second launch the plain tiles and cells passes' directory,
    slot keys, cells and counts, and the flags at the tile winners; the
    whole insert every field of insert_plain's on the card and on the
    CPU, twice in a row; insert_cells refuses a card map."""
    m = stage_map(cuda, pool=pool)
    p, v = frame_insert_batch(cuda)
    mp, mk = clone_map(m), clone_map(m)
    gkey, rows = tm.insert_keys_plain(mp, p, v)
    g2, r2 = tm.insert_keys(mk, p, v)
    assert g2.dtype == torch.int32 and torch.equal(gkey, g2) and torch.equal(rows, r2)
    sg, order = torch.sort(gkey, stable=True)
    flags = winner_flags(m, rows, sg, order)
    plain_counts = tm.insert_sorted_plain(mp, p, v, rows.clone(), sg, order)
    counts = tm.insert_tiles(mk, p, v, r2, sg, order)
    torch.cuda.synchronize()
    for f in ("dir_check", "dir_slot", "slot_key", "cell_check", "pts"):
        assert torch.equal(getattr(mk, f), getattr(mp, f)), f
    assert [int(x) for x in counts] == [int(x) for x in plain_counts]
    assert torch.equal(r2[:4], rows[:4]) and torch.equal(r2[4], flags)
    assert bool((flags == 2).any())
    if pool < 4096:
        assert int(counts[1]) > int(m.n_dropped)
    with pytest.raises(ValueError):
        tm.insert_cells(mk, p, v, r2, sg, order, counts[1])
    mc, mh = clone_map(m), type(m)(*(t.cpu() for t in m))
    for _ in range(2):
        mc = tm.insert(mc, p, v)
        mh = tm.insert_plain(mh, p.cpu(), v.cpu())
        torch.cuda.synchronize()
        for f, g, w in zip(mc._fields, mc, mh):
            assert torch.equal(g.cpu(), w), f


@pytest.mark.parametrize("into", ["built", "empty"])
@pytest.mark.parametrize("B", [0, 1, 1023, 1025, 65536])
def test_tiled_insert_tiles_at_row_counts(cuda, B, into):
    """The second launch around tile ends (B = 1023, 1025: one tile and a
    second of one row), alone at B = 0 and 1, and at 65536 rows (192
    blocks), into a built map and into an empty one whose every tile
    winner is fresh and whose 64 slots overflow part way (rows past T):
    its directory, slot keys, cells, counts and flags equal the plain
    passes', the whole insert every field of insert_plain's on the card
    and on the CPU, and the scratch is back at 0 after each launch."""
    m = (stage_map(cuda, n=20000, pool=4096) if into == "built"
         else tm.empty_tiled_map((64, 64, 16), 64, 0.5, device=cuda))
    p, v = frame_insert_batch(cuda, n=B, seed=B)
    mp, mk = clone_map(m), clone_map(m)
    gkey, rows = tm.insert_keys_plain(mp, p, v)
    sg, order = torch.sort(gkey, stable=True)
    r2 = rows.clone()
    flags = winner_flags(m, rows, sg, order)
    want = tm.insert_sorted_plain(mp, p, v, rows, sg, order)
    got = tm.insert_tiles(mk, p, v, r2, sg, order)
    torch.cuda.synchronize()
    assert tm.insert_tiles.grid == 3 * max(1, -(-B // 1024)) and tiles_scratch_clear(cuda)
    for f in ("dir_check", "dir_slot", "slot_key", "cell_check", "pts"):
        assert torch.equal(getattr(mk, f), getattr(mp, f)), f
    assert [int(x) for x in got] == [int(x) for x in want]
    assert torch.equal(r2[4], flags) and torch.equal(r2[:4], rows[:4])
    if into == "empty" and B > 1000:
        assert bool((flags != 1).all()) and int((flags == 2).sum()) > 64  # rows past T
        assert int(got[0]) == 64
    mc, mh = clone_map(m), type(m)(*(t.cpu() for t in m))
    mc = tm.insert(mc, p, v)
    mh = tm.insert_plain(mh, p.cpu(), v.cpu())
    torch.cuda.synchronize()
    for f, g, w in zip(mc._fields, mc, mh):
        assert torch.equal(g.cpu(), w), f
    assert tiles_scratch_clear(cuda)


def test_tiled_insert_long_runs_and_the_largest_directory(cuda):
    """The second launch where one voxel holds 5000 rows (a run across
    four block ends, its nearest row in the last block, with a nearer row
    of a directory-aliasing tile that is dropped) beside runs that end on
    and just past a block end, into a (2, 2, 2) directory; and a
    directory of 2^22 entries (dir_idx << 9 | cell reaches 2^31 - 1) with
    rows in its last entry's last cell and invalid rows after them: every
    field equal to insert_plain's on the card and on the CPU."""
    rng = np.random.default_rng(20)
    vox = lambda v, n: (np.asarray(v, np.float64) + rng.uniform(0.05, 0.95, (n, 3))) * 0.5  # noqa
    long_run = vox([0, 0, 1], 5000)
    long_run[::4] = vox([16, 0, 1], 1250)  # an aliasing tile's rows, dropped
    long_run[4097] = [0.2501, 0.25, 0.75]  # the nearest ok row
    long_run[4098] = [8.25, 0.25, 0.75]  # nearer, not ok
    p1 = np.concatenate([vox([0, 0, 0], 1024), vox([1, 0, 0], 1), long_run,
                         vox([2, 0, 0], 1023), vox([3, 0, 0], 1025)])
    edge = np.array([[-0.2, -0.3, -0.1], [-0.24, -0.26, -0.25], [-0.26, -0.24, -0.27]])
    p2 = np.concatenate([edge, rng.uniform(-3, 3, (3000, 3))])
    for dims, pts in (((2, 2, 2), p1), ((256, 256, 64), p2)):
        pts = torch.from_numpy(pts.astype(np.float32))
        valid = torch.from_numpy(rng.random(len(pts)) > 0.05)
        valid[:3] = True
        mc = tm.empty_tiled_map(dims, 64, 0.5, device=cuda)
        mh = tm.empty_tiled_map(dims, 64, 0.5, device="cpu")
        for _ in range(2):
            want = tm.insert_plain(clone_map(mc), pts.to(cuda), valid.to(cuda))
            mc = tm.insert(mc, pts.to(cuda), valid.to(cuda))
            mh = tm.insert_plain(mh, pts, valid)
            torch.cuda.synchronize()
            for f, g, w, h in zip(mc._fields, mc, want, mh):
                assert torch.equal(g, w) and torch.equal(g.cpu(), h), f
            assert tiles_scratch_clear(cuda)
        if dims == (256, 256, 64):
            assert int(tm.insert_keys_plain(mh, pts, valid)[0][0]) == -1


def undistort_args(dev, d, pose="f32"):
    """undistort's arguments from a torch_frame_cases dict on `dev`. pose:
    "f32" (contiguous), "f64" (contiguous) or "pack" (the f64 column views
    of a pose pack, as imu.propagate returns on the card)."""
    from fastlivo_tpu_torch import imu as imu_mod
    from fastlivo_tpu_torch.state import NavState

    t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    f64 = torch.float64
    z3 = t(np.zeros(3), f64)
    st = NavState(t(d["state_rot"], f64), t(d["state_pos"], f64), z3, z3, z3, z3,
                  t(np.eye(18), f64))
    M = len(d["offs"])
    if pose == "pack":
        pack = np.zeros((M + 1, 24))
        pack[:M, 0], pack[:M, 1:10] = d["offs"], d["rot"].reshape(M, 9)
        for j, f in enumerate(("pos", "vel", "acc", "gyr")):
            pack[:M, 10 + 3 * j:13 + 3 * j] = d[f]
        table = imu_mod.pose_views(t(pack, f64))
    else:
        dt = torch.float32 if pose == "f32" else f64
        table = imu_mod.PoseTable(*(t(d[f], dt) for f in ("offs", "rot", "pos", "vel", "acc",
                                                          "gyr")))
    z = t(np.zeros(3), torch.float32)
    calib = imu_mod.ImuCalib(t(1.0, torch.float32), z, z, z, z, t(d["lid_rot"]), t(d["lid_off"]))
    return st, table, t(d["pts"]), t(d["t_rel"]), t(d["pmask"]), calib


@pytest.mark.parametrize("pose", ["f32", "f64", "pack"])
@pytest.mark.parametrize("case", ["scan", "small_angle", "offset_hits", "masked", "table_512",
                                  "table_2", "table_max", "table_513", "table_1024"])
def test_undistort_matches_plain(cuda, case, pose):
    """undistort on the card (one launch) gives undistort_plain's bits on
    the card, and within 1e-5 m of undistort_plain on the CPU (CUDA's
    sinf / cosf against the CPU's); with the pose table f32, f64, or the
    f64 column views of a pose pack (rows 24 values apart), from 2 rows
    to the largest table the kernel stages in shared memory, and the
    pipeline's tables past it (max_imu_per_group 513 and 1024: 4112 and
    8200 rows, searched in global memory)."""
    from fastlivo_tpu_torch import imu as imu_mod

    d = frame_cases().undistort_case(case)
    args = undistort_args(cuda, d, pose)
    want = imu_mod.undistort_plain(*args)
    n0 = imu_mod.undistort.launches
    got = imu_mod.undistort(*args)
    torch.cuda.synchronize()
    assert imu_mod.undistort.launches == n0 + 1
    assert bit_equal(got, want)
    cpu = imu_mod.undistort_plain(*undistort_args("cpu", d, pose))
    np.testing.assert_allclose(got.cpu().numpy(), cpu.numpy(), rtol=0, atol=1e-5)
    pm = d["pmask"]
    assert bit_equal(got.cpu()[~torch.from_numpy(pm)], torch.from_numpy(d["pts"][~pm]))


@contextlib.contextmanager
def plain_refused(*where):
    """Each (module, name) replaced by a function that raises while the
    block runs: a kernel's wrapper on the card must not reach its plain
    version's code."""
    saved = [(m, n, getattr(m, n)) for m, n in where]

    def refuse(*a, **kw):
        raise AssertionError("the plain version ran on the card")

    try:
        for m, n, _ in saved:
            setattr(m, n, refuse)
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def test_undistort_refuses_tables_past_shared_memory(cuda):
    """Pose tables at the shared-memory stage's boundary are taken, none
    refused (UNDISTORT_STAGE_M = 4104 rows, staged; 4105, 4112 and 8200
    rows, max_imu_per_group 1024, searched in global memory) each run in
    one undistort launch, the plain version's code not reached, and give
    undistort_plain's bits, on f32 and f64 tables with padded, unsorted,
    duplicate and NaN point times (tests/test_torch_frame_kernels.py's
    search cases); the launcher itself takes 4105 rows and refuses 0."""
    import ctypes

    from fastlivo_tpu_torch import imu as imu_mod

    fc = frame_cases()
    assert imu_mod.UNDISTORT_STAGE_M == fc.UNDISTORT_STAGE_M == 4104
    for M in (4104, 4105, 4112, 8200):
        for kind in fc.UNDISTORT_KINDS:
            d = fc.undistort_kind_case(M, kind)
            for pose in ("f32", "f64"):
                args = undistort_args(cuda, d, pose)
                n0 = imu_mod.undistort.launches
                with plain_refused((imu_mod, "undistort_plain")):
                    got = imu_mod.undistort(*args)
                torch.cuda.synchronize()
                assert imu_mod.undistort.launches == n0 + 1
                assert bit_equal(got, imu_mod.undistort_plain(*args)), (M, kind, pose)
    st, table, pts, t_rel, pmask, calib = undistort_args(cuda, fc.undistort_kind_case(
        4105, "padded"))
    out = torch.empty_like(pts)
    fields = (ctypes.c_void_p * 6)(*[f.data_ptr() for f in table])
    strides = (ctypes.c_longlong * 6)(1, 9, 3, 3, 3, 3)
    ptr = lambda *ts: [t.data_ptr() for t in ts]  # noqa: E731
    launch = lambda M: imu_mod._undistort_launcher()(  # noqa: E731
        fields, strides, M, 0,
        *ptr(st.rot, st.pos, calib.lid_rot, calib.lid_off, pts, t_rel, pmask, out),
        pts.shape[0], torch.cuda.current_stream(cuda).cuda_stream)
    assert launch(4105) == 0 and launch(0) != 0
    torch.cuda.synchronize()
    assert bit_equal(out, imu_mod.undistort_plain(st, table, pts, t_rel, pmask, calib))


def test_undistort_and_insert_refuse_bad_inputs(cuda):
    """Inputs the kernels do not take raise: CPU points for a card map,
    an f32 state, an f64 calibration, a mask that is not bool."""
    from fastlivo_tpu_torch import imu as imu_mod

    st, table, pts, t_rel, pmask, calib = undistort_args(cuda, frame_cases().undistort_case(
        "scan"))
    with pytest.raises(TypeError):
        imu_mod.undistort(st._replace(rot=st.rot.float()), table, pts, t_rel, pmask, calib)
    with pytest.raises(TypeError):
        imu_mod.undistort(st, table, pts, t_rel, pmask,
                          calib._replace(lid_rot=calib.lid_rot.double()))
    m = stage_map(cuda)
    p, v = frame_insert_batch(cuda, n=100)
    with pytest.raises(ValueError):
        tm.insert(m, p.cpu(), v)
    with pytest.raises(TypeError):
        tm.insert(m, p, v.to(torch.uint8))


def frame_kernel_write_only(dev, kernel):
    """test_kernels_write_only_their_outputs' insert and undistortion
    cases."""
    import ctypes

    from fastlivo_tpu_torch import imu as imu_mod

    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda *ts: [t.data_ptr() for t in ts]  # noqa: E731
    n = 16379
    if kernel.startswith("undistort"):
        d = frame_cases().undistort_case("table_1024" if kernel == "undistort_8200"
                                         else "table_512")
        d["pts"], d["t_rel"], d["pmask"] = (np.resize(d[k], (n,) + d[k].shape[1:])
                                            for k in ("pts", "t_rel", "pmask"))
        st, table, pts, t_rel, pmask, calib = undistort_args(dev, d)
        launch = imu_mod._undistort_launcher()
        M = table.offs.shape[0]

        def run(o, r, ps, v, a, g, sr, sp, lr, lo, x, tr, pm, out):
            fields = (ctypes.c_void_p * 6)(*ptr(o, r, ps, v, a, g))
            strides = (ctypes.c_longlong * 6)(1, 9, 3, 3, 3, 3)
            return launch(fields, strides, M, 0, *ptr(sr, sp, lr, lo, x, tr, pm, out), n, stream)

        got = launch_guarded(run, [*table, st.rot, st.pos, calib.lid_rot, calib.lid_off, pts,
                                   t_rel, pmask], [torch.empty_like(pts)])
        want = [imu_mod.undistort_plain(st, table, pts, t_rel, pmask, calib)]
    else:
        m = stage_map(dev, compacted=True, pool=4096 if kernel != "tiled_insert_cells" else 600)
        p, v = frame_insert_batch(dev, n=n)
        keys, tiles, size = tm._insert_launchers()
        B, T = n, m.slot_key.shape[0]
        mp = clone_map(m)
        gkey, rows = tm.insert_keys_plain(mp, p, v)
        sg, order = torch.sort(gkey, stable=True)
        if kernel == "tiled_insert_keys":
            got = launch_guarded(lambda *a: keys(*ptr(*a), B, stream),
                                 [p, v, m.voxel_size, m.log2_dims],
                                 [torch.empty_like(gkey), torch.empty_like(rows)])
            want = [gkey, rows]
        else:  # the second launch: the tiles pass, and the cells pass in it
            zero = torch.zeros((), dtype=torch.int32, device=dev)
            scratch = torch.zeros(size(B), dtype=torch.int32, device=dev)
            grid = ctypes.c_int(0)
            got = launch_guarded(
                lambda s, o, x, vs, na, nd, r, dc, ds, sk, cc, pool, nao, ndo, sc: tiles(
                    *ptr(s, o, r, x, vs, dc, ds, sk, cc, pool, na, nd, nao, ndo, sc), B, T,
                    tm.EMPTY_CHECK, ctypes.byref(grid), stream),
                [sg, order, p, m.voxel_size, m.n_alloc, m.n_dropped],
                [rows.clone(), m.dir_check, m.dir_slot, m.slot_key, m.cell_check, m.pts, zero,
                 zero.clone(), scratch])
            assert grid.value == 3 * 16 and not got.pop().any()  # the scratch back at 0
            flags = winner_flags(m, rows, sg, order)
            n_alloc, n_dropped = tm.insert_sorted_plain(mp, p, v, rows, sg, order)
            assert torch.equal(got[0][4], flags)
            got[0] = got[0][:4]
            want = [rows[:4], mp.dir_check, mp.dir_slot, mp.slot_key, mp.cell_check, mp.pts,
                    n_alloc, n_dropped]
            if kernel == "tiled_insert_cells":
                assert int(n_dropped) > int(m.n_dropped)  # the pool overflows
    for g, w in zip(got, want):
        assert bit_equal(g, w)



# --- the camera kernels past patch size 16

WIDE_P = [17, 24, 32, 48]  # the wide tree's 512, 1024, 1024 and 4096 values


@pytest.mark.parametrize("ncc", [False, True], ids=["ncc_off", "ncc_on"])
def test_vio_select_past_patch_16(cuda, ncc):
    """vio_select at patch sizes 17, 24, 32, 48 (the wide instance, its
    cells' patches in shared memory) and 64 (in the launch's device
    scratch) on one random map: one launch each, the plain version's code
    not reached, every output bit-equal to the plain version's; cells
    tracked at 17-24."""
    from fastlivo_tpu_torch.ops import vio_select as vs

    a = random_vio_frame(cuda, seed=43 + ncc, ncc=ncc)
    tracked = {}
    for P in WIDE_P + [64]:
        a["patch_size"] = P
        kw = {k: v for k, v in a.items() if k != "vm"}
        n0 = vs.vio_select.launches
        with select_refused():
            got = vs.vio_select(a["vm"], **kw)
        assert vs.vio_select.launches == n0 + 1
        want = vs.vio_select_plain(a["vm"], **kw)
        assert got[0].patch.shape == (192, 3, P, P)
        try:
            assert_select_equal(got, want)
        except AssertionError as e:
            raise AssertionError(f"patch_size {P}: {e}") from e
        tracked[P] = int(got[0].valid.sum())
    assert tracked[17] + tracked[24] > 0, tracked


@pytest.mark.parametrize("P", [4, 8] + WIDE_P + [96])
def test_photometric_err_H_is_bit_equal_to_plain(cuda, P):
    """photometric_err_H against its plain version, which writes the
    kernel's orders out (ops/photometric.point_sums, partials_sum): err,
    HᵀH, Hᵀz, perr and the mesh's partials bit-equal at levels 2 and 0
    with each robust weight, at P = 4 and 8, past 16, and at 96 (the taps
    read in place)."""
    x = photometric_inputs(cuda, P=P, G=64 if P == 96 else 192, seed=P)
    for level in (2, 0):
        for robust in ("none", "huber", "tukey"):
            before = photometric.photometric_err_H.launches
            got = photometric_call(photometric.photometric_err_H, x, level, P, robust)
            assert photometric.photometric_err_H.launches == before + 1
            want = photometric_call(photometric.photometric_err_H_plain, x, level, P, robust)
            for g, w, name in zip(got, want, ("err", "HTH6", "HTz", "perr")):
                assert bit_equal(g, w), (P, level, robust, name,
                                         float((g - w).abs().max()))
            assert float(want[1].abs().max()) > 0
            got = photometric_call(photometric.photometric_err_H, x, level, P, robust,
                                   partials=True)
            want = photometric_call(photometric.photometric_err_H_plain, x, level, P, robust,
                                    partials=True)
            assert bit_equal(got[0], want[0]) and bit_equal(got[1], want[1])


@pytest.mark.parametrize("P", WIDE_P + [96])
def test_photometric_cascade_past_patch_16(cuda, P):
    """The cascade at P past 16 (and at 96, the taps read in place) against
    the host loop vio.photometric_loop with the step kernel: every output
    bit-equal, iterations equal; one cascade launch."""
    from fastlivo_tpu_torch import vio

    args = cascade_args(photometric_inputs(cuda, P=P, G=64 if P == 96 else 192, seed=P),
                        "huber")
    assert args[16] == P
    n = photometric.photometric_cascade.launches
    got = photometric.photometric_cascade(*args)
    assert photometric.photometric_cascade.launches == n + 1
    loop = vio.photometric_loop(*args)
    assert int(got[5]) == loop[5] >= 3
    for g, w, name in zip(got, loop, ("rot", "x", "G", "perr", "err")):
        assert torch.equal(g, w), (P, name)


@pytest.mark.parametrize("P", WIDE_P + [96])
def test_patches_and_grads_past_patch_16(cuda, P):
    img, pc, scale = (t.to(cuda) for t in patch_inputs(seed=P))
    before = patches_grads.patches_and_grads.launches
    got = patches_grads.patches_and_grads(img, pc, P, scale)
    assert patches_grads.patches_and_grads.launches == before + 1
    want = image.patches_and_grads(img, pc, P, scale)
    for g, w in zip(got, want):
        assert g.shape == (192, P, P) and bit_equal(g, w)


def camera_write_only(dev, kernel):
    """test_kernels_write_only_their_outputs' photometric_err_H (its
    partials, ticket, out and perr the outputs; the ticket back at 0) and
    patches_and_grads, at the kernel name's patch size."""
    import ctypes

    P = int(kernel.split("_p")[-1])
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda *ts: [t.data_ptr() for t in ts]  # noqa: E731
    if kernel.startswith("patches"):
        img, pc, scale = (t.to(dev) for t in patch_inputs(seed=P))
        K, (H, W) = pc.shape[0], img.shape
        outs = [torch.empty((K, P, P), device=dev) for _ in range(3)]
        got = launch_guarded(lambda *v: patches_grads._launcher()(*ptr(*v), K, H, W, P, stream),
                             [img, pc, scale], outs)
        want = image.patches_and_grads(img, pc, P, scale)
    else:
        x = photometric_inputs(dev, P=P, G=64, seed=P)
        level, robust = 1, "huber"
        G, (H, W) = x["tr_pos"].shape[0], x["img"].shape
        ins = [x["img"], x["tr_pos"], x["tr_patch"][:, level].contiguous(), x["tr_slevel"],
               x["tr_valid"], x["rot"], x["pos"], x["Rci"], x["Pci"], x["Jdphi_dR"],
               x["Jdp_dR"], x["cam"].fx, x["cam"].fy, x["cam"].cx, x["cam"].cy, x["cam"].d]
        outs = [torch.empty((G, 44), device=dev), torch.zeros(1, dtype=torch.int32, device=dev),
                torch.empty(45, device=dev), torch.empty(G, device=dev)]
        got = launch_guarded(lambda *v: photometric._launcher()(
            *ptr(*v), G, H, W, P, level, P * P, photometric.ROBUST[robust],
            photometric.HUBER_K, photometric._recip32(photometric.TUKEY_B),
            photometric._recip32(10.0), stream), ins, outs)
        assert not got[1].any()  # the ticket back at 0
        out, perr = got[2], got[3]
        part, _ = photometric_call(photometric.photometric_err_H_plain, x, level, P, robust,
                                   partials=True)
        err = photometric_call(photometric.photometric_err_H_plain, x, level, P, robust)[0]
        got = [out[:42], out[42], out[43], out[44], perr]
        want = [part[:42], err, part[43], part[42],
                photometric_call(photometric.photometric_err_H_plain, x, level, P, robust)[3]]
    for g, w in zip(got, want):
        assert bit_equal(g, w)
