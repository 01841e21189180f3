"""The port's CUDA kernels on the card (marker `cuda`; skipped without one).

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py

Also: the device voxel filter is deterministic on the card. Contract of
the fused 5-NN + plane-fit kernel against its plain version
(tests/test_torch_knn_plane.py): nd2 at rtol 1e-5; planes at rtol 5e-3 /
atol 5e-4 up to sign where both gates pass; gate mismatches under 1%.
The patch + gradient kernel is bit-exact against its plain version (both
round every product; the kernel is built with -fmad=false).
"""
import numpy as np
import pytest
import torch

from fastlivo_tpu_torch.config import CameraConfig, CapacityConfig, Config
from fastlivo_tpu_torch.io.synthetic import SyntheticDataset
from fastlivo_tpu_torch.ops import image, knn_plane, patches_grads
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
    before = knn_plane.knn5_plane.launches
    outs = pipe.spin()
    launches = knn_plane.knn5_plane.launches - before
    steady = [o for o in outs if o.iters > 0]
    assert len(steady) > 5 and launches >= len(steady)
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


def test_livo_pipeline_runs_through_the_kernel(cuda):
    W, H, F = 320, 256, 200.0
    rcl = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    cfg = Config()
    cfg.grid_size = 32
    cfg.outlier_threshold = 300.0
    cfg.img_point_cov = 100.0
    cfg.camera = CameraConfig(width=W, height=H, fx=F, fy=F, cx=(W - 1) / 2.0,
                              cy=(H - 1) / 2.0, d=[0.0, 0.0, 0.0, 0.0])
    cfg.Rcl = rcl.ravel().tolist()
    cfg.capacity = CapacityConfig(max_points=4096, max_raw_points=8192,
                                  tiled_dir_dims=(32, 32, 16), tiled_pool=1024,
                                  vmap_points=8192, vmap_table_size=1 << 15,
                                  frame_ring=16, max_cands=4096)
    ds = SyntheticDataset(duration=4.0, points_per_scan=4096, lidar_noise=0.004,
                          seed=5, cam_hz=10.0, cam_size=(W, H), cam_f=F, Rcl=rcl)
    pipe = Pipeline(cfg)
    assert pipe.vio.device.type == "cuda"
    for beg, pts, t_rel in ds.lidar_scans_fast():
        pipe.push_lidar(beg, pts, t_rel)
    for t, acc, gyr in ds.imu_stream():
        pipe.push_imu(t, acc, gyr)
    for t, img in ds.images():
        pipe.push_img(t, img)
    before = patches_grads.patches_and_grads.launches
    outs = pipe.spin()
    launches = patches_grads.patches_and_grads.launches - before
    assert pipe.vio.steps > 10 and launches >= 3 * pipe.vio.steps
    assert int(pipe.vio.vmap.n_pts) > 50 and pipe.vio.last_stats["tracked"] > 5
    base = ds.traj.base_pos
    e = [np.linalg.norm(o.pos - (ds.traj.pose(o.t)[1] - base))
         for o in outs if o.t >= ds.traj.t_static + 0.5]
    assert np.sqrt(np.mean(np.square(e))) < 0.06
