"""Port parity end to end: one synthetic LIO run and one LIVO run through
both Pipelines, the CLI, and the port's import hygiene.

Tolerances: LIO, the same frames, every pose within 1 mm of the JAX
package's, ATE no worse than JAX's plus 0.5 mm, on the tiled map and on
the hash and dense maps. (Both bootstrap frames go through the same
native C++ voxel filter; the first maps differ only where the
undistortion rounds differently, tests/test_torch_native.py.) LIVO, the
same frames, every lidar frame within 2 mm, visual-map points within 2%,
ATE no worse than JAX's plus 1 mm; with `pcd_save_en` and `debug`, the
RGB cloud's chunks row for row (positions 1e-4 m, colours 0.01) and the
overlay within 0.5% of its pixels.
"""
import contextlib
import io
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fastlivo_tpu.config import CameraConfig as JCamera
from fastlivo_tpu.config import CapacityConfig as JCapacity
from fastlivo_tpu.config import Config as JConfig
from fastlivo_tpu.io.synthetic import SyntheticDataset as JDataset
from fastlivo_tpu.pipeline import Pipeline as JPipeline

from fastlivo_tpu_torch import run as trun
from fastlivo_tpu_torch.config import CameraConfig, CapacityConfig, Config
from fastlivo_tpu_torch.io.synthetic import SyntheticDataset
from fastlivo_tpu_torch.pipeline import Pipeline

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "fastlivo_tpu_torch"

# The suite runs in parallel worker processes, each of which collects
# this module. With torch's default of one OpenMP thread per core in
# every worker, the spinning pools oversubscribe the cores and a port
# test ran 12x slower beside three others (27 s alone, 319 s at -n 4);
# one intra-op thread per worker keeps each near its solo time.
torch.set_num_threads(1)


def small_config(cls_cfg, cls_cap):
    cfg = cls_cfg()
    cfg.img_enable = False
    cfg.capacity = cls_cap(max_points=4096, max_raw_points=8192,
                           tiled_dir_dims=(32, 32, 16), tiled_pool=1024)
    return cfg


# camera: z forward = body +x, x right = body -y, y down = body -z
RCL = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
CW, CH, CF = 320, 256, 200.0


def livo_config(cls_cfg, cls_cap, cls_cam):
    """tests/test_pipeline_livo.py's configuration on the tiled map."""
    cfg = cls_cfg()
    cfg.img_enable = True
    cfg.max_iteration = 6
    cfg.filter_size_surf = 0.3
    cfg.filter_size_map = 0.3
    cfg.grid_size = 32
    cfg.patch_size = 8
    cfg.outlier_threshold = 300.0
    cfg.img_point_cov = 100.0
    cfg.camera = cls_cam(width=CW, height=CH, fx=CF, fy=CF, cx=(CW - 1) / 2.0,
                         cy=(CH - 1) / 2.0, d=[0.0, 0.0, 0.0, 0.0])
    cfg.Rcl = RCL.ravel().tolist()
    cfg.Pcl = [0.0, 0.0, 0.0]
    cfg.capacity = cls_cap(max_points=4096, max_raw_points=8192,
                           max_imu_per_group=64, vmap_points=8192,
                           vmap_table_size=1 << 15, vmap_voxel_cap=8,
                           frame_ring=16, max_cands=4096,
                           tiled_dir_dims=(32, 32, 16), tiled_pool=1024)
    return cfg


def _drive(pipe, ds):
    for beg, pts, t_rel in ds.lidar_scans_fast():
        pipe.push_lidar(beg, pts, t_rel)
    for t, acc, gyr in ds.imu_stream():
        pipe.push_imu(t, acc, gyr)
    for t, img in ds.images():
        pipe.push_img(t, img)
    return pipe.spin()


def _ate(outs, ds):
    base = ds.traj.base_pos
    e = [np.linalg.norm(o.pos - (ds.traj.pose(o.t)[1] - base))
         for o in outs if o.t >= ds.traj.t_static + 0.5]
    return float(np.sqrt(np.mean(np.square(e))))


def test_synthetic_run_matches_jax():
    kw = dict(duration=4.0, points_per_scan=4096, lidar_noise=0.004, seed=3)
    ds_j, ds_t = JDataset(**kw), SyntheticDataset(**kw)
    pipe_j = JPipeline(small_config(JConfig, JCapacity))
    pipe_j.materialize_dense = True
    outs_j = _drive(pipe_j, ds_j)
    pipe = Pipeline(small_config(Config, CapacityConfig), device="cpu")
    pipe.materialize_dense = True
    seen = []
    pipe.on_frame = seen.append
    outs_t = _drive(pipe, ds_t)
    assert seen == outs_t
    assert len(outs_t) == len(outs_j) >= 25
    for a, b in zip(outs_t, outs_j):
        assert a.t == b.t
        assert np.linalg.norm(a.pos - b.pos) < 1e-3, (a.t, a.pos, b.pos)
        assert abs(a.n_points - b.n_points) <= 0.01 * max(b.n_points, 1)
        # the dense world cloud (and its intensity) at the posterior
        assert a.pts_world.shape == b.pts_world.shape
        np.testing.assert_allclose(a.pts_world, b.pts_world, atol=2e-3)
        np.testing.assert_array_equal(a.intensity, b.intensity)
    steady = [o for o in outs_t if o.iters > 0]
    assert len(steady) >= 20
    assert all(np.isfinite(o.pos).all() and o.n_active > 0.5 * o.n_points
               for o in steady)
    ate_t, ate_j = _ate(outs_t, ds_t), _ate(outs_j, ds_j)
    assert ate_t <= ate_j + 5e-4, (ate_t, ate_j)
    assert ate_t < 0.02
    traj = pipe.tum_trajectory()
    assert traj.shape == (len(outs_t), 8)


def other_backend(cls_cfg, cls_cap, backend):
    """small_config on the hash map (2^16 slots) or the dense grid
    (64 x 64 x 16 cells: 32 x 32 x 8 m at 0.5 m)."""
    cfg = small_config(cls_cfg, cls_cap)
    cfg.capacity.map_backend = backend
    cfg.capacity.map_table_size = 1 << 16
    cfg.capacity.dense_dims = (64, 64, 16)
    return cfg


@pytest.mark.parametrize("backend", ["hash", "dense"])
def test_other_backends_match_jax(backend):
    kw = dict(duration=3.0, points_per_scan=4096, lidar_noise=0.004, seed=3)
    ds_j, ds_t = JDataset(**kw), SyntheticDataset(**kw)
    outs_j = _drive(JPipeline(other_backend(JConfig, JCapacity, backend)), ds_j)
    pipe = Pipeline(other_backend(Config, CapacityConfig, backend), device="cpu")
    outs_t = _drive(pipe, ds_t)
    assert type(pipe.map).__name__ == {"hash": "VoxelMap", "dense": "DenseMap"}[backend]
    assert len(outs_t) == len(outs_j) >= 15
    for a, b in zip(outs_t, outs_j):
        assert a.t == b.t
        assert np.linalg.norm(a.pos - b.pos) < 1e-3, (a.t, a.pos, b.pos)
    assert sum(o.iters > 0 for o in outs_t) >= 12
    ate_t, ate_j = _ate(outs_t, ds_t), _ate(outs_j, ds_j)
    assert ate_t <= ate_j + 5e-4 and ate_t < 0.02, (ate_t, ate_j)


@pytest.mark.parametrize("backend", ["hash", "dense"])
def test_livo_other_backends_match_jax(backend):
    """LIVO (the camera on) on the hash map (2^16 slots) and the dense grid
    (64 x 64 x 16 cells), with test_livo_run_matches_jax's data and
    bounds: the same frames, every lidar frame within 2 mm of the JAX
    package's, the same camera frames, visual-map points within 2%."""
    kw = dict(duration=4.0, points_per_scan=4096, lidar_noise=0.004, seed=5,
              cam_hz=10.0, cam_size=(CW, CH), cam_f=CF, Rcl=RCL)
    ds_j, ds_t = JDataset(**kw), SyntheticDataset(**kw)
    cfgs = []
    for cls in ((JConfig, JCapacity, JCamera), (Config, CapacityConfig, CameraConfig)):
        cfg = livo_config(*cls)
        cfg.capacity.map_backend = backend
        cfg.capacity.map_table_size = 1 << 16
        cfg.capacity.dense_dims = (64, 64, 16)
        cfgs.append(cfg)
    pipe_j = JPipeline(cfgs[0])
    outs_j = _drive(pipe_j, ds_j)
    pipe = Pipeline(cfgs[1], device="cpu")
    outs_t = _drive(pipe, ds_t)
    assert type(pipe.map).__name__ == {"hash": "VoxelMap", "dense": "DenseMap"}[backend]
    assert len(outs_t) == len(outs_j) >= 25
    for a, b in zip(outs_t, outs_j):
        assert a.t == b.t
        assert np.linalg.norm(a.pos - b.pos) < 2e-3, (a.t, a.pos, b.pos)
    assert pipe.vio.fid == pipe_j.vio.fid >= 25
    n_t, n_j = int(pipe.vio.vmap.n_pts), int(pipe_j.vio.vmap.n_pts)
    assert n_j > 50 and abs(n_t - n_j) <= 0.02 * n_j, (n_t, n_j)
    assert pipe.vio.last_stats["tracked"] > 5
    ate_t, ate_j = _ate(outs_t, ds_t), _ate(outs_j, ds_j)
    assert ate_t <= ate_j + 1e-3 and ate_t < 0.06, (ate_t, ate_j)


def test_profile_every_leaves_the_outputs_bit_identical():
    """Staged profiling on the hash map: every 4th steady frame's stages
    run once more, each on its own; outputs and the final map are those
    of a run without it, bit for bit."""
    kw = dict(duration=3.0, points_per_scan=2048, lidar_noise=0.004, seed=3)
    runs = []
    for every in (0, 4):
        pipe = Pipeline(other_backend(Config, CapacityConfig, "hash"), device="cpu")
        pipe.profile_every = every
        pipe.async_read = True  # the profile cadence holds on the deferred path
        runs.append((pipe, _drive(pipe, SyntheticDataset(**kw)) + pipe.finish()))
    (ref, outs_ref), (pipe, outs) = runs
    assert ref.last_stage_profile is None
    prof = pipe.last_stage_profile
    assert set(prof) == {"undistort", "downsample", "ekf", "map"}
    assert all(v > 0.0 for v in prof.values())
    assert pipe._n_steady >= 8
    assert len(outs) == len(outs_ref) >= 15
    for a, b in zip(outs, outs_ref):
        assert a.t == b.t and a.iters == b.iters and a.n_active == b.n_active
        assert a.res_rms == b.res_rms
        np.testing.assert_array_equal(a.pos, b.pos)
        np.testing.assert_array_equal(a.quat, b.quat)
    for x, y in zip(pipe.map, ref.map):
        assert torch.equal(x, y)


def test_livo_run_matches_jax():
    kw = dict(duration=4.0, points_per_scan=4096, lidar_noise=0.004, seed=5,
              cam_hz=10.0, cam_size=(CW, CH), cam_f=CF, Rcl=RCL)
    ds_j, ds_t = JDataset(**kw), SyntheticDataset(**kw)
    pipe_j = JPipeline(livo_config(JConfig, JCapacity, JCamera))
    outs_j = _drive(pipe_j, ds_j)
    pipe = Pipeline(livo_config(Config, CapacityConfig, CameraConfig), device="cpu")
    outs_t = _drive(pipe, ds_t)
    assert len(outs_t) == len(outs_j) >= 25
    for a, b in zip(outs_t, outs_j):
        assert a.t == b.t
        assert np.linalg.norm(a.pos - b.pos) < 2e-3, (a.t, a.pos, b.pos)
    assert pipe.vio.fid == pipe_j.vio.fid >= 25  # image groups interleaved
    n_t, n_j = int(pipe.vio.vmap.n_pts), int(pipe_j.vio.vmap.n_pts)
    assert n_j > 50 and abs(n_t - n_j) <= 0.02 * n_j, (n_t, n_j)
    assert pipe.vio.last_stats["tracked"] > 5
    ate_t, ate_j = _ate(outs_t, ds_t), _ate(outs_j, ds_j)
    assert ate_t <= ate_j + 1e-3, (ate_t, ate_j)
    assert ate_t < 0.06


def test_livo_mapping_restart_wipes_the_visual_map():
    ds = SyntheticDataset(duration=3.0, points_per_scan=2048, lidar_noise=0.004,
                          seed=5, cam_hz=10.0, cam_size=(CW, CH), cam_f=CF, Rcl=RCL)
    pipe = Pipeline(livo_config(Config, CapacityConfig, CameraConfig), device="cpu")
    _drive(pipe, ds)
    fid = pipe.vio.fid
    assert int(pipe.vio.vmap.n_pts) > 20
    pipe._mapping_restart(1.0)
    assert int(pipe.vio.vmap.n_pts) == 0 and pipe.vio.fid == fid
    assert not pipe.map_built and pipe.auto_resets == 1


def test_cli_livo_on_cpu(tmp_path, capsys):
    out = tmp_path / "traj.txt"
    cfg_yaml = tmp_path / "cfg.yaml"
    cfg_yaml.write_text(
        "img_enable: 1\ngrid_size: 32\npatch_size: 8\noutlier_threshold: 300\n"
        "img_point_cov: 100\ncamera:\n  Rcl: [0, -1, 0, 0, 0, -1, 1, 0, 0]\n"
        "  Pcl: [0, 0, 0]\ncapacity:\n  max_points: 4096\n  max_raw_points: 8192\n"
        "  tiled_dir_dims: [32, 32, 16]\n  tiled_pool: 1024\n  vmap_points: 8192\n"
        "  vmap_table_size: 32768\n  frame_ring: 16\n  max_cands: 4096\n")
    cam_yaml = tmp_path / "cam.yaml"
    cam_yaml.write_text("cam_width: 320\ncam_height: 256\ncam_fx: 200\ncam_fy: 200\n"
                        "cam_cx: 159.5\ncam_cy: 127.5\n")
    assert trun.main(["--config", str(cfg_yaml), "--camera", str(cam_yaml),
                      "--synthetic", "--duration", "3", "--out", str(out),
                      "--eval", "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "eval: ate_rmse_m=" in printed
    m = re.search(r"vio: frames=(\d+) map_points=(\d+)", printed)
    assert m and int(m.group(1)) >= 15 and int(m.group(2)) > 0, printed
    assert len(np.loadtxt(out, ndmin=2)) >= 15


def test_cli_synthetic_on_cpu(tmp_path, capsys):
    out = tmp_path / "traj.txt"
    cfg_yaml = tmp_path / "cfg.yaml"
    cfg_yaml.write_text(
        "img_enable: 0\nfilter_size_surf: 0.5\ncapacity:\n"
        "  max_points: 4096\n  max_raw_points: 8192\n"
        "  tiled_dir_dims: [32, 32, 16]\n  tiled_pool: 1024\n")
    assert trun.main(["--config", str(cfg_yaml), "--synthetic", "--no-img",
                      "--duration", "3", "--out", str(out), "--eval",
                      "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "frames=" in printed and "eval: ate_rmse_m=" in printed
    rows = np.loadtxt(out, ndmin=2)
    assert rows.shape[1] == 8 and len(rows) >= 15
    with pytest.raises(SystemExit):
        trun.main(["--device", "cpu"])  # neither --bag nor --synthetic
    # the dense rolling grid through the CLI, with staged profiling and
    # the map's points exported through its backend
    cfg_yaml.write_text(
        "img_enable: 0\nfilter_size_surf: 0.5\ncapacity:\n  map_backend: dense\n"
        "  dense_dims: [64, 64, 16]\n  max_points: 4096\n  max_raw_points: 8192\n")
    pcd = tmp_path / "map.pcd"
    assert trun.main(["--config", str(cfg_yaml), "--synthetic", "--duration", "3",
                      "--out", str(out), "--eval", "--device", "cpu",
                      "--profile-every", "5", "--map-pcd", str(pcd)]) == 0
    printed = capsys.readouterr().out
    assert "frames=" in printed and "eval: ate_rmse_m=" in printed
    assert "stage profile (ms): undistort=" in printed
    m = re.search(r"map pcd: .* \((\d+) points\)", printed)
    assert m and int(m.group(1)) > 1000, printed


def test_constructor_refuses_what_it_cannot_do():
    """The constructor refuses what the JAX package refuses (an unknown
    map backend or plane fit) and nothing that the single-device JAX
    package does: with images, `debug` and `pcd_save_en` construct, and no
    module of the port raises NotImplementedError."""
    for field, bad in (("map_backend", "octree"), ("plane_fit", "svd")):
        cfg = small_config(Config, CapacityConfig)
        setattr(cfg.capacity, field, bad)
        with pytest.raises(ValueError, match=field):
            Pipeline(cfg, device="cpu")
    cfg = livo_config(Config, CapacityConfig, CameraConfig)
    cfg.debug = cfg.pcd_save_en = True
    pipe = Pipeline(cfg, device="cpu")
    assert pipe.vio is not None and pipe.rgb_cloud == [] and pipe.vio.last_overlay is None
    for f in ("pipeline.py", "run.py", "vio.py", "replay.py", "serve.py"):
        assert "NotImplementedError" not in (PKG / f).read_text(), f


@pytest.mark.parametrize("mode", ["sync", "async", "async_nodebug"])
def test_livo_debug_and_rgb_cloud_match_jax(mode):
    """A LIVO run with `pcd_save_en` (and `debug`, but in async_nodebug)
    through both packages: the same painted chunks, each with the same
    rows, positions within 1e-4 m and colours within 0.01 (of 255); the
    last overlay within 0.5% of its pixels. Under debug the camera frame's
    reads stay synchronous, also with `async_read`. Colorize pairs the
    newest image with the newest applied camera pose: without debug under
    `async_read` that pose is one camera frame older than the image, as
    in the JAX package (reproduced for parity)."""
    kw = dict(duration=3.0, points_per_scan=4096, lidar_noise=0.004, seed=5,
              cam_hz=10.0, cam_size=(CW, CH), cam_f=CF, Rcl=RCL)
    debug = mode != "async_nodebug"
    runs = []
    for P, make, D, dev in (
            (JPipeline, lambda: livo_config(JConfig, JCapacity, JCamera), JDataset, None),
            (Pipeline, lambda: livo_config(Config, CapacityConfig, CameraConfig),
             SyntheticDataset, "cpu")):
        cfg = make()
        cfg.pcd_save_en, cfg.debug = True, debug
        pipe = P(cfg) if dev is None else P(cfg, device=dev)
        pipe.async_read = mode != "sync"
        lags = []
        if dev is not None:  # camera frames run but not yet applied, at each paint
            real = pipe.vio.colorize
            pipe.vio.colorize = lambda pts, v=pipe.vio: (lags.append(len(v._pending)),
                                                          real(pts))[1]
        with contextlib.redirect_stdout(io.StringIO()):  # debug_show's dump
            outs = _drive(pipe, D(**kw)) + pipe.finish()
        runs.append((pipe, outs, lags))
    (pj, oj, _), (pt, ot, lags) = runs
    assert len(ot) == len(oj) >= 15
    for a, b in zip(ot, oj):
        assert a.t == b.t and np.linalg.norm(a.pos - b.pos) < 2e-3
    assert len(pt.rgb_cloud) == len(pj.rgb_cloud) >= 10
    for ct, cj in zip(pt.rgb_cloud, pj.rgb_cloud):
        assert ct.shape == cj.shape and ct.shape[1] == 6
        np.testing.assert_allclose(ct[:, :3], cj[:, :3], atol=1e-4)
        np.testing.assert_allclose(ct[:, 3:], cj[:, 3:], atol=1e-2)
    rgb = np.concatenate(pt.rgb_cloud)[:, 3:]
    assert len(rgb) > 5000 and rgb.min() >= 0 and rgb.max() <= 255 and rgb.std() > 5
    # (before the first camera step nothing is pending)
    assert set(lags[1:]) == ({1} if mode == "async_nodebug" else {0}), lags
    if debug:
        ov_t, ov_j = pt.vio.last_overlay, pj.vio.last_overlay
        assert ov_t.shape == ov_j.shape == (CH, CW, 3) and ov_t.dtype == np.uint8
        assert np.any(ov_t != ov_j, axis=-1).mean() <= 5e-3
        assert (ov_t[..., 1] == 255).sum() > 100  # tracked points drawn
    else:
        assert pt.vio.last_overlay is None and pj.vio.last_overlay is None


def test_cli_livo_pcd_out_and_viz_dir(tmp_path, capsys):
    """`run --pcd-out` in LIVO mode writes the RGB cloud (pcl::PointXYZRGB
    fields) and `--viz-dir` writes a PNG every `--viz-every` frames."""
    pytest.importorskip("matplotlib")
    from fastlivo_tpu_torch import viz

    cfg_yaml, cam_yaml = tmp_path / "cfg.yaml", tmp_path / "cam.yaml"
    cfg_yaml.write_text(
        "img_enable: 1\ngrid_size: 32\npatch_size: 8\noutlier_threshold: 300\n"
        "img_point_cov: 100\ncamera:\n  Rcl: [0, -1, 0, 0, 0, -1, 1, 0, 0]\n"
        "  Pcl: [0, 0, 0]\ncapacity:\n  max_points: 4096\n  max_raw_points: 8192\n"
        "  tiled_dir_dims: [32, 32, 16]\n  tiled_pool: 1024\n  vmap_points: 8192\n"
        "  vmap_table_size: 32768\n  frame_ring: 16\n  max_cands: 4096\n")
    cam_yaml.write_text("cam_width: 320\ncam_height: 256\ncam_fx: 200\ncam_fy: 200\n"
                        "cam_cx: 159.5\ncam_cy: 127.5\n")
    pcd, vdir = tmp_path / "rgb.pcd", tmp_path / "viz"
    assert trun.main(["--config", str(cfg_yaml), "--camera", str(cam_yaml), "--synthetic",
                      "--duration", "2.5", "--out", str(tmp_path / "t.txt"), "--device", "cpu",
                      "--pcd-out", str(pcd), "--viz-dir", str(vdir), "--viz-every", "5"]) == 0
    n = len(np.loadtxt(tmp_path / "t.txt", ndmin=2))
    assert "FIELDS x y z rgb" in pcd.read_text()[:200]
    pts, rgb = viz._load_pcd(pcd)
    assert len(pts) > 1000 and np.isfinite(pts).all()
    assert rgb.shape == pts.shape and rgb.max() <= 255 and rgb.std() > 5
    assert len(list(vdir.glob("frame_*.png"))) == -(-n // 5)
    assert (vdir / "latest.png").exists()


def test_default_device_is_cuda():
    cfg = small_config(Config, CapacityConfig)
    if torch.cuda.is_available():
        assert Pipeline(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Pipeline(cfg)
    assert Pipeline(cfg, device="cpu").device.type == "cpu"


def test_import_pulls_in_no_jax():
    code = ("import sys, fastlivo_tpu_torch.pipeline, fastlivo_tpu_torch.run, "
            "fastlivo_tpu_torch.convert, fastlivo_tpu_torch.replay, "
            "fastlivo_tpu_torch.serve, fastlivo_tpu_torch.readback, "
            "fastlivo_tpu_torch.preprocess, fastlivo_tpu_torch.features, "
            "fastlivo_tpu_torch.io.checkpoint, fastlivo_tpu_torch.io.rosbag, "
            "fastlivo_tpu_torch.io.lz4, fastlivo_tpu_torch.ops.dense_map, "
            "fastlivo_tpu_torch.ops.vio_dedup, fastlivo_tpu_torch.ops.vio_push, "
            "fastlivo_tpu_torch.viz, fastlivo_tpu_torch.native, "
            "fastlivo_tpu_torch.io.golden, fastlivo_tpu_torch.parallel.sharded, "
            "fastlivo_tpu_torch.parallel.launch, fastlivo_tpu_torch.parallel.sharded_map, "
            "fastlivo_tpu_torch.parallel.sharded_backend, "
            "fastlivo_tpu_torch.parallel.product; "
            # the mesh tests' rank programs, which spawned ranks import
            "sys.path.insert(0, 'tests'); import torch_mesh_ranks; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'fastlivo_tpu' or m.startswith('fastlivo_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_name_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+jax\b|fastlivo_tpu\.", re.M)
    files = sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu")) + sorted(PKG.rglob("*.cuh"))
    names = {str(f.relative_to(PKG)) for f in files}
    assert {"replay.py", "serve.py", "readback.py", "preprocess.py", "features.py",
            "io/checkpoint.py", "io/rosbag.py", "io/lz4.py", "ops/dense_map.py",
            "viz.py", "native.py", "io/golden.py",
            "ops/voxel_map.py", "parallel/sharded.py", "parallel/launch.py",
            "parallel/sharded_map.py", "parallel/sharded_backend.py",
            "parallel/product.py", "csrc/photometric_cascade.cu",
            "ops/vio_dedup.py", "ops/vio_push.py", "csrc/voxel_keys.cu",
            "csrc/vio_dedup.cu", "csrc/vio_push.cu",
            "csrc/photometric_measure.cuh", "csrc/so3.cuh"} <= names
    files += [ROOT / "chip_smoke.py", ROOT / "tests" / "torch_mesh_ranks.py",
              ROOT / "tests" / "torch_imu_cases.py", ROOT / "tests" / "torch_frame_cases.py",
              ROOT / "tests" / "torch_hash_cases.py",
              ROOT / "tests" / "torch_camera_stage_cases.py"]
    for f in files:
        assert not pat.search(f.read_text()), f


def test_every_kernel_source_is_built_and_smoked():
    """Each csrc/*.cu is in the builder's list and in chip_smoke.py's: the
    fused searches (tiled; hash and dense), the fused photometric
    measurement, the photometric cascade and step, the two standalone
    kernels, the IMU propagation, the LIO cascade (its three libraries:
    radius 1, radius 2, any other radius), the camera frame's selection
    and map upkeep, the tiled map's box delete and insert, the voxel
    filter's segmented centroid, the scan's undistortion, the hash map's
    insert, the dense grid's and the box delete of both, the voxel
    filter's keys and their sort, the camera frame's voxel dedup and
    image-pool push."""
    import importlib.util

    from fastlivo_tpu_torch.ops import _build

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cu = sorted(p.stem for p in (PKG / "csrc").glob("*.cu"))
    assert cu == sorted(_build.SOURCES) == sorted(smoke.CUDA_SOURCES)
    assert cu == ["dense_insert", "flat_delete_boxes", "hash_insert", "imu_propagate",
                  "knn5_plane", "knn5_plane_hashed", "knn5_plane_tiled",
                  "lio_cascade", "lio_cascade_125", "lio_cascade_any",
                  "patches_and_grads", "photometric_cascade",
                  "photometric_err_H", "tiled_delete_boxes", "tiled_insert", "undistort",
                  "vio_dedup", "vio_observations", "vio_push", "vio_select",
                  "voxel_centroids", "voxel_keys"]


def test_kernel_launches_are_profiler_ops():
    """A wrapped launch returns the launch function's value and stands in
    a trace as an op of its kernel's name, inside the range it ran under:
    the op a device kernel is linked to."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from fastlivo_tpu_torch.ops import _build

    calls = []
    launch = _build.profiled("knn5_plane_tiled", lambda *a: calls.append(a) or 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("lio.search"):
            assert launch(1, 2.0) == 0
    assert calls == [(1, 2.0)]
    (search,) = [e for e in prof.events() if e.name == "lio.search"]
    assert [c.name for c in search.cpu_children] == ["knn5_plane_tiled"]


def test_divergence_watchdog_restarts_mapping():
    """capacity.auto_reset_rms: an IMU gap in motion poisons the map; the
    watchdog restarts mapping and the run stays finite and bounded."""
    import warnings

    ds = SyntheticDataset(duration=5.0, points_per_scan=2048, lidar_noise=0.004, seed=9)
    cfg = small_config(Config, CapacityConfig)
    cfg.capacity.auto_reset_rms = 0.08
    cfg.capacity.auto_reset_frames = 3
    pipe = Pipeline(cfg, device="cpu")
    for beg, pts, t_rel in ds.lidar_scans_fast():
        pipe.push_lidar(beg, pts, t_rel)
    for t, acc, gyr in ds.imu_stream():
        if not 2.5 <= t < 2.9:
            pipe.push_imu(t, acc, gyr)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        outs = pipe.spin()
    assert pipe.auto_resets >= 1
    assert any("divergence watchdog" in str(x.message) for x in w)
    pos = np.asarray([o.pos for o in outs])
    assert np.all(np.isfinite(pos)) and np.all(np.abs(pos) < 50.0)
