"""Port parity end to end: one synthetic LIO run through both Pipelines,
the CLI, and the port's import hygiene.

Tolerances: the same frames, every pose within 1 mm of the JAX
package's, ATE no worse than JAX's plus 0.5 mm. (On the bootstrap frame
the JAX package may take its native C++ voxel filter where the port
uses numpy; the two first maps differ at float32 rounding.)
"""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fastlivo_tpu.config import CapacityConfig as JCapacity
from fastlivo_tpu.config import Config as JConfig
from fastlivo_tpu.io.synthetic import SyntheticDataset as JDataset
from fastlivo_tpu.pipeline import Pipeline as JPipeline

from fastlivo_tpu_torch import run as trun
from fastlivo_tpu_torch.config import CapacityConfig, Config
from fastlivo_tpu_torch.io.synthetic import SyntheticDataset
from fastlivo_tpu_torch.pipeline import Pipeline

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "fastlivo_tpu_torch"


def small_config(cls_cfg, cls_cap):
    cfg = cls_cfg()
    cfg.img_enable = False
    cfg.capacity = cls_cap(max_points=4096, max_raw_points=8192,
                           tiled_dir_dims=(32, 32, 16), tiled_pool=1024)
    return cfg


def _drive(pipe, ds):
    for beg, pts, t_rel in ds.lidar_scans_fast():
        pipe.push_lidar(beg, pts, t_rel)
    for t, acc, gyr in ds.imu_stream():
        pipe.push_imu(t, acc, gyr)
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
        trun.main(["--synthetic"])  # the default config enables the camera


def test_constructor_refuses_what_it_cannot_do():
    cfg = small_config(Config, CapacityConfig)
    cfg.img_enable = True
    with pytest.raises(NotImplementedError, match="camera"):
        Pipeline(cfg, device="cpu")
    for field, value in (("map_backend", "dense"), ("plane_fit", "ref"),
                         ("cache_knn", True)):
        cfg = small_config(Config, CapacityConfig)
        setattr(cfg.capacity, field, value)
        with pytest.raises(NotImplementedError):
            Pipeline(cfg, device="cpu")


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
            "fastlivo_tpu_torch.convert; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'fastlivo_tpu' or m.startswith('fastlivo_tpu.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_sources_name_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+jax\b|fastlivo_tpu\.", re.M)
    files = sorted(PKG.rglob("*.py")) + sorted(PKG.rglob("*.cu"))
    assert len(files) > 15
    for f in files:
        assert not pat.search(f.read_text()), f


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
