"""Port parity: the native host library (native/ingest.cpp through
fastlivo_tpu_torch/native.py) against the JAX package's build of the same
source and against the numpy / pure-Python twins.

Tolerances:
  - port library against the JAX package's library: bit-equal (the same
    source built with the same flags), on every entry point;
  - port library against the numpy twins, as tests/test_native.py holds
    the JAX package's: decode_avia rtol 1e-6 (times atol 1e-12), the
    voxel filter's centroids rtol 1e-5 / atol 1e-4 (it sums in f64 in
    another order);
  - give_feature's ring pass and the lz4 block decoder and xxh32: exact;
  - the port's bootstrap frame, now filtered by the same library as the
    JAX package's: the same first map, every point bit-equal but where
    the undistorted scan already differs (at seed 3, one coordinate of
    12288 by one ulp, 1.9e-9 m, from the f32 undistortion): at most 1% of
    the points, each within 1e-6 m.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fastlivo_tpu import native as jnative
from fastlivo_tpu.config import CapacityConfig as JCapacity
from fastlivo_tpu.config import Config as JConfig
from fastlivo_tpu.io.synthetic import SyntheticDataset as JDataset
from fastlivo_tpu.pipeline import Pipeline as JPipeline

from fastlivo_tpu_torch import features, native
from fastlivo_tpu_torch import preprocess as pp
from fastlivo_tpu_torch.config import AVIA, CapacityConfig, Config, PreprocessConfig
from fastlivo_tpu_torch.io import lz4
from fastlivo_tpu_torch.io.synthetic import SyntheticDataset
from fastlivo_tpu_torch.ops.voxel_filter import voxel_downsample
from fastlivo_tpu_torch.pipeline import Pipeline

ROOT = Path(__file__).resolve().parents[1]
LIVOX_DT = np.dtype([("offset_time", "<u4"), ("x", "<f4"), ("y", "<f4"),
                     ("z", "<f4"), ("reflectivity", "u1"), ("tag", "u1"),
                     ("line", "u1")])

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def libs():
    lib, jlib = native.load(), jnative.load()
    assert lib is not None, "the port's native library did not build"
    if jlib is None:
        pytest.skip("the JAX package's native library is unavailable")
    return lib, jlib


def avia_points(seed=0, n=5000):
    rng = np.random.default_rng(seed)
    arr = np.zeros(n, LIVOX_DT)
    xyz = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    arr["x"], arr["y"], arr["z"] = xyz.T
    arr["offset_time"] = np.arange(n) * 4000
    arr["reflectivity"] = rng.integers(0, 255, n)
    arr["tag"] = rng.choice([0x00, 0x10, 0x20, 0x30], n)
    arr["line"] = rng.integers(0, 8, n)
    return arr, xyz


def ring(seed, is_avia):
    """Ring geometry of tests/test_features.py's native case: a wavy wall
    with depth jumps and blind dropouts."""
    rng_ = np.random.default_rng(seed)
    n = int(rng_.integers(40, 400))
    ang = np.linspace(-0.6, 0.6, n)
    r = 6.0 + 2.0 * np.sin(3 * ang) + rng_.normal(0, 0.01, n)
    jump = rng_.random(n) < 0.03
    r = np.where(jump, r * rng_.uniform(1.5, 3.0, n), r)
    r[rng_.random(n) < 0.02] = 0.1
    pl = np.stack([r * np.cos(ang), r * np.sin(ang), 0.1 * np.sin(7 * ang)], 1)
    curv = np.linspace(0, 100, n)
    rr = pl[:, 0] ** 2 + pl[:, 1] ** 2 if is_avia else np.sqrt(pl[:, 0] ** 2 + pl[:, 1] ** 2)
    d = np.diff(pl, axis=0)
    dista = np.concatenate([np.sum(d * d, axis=1), [0.0]])
    return pl, curv, rr, dista


def lz4_cases():
    rng = np.random.default_rng(0)
    yield b""
    yield b"a"
    yield b"abcd" * 3
    yield bytes(rng.integers(0, 256, 100_000, dtype=np.uint8))
    yield bytes(rng.integers(0, 4, 200_000, dtype=np.uint8))
    yield b"\x00" * 300_000  # overlapping matches (offset 1)
    yield bytes(rng.integers(0, 256, 997, dtype=np.uint8)) * 211


def test_port_library_is_bit_equal_to_jax(libs):
    arr, _ = avia_points()
    for a, b in zip(native.decode_avia_native(arr, 6, 2.0, 3),
                    jnative.decode_avia_native(arr, 6, 2.0, 3)):
        np.testing.assert_array_equal(a, b)
    pts = np.random.default_rng(1).uniform(-5, 5, (20000, 4)).astype(np.float32)
    for max_out in (None, 4096):
        for a, b in zip(native.voxel_downsample_native(pts, 0.4, max_out),
                        jnative.voxel_downsample_native(pts, 0.4, max_out)):
            np.testing.assert_array_equal(a, b)
    for trial in range(4):
        args = ring(trial, trial % 2 == 0)
        for a, b in zip(native.give_feature_ring_native(*args, 1.0, 3, trial % 2 == 0),
                        jnative.give_feature_ring_native(*args, 1.0, 3, trial % 2 == 0)):
            np.testing.assert_array_equal(a, b)
    lib, jlib = libs
    for data in lz4_cases():
        comp = lz4.compress_block(data)
        assert lib.xxh32_native(data, len(data), 7) == jlib.xxh32_native(data, len(data), 7)
        out = bytearray()
        lz4._decompress_block_native(lib, comp, out)
        assert bytes(out) == data


def test_port_library_matches_the_numpy_twins(libs):
    arr, xyz = avia_points()
    cfg = PreprocessConfig(lidar_type=AVIA, n_scans=6, blind=2.0, point_filter_num=3)
    got = native.decode_avia_native(arr, cfg.n_scans, cfg.blind, cfg.point_filter_num)
    ref_pts, ref_t = pp.decode_avia(
        xyz.astype(np.float64), arr["reflectivity"].astype(np.float32), arr["tag"],
        arr["line"], arr["offset_time"].astype(np.float64), cfg)
    np.testing.assert_allclose(got[0], ref_pts, rtol=1e-6)
    np.testing.assert_allclose(got[1], ref_t, atol=1e-12)
    pts = np.random.default_rng(1).uniform(-5, 5, (20000, 4)).astype(np.float32)
    out, mask = native.voxel_downsample_native(pts, 0.4)
    ref, _ = voxel_downsample(pts, 0.4)
    assert mask.sum() == len(ref)
    # the same first-occurrence order, the same centroids
    np.testing.assert_allclose(out[:len(ref)], ref, rtol=1e-5, atol=1e-4)
    # rows wider than the kernel's 8 columns go to the numpy twin
    assert native.voxel_downsample_native(np.zeros((4, 9), np.float32), 0.4) is None


def test_give_feature_and_lz4_native_are_exact(libs):
    lib, _ = libs
    for trial in range(6):
        is_avia = trial % 2 == 0
        args = ring(11 + trial, is_avia)
        sp, cp = features.give_feature(*args, 1.0, 3, is_avia)
        sn, cn = native.give_feature_ring_native(*args, 1.0, 3, is_avia)
        np.testing.assert_array_equal(sp, sn)
        np.testing.assert_array_equal(cp, cn)
    for data in lz4_cases():
        comp = lz4.compress_block(data)
        out_n, out_p = bytearray(), bytearray()
        lz4._decompress_block_native(lib, comp, out_n)
        lz4._decompress_block_py(comp, out_p)
        assert bytes(out_n) == bytes(out_p) == data
        assert lz4.xxh32(data) == lz4._xxh32_py(data)
        frame = lz4.compress_frame(data)
        assert lz4.decompress_frame(frame) == data
    # the grow-and-retry path: 8 MB of zeros exceeds the first capacity guess
    data = b"\x00" * (8 << 20)
    out = bytearray()
    lz4._decompress_block_native(lib, lz4.compress_block(data), out)
    assert bytes(out) == data


def test_bootstrap_map_matches_jax(libs):
    """Both packages' bootstrap frames go through the same C++ voxel
    filter: the first maps are equal up to the undistortion's rounding."""
    def cfg_of(cls_cfg, cls_cap):
        cfg = cls_cfg()
        cfg.img_enable = False
        cfg.capacity = cls_cap(max_points=4096, max_raw_points=8192,
                               tiled_dir_dims=(32, 32, 16), tiled_pool=1024)
        return cfg

    kw = dict(duration=1.2, points_per_scan=4096, lidar_noise=0.004, seed=3)
    pipes = []
    for P, C, D, dev in ((JPipeline, cfg_of(JConfig, JCapacity), JDataset, None),
                         (Pipeline, cfg_of(Config, CapacityConfig), SyntheticDataset, "cpu")):
        pipe = P(C) if dev is None else P(C, device=dev)
        ds = D(**kw)
        scans = ds.lidar_scans_fast()
        imu = ds.imu_stream()
        for beg, pts, t_rel in scans:
            pipe.push_lidar(beg, pts, t_rel)
        for t, acc, gyr in imu:
            pipe.push_imu(t, acc, gyr)
        while not pipe.map_built:  # one group at a time, up to the bootstrap
            pipe._process_group(pipe.sync.next_group())
        pipes.append(pipe)
    jp, tp = pipes
    pts_j = jp._map_mod.extract_points(jp.map)[0]
    pts_t = tp._map_mod.extract_points(tp.map)[0]
    assert pts_t.shape == pts_j.shape and len(pts_t) > 1000
    differ = np.any(pts_t != pts_j, axis=1)
    assert differ.mean() <= 0.01, differ.sum()
    np.testing.assert_allclose(pts_t, pts_j, rtol=0, atol=1e-6)


def test_concurrent_first_build(tmp_path):
    """Two processes build into one empty directory at once: both load a
    library, of the same name, and no temporary file is left."""
    code = ("import sys; from pathlib import Path; from fastlivo_tpu_torch import native; "
            "native.BUILD_DIR = Path(sys.argv[1]); lib = native.load(); "
            "assert lib is not None and lib.xxh32_native(b'abc', 3, 0) == 0x32D153FF; "
            "print(native.library_path().name)")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    names = {o[0].strip() for o in outs}
    assert len(names) == 1
    assert sorted(f.name for f in tmp_path.iterdir()) == sorted(names)
