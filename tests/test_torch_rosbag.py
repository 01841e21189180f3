"""Port parity for bag ingestion and bag replay.

The port's copies of the bag reader, the LZ4 codec and the vendor
decoders against the JAX package's modules on the same bytes: exactly
equal outputs for Avia, Velodyne, Ouster and XT32 messages in plain, bz2
and lz4 chunks, with and without feature extraction. Then
`run.main(["--bag", ...])` of both packages on one fixture bag: the LIO
trajectories within 1 mm, per frame and with `--block 4`.
"""
import numpy as np
import pytest
import yaml

from fastlivo_tpu import preprocess as jpp
from fastlivo_tpu import run as jrun
from fastlivo_tpu.config import AVIA, OUST64, VELO16, XT32
from fastlivo_tpu.config import PreprocessConfig as JPreprocess
from fastlivo_tpu.io import lz4 as jlz4
from fastlivo_tpu.io import rosbag as jrb

from fastlivo_tpu_torch import preprocess as pp
from fastlivo_tpu_torch import run as trun
from fastlivo_tpu_torch.config import PreprocessConfig
from fastlivo_tpu_torch.io import lz4
from fastlivo_tpu_torch.io import rosbag as rb
from fastlivo_tpu_torch.io.synthetic import SyntheticDataset

from test_rosbag_preprocess import (build_bag, make_imu_msg, make_livox_msg,
                                    make_vendor_pc2_msg)

LIVOX_DTYPE = np.dtype([("offset_time", "u4"), ("x", "f4"), ("y", "f4"), ("z", "f4"),
                        ("reflectivity", "u1"), ("tag", "u1"), ("line", "u1")])
VENDOR = {AVIA: ("livox", 6), VELO16: ("velodyne", 16), OUST64: ("ouster", 64),
          XT32: ("xt32", 32)}


def lidar_msg(lidar_type, stamp, pts, t_rel, rng):
    """One lidar message of the vendor's wire layout (and its type)."""
    n = len(pts)
    name, scan_line = VENDOR[lidar_type]
    if lidar_type == AVIA:
        arr = np.zeros(n, LIVOX_DTYPE)
        arr["x"], arr["y"], arr["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
        arr["offset_time"] = (t_rel * 1e9).astype(np.uint64)
        arr["reflectivity"] = rng.integers(0, 255, n)
        arr["tag"] = rng.choice([0x10, 0x00, 0x20], n, p=[0.8, 0.15, 0.05])
        arr["line"] = rng.integers(0, 7, n)
        return "livox_ros_driver/CustomMsg", make_livox_msg(stamp, arr)
    common = dict(x=pts[:, 0], y=pts[:, 1], z=pts[:, 2],
                  intensity=rng.uniform(0, 100, n).astype(np.float32),
                  ring=np.arange(n) % scan_line)
    extra = {VELO16: dict(time=t_rel.astype(np.float32)),
             OUST64: dict(t=(t_rel * 1e9).astype(np.uint32)),
             XT32: dict(timestamp=stamp + t_rel)}[lidar_type]
    return "sensor_msgs/PointCloud2", make_vendor_pc2_msg(stamp, name, **common, **extra)


def write_bag(path, lidar_type, compression, duration=3.0, points=2048, seed=7):
    ds = SyntheticDataset(duration=duration, points_per_scan=points, seed=seed)
    rng = np.random.default_rng(seed)
    msgs = [(0, "/imu", "sensor_msgs/Imu", 100.0 + t, make_imu_msg(100.0 + t, acc, gyr))
            for t, acc, gyr in ds.imu_stream()]
    for beg, pts, t_rel in ds.lidar_scans_fast():
        mtype, raw = lidar_msg(lidar_type, 100.0 + beg, pts, t_rel, rng)
        msgs.append((1, "/points", mtype, 100.0 + beg, raw))
    msgs.sort(key=lambda m: m[3])
    half = len(msgs) // 2  # two chunks: the second one compressed
    build_bag(path, [("none", msgs[:half]), (compression, msgs[half:])])
    return ds


def assert_equal_msgs(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k]


@pytest.mark.parametrize("lidar_type", [AVIA, VELO16, OUST64, XT32])
@pytest.mark.parametrize("compression", ["bz2", "lz4"])
def test_reader_and_decoders_match_jax(tmp_path, lidar_type, compression):
    bag = tmp_path / "t.bag"
    write_bag(bag, lidar_type, compression, duration=1.0, points=512)
    got, want = list(rb.read_bag(bag)), list(jrb.read_bag(bag))
    assert len(got) == len(want) > 100
    n_lidar = 0
    for (t_a, ty_a, s_a, m_a), (t_b, ty_b, s_b, m_b) in zip(got, want):
        assert (t_a, ty_a, s_a) == (t_b, ty_b, s_b)
        assert_equal_msgs(m_a, m_b)
        if t_a != "/points":
            continue
        n_lidar += 1
        for feat in (False, True):
            if feat and lidar_type == XT32:
                continue  # the JAX package has no XT32 feature path either
            kw = dict(lidar_type=lidar_type, n_scans=VENDOR[lidar_type][1],
                      blind=0.5, point_filter_num=2, feature_extract_enable=feat)
            fields = trun._lidar_fields(ty_a, m_a, lidar_type)
            j_fields = jrun._lidar_fields(ty_b, m_b, lidar_type)
            assert_equal_msgs(fields, j_fields)
            pts, t_rel = pp.decode(fields, PreprocessConfig(**kw))
            j_pts, j_t = jpp.decode(j_fields, JPreprocess(**kw))
            assert feat or len(pts) > 0
            np.testing.assert_array_equal(pts, j_pts)
            np.testing.assert_array_equal(t_rel, j_t)
    assert n_lidar >= 9


def test_lz4_codec_matches_jax():
    rng = np.random.default_rng(1)
    for data in (b"", b"abcd" * 300, bytes(rng.integers(0, 255, 5000, dtype=np.uint8)),
                 b"ab" * 20000):
        frame = lz4.compress_frame(data)
        assert frame == jlz4.compress_frame(data)
        assert lz4.decompress_frame(frame) == data == jlz4.decompress_frame(frame)
        assert lz4.xxh32(data) == jlz4.xxh32(data)


@pytest.fixture(scope="module")
def lio_bag(tmp_path_factory):
    d = tmp_path_factory.mktemp("bag")
    ds = write_bag(d / "avia.bag", AVIA, "bz2", duration=4.0, points=4096, seed=3)
    cfg = {
        "img_enable": 0, "lidar_enable": 1, "max_iteration": 4,
        "filter_size_surf": 0.3, "filter_size_map": 0.3, "laser_point_cov": 0.001,
        "point_filter_num": 1,
        "common": {"lid_topic": "/points", "imu_topic": "/imu"},
        "preprocess": {"lidar_type": AVIA, "scan_line": 6, "blind": 0.1},
        "mapping": {"extrinsic_T": [0.0, 0.0, 0.0],
                    "extrinsic_R": [1, 0, 0, 0, 1, 0, 0, 0, 1]},
        "capacity": {"max_points": 4096, "max_raw_points": 8192,
                     "max_imu_per_group": 64, "tiled_dir_dims": [32, 32, 16],
                     "tiled_pool": 1024},
    }
    (d / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    return d, ds


@pytest.mark.parametrize("block", [0, 4])
def test_cli_bag_replay_matches_jax(lio_bag, block):
    d, ds = lio_bag
    args = ["--config", str(d / "cfg.yaml"), "--bag", str(d / "avia.bag")]
    if block:
        args += ["--block", str(block)]
    assert jrun.main(args + ["--out", str(d / f"j{block}.txt")]) == 0
    assert trun.main(args + ["--out", str(d / f"t{block}.txt"), "--device", "cpu"]) == 0
    tj = np.loadtxt(d / f"j{block}.txt", ndmin=2)
    tt = np.loadtxt(d / f"t{block}.txt", ndmin=2)
    assert tt.shape == tj.shape and len(tt) >= 25
    np.testing.assert_array_equal(tt[:, 0], tj[:, 0])
    assert np.linalg.norm(tt[:, 1:4] - tj[:, 1:4], axis=1).max() < 1e-3
    # and it tracks the ground truth
    base = ds.traj.base_pos
    errs = [np.linalg.norm(r[1:4] - (ds.traj.pose(r[0] - 100.0)[1] - base))
            for r in tt if r[0] - 100.0 >= ds.traj.t_static + 0.5]
    assert np.sqrt(np.mean(np.square(errs))) < 0.02


def test_cli_bag_options(lio_bag, tmp_path):
    """--max-frames, --log-dir, --pcd-out (LIO intensity cloud),
    --map-pcd and a --save-ckpt/--load-ckpt round trip; --eval with
    --block is refused (--pcd-out in LIVO writes the RGB cloud:
    test_torch_pipeline.py::test_cli_livo_pcd_out_and_viz_dir)."""
    d, _ = lio_bag
    base = ["--config", str(d / "cfg.yaml"), "--bag", str(d / "avia.bag"),
            "--device", "cpu"]
    assert trun.main(base + ["--out", str(tmp_path / "a.txt"), "--max-frames", "12",
                             "--log-dir", str(tmp_path / "Log"),
                             "--pcd-out", str(tmp_path / "c.pcd"),
                             "--map-pcd", str(tmp_path / "m.pcd"),
                             "--save-ckpt", str(tmp_path / "ck.npz")]) == 0
    # 12 frames emitted when the cap hits, and the one still in flight
    # (offline replay defers each read by a frame), as in the JAX package
    assert len(np.loadtxt(tmp_path / "a.txt", ndmin=2)) == 13
    assert len(np.loadtxt(tmp_path / "Log" / "mat_out.txt", ndmin=2)) == 13
    assert "FIELDS x y z intensity" in (tmp_path / "c.pcd").read_text()[:200]
    assert "POINTS" in (tmp_path / "m.pcd").read_text()[:300]
    assert trun.main(base + ["--out", str(tmp_path / "b.txt"),
                             "--load-ckpt", str(tmp_path / "ck.npz")]) == 0
    assert len(np.loadtxt(tmp_path / "b.txt", ndmin=2)) >= 25
    with pytest.raises(SystemExit):
        trun.main(["--synthetic", "--eval", "--block", "4", "--device", "cpu"])
