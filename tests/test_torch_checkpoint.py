"""Port parity for checkpoints, warm restart and the Log/ traces.

A checkpoint written by either package loads into the other, on every
map backend: a JAX snapshot (tiled or hash map) restored into the port
continues 10 frames within 1 mm of the JAX package continuing from the
same file, and every array of a port snapshot (tiled, hash or dense)
loads into the JAX package unchanged, and back. A restored hash map,
churned by deletions and re-inserts, rebuilds array-identical in both. The `warm`/`warm.npz`
suffix and a snapshot without a calib behave as in the JAX package.

The Log/ files of a port run hold the JAX run's rows: imu.txt and every
time column equal, the state columns within 1e-6 relative or 1e-5
absolute; a column whose largest magnitude is under 0.1 (the biases and
accelerations) gets 1e-4 of that magnitude instead, so it is held to its
own scale, down to two units of the file's last printed digit. The
estimated states of the two packages themselves differ
by up to ~3.4e-6 on this run (the trajectory tolerance elsewhere is
1 mm); fed the same states, the two loggers write identical files.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fastlivo_tpu.config import CapacityConfig as JCapacity
from fastlivo_tpu.config import Config as JConfig
from fastlivo_tpu.io import checkpoint as jckpt
from fastlivo_tpu.io.synthetic import SyntheticDataset as JDataset
from fastlivo_tpu.ops import dense_map as jdm
from fastlivo_tpu.ops import voxel_map as jvm
from fastlivo_tpu.pipeline import Pipeline as JPipeline

from fastlivo_tpu_torch.config import CameraConfig, CapacityConfig, Config
from fastlivo_tpu_torch.io import checkpoint as ckpt
from fastlivo_tpu_torch.io.synthetic import SyntheticDataset
from fastlivo_tpu_torch.ops import voxel_map as tvm
from fastlivo_tpu_torch.pipeline import Pipeline

from test_torch_pipeline import CF, CH, CW, RCL, livo_config, other_backend, small_config

KW = dict(duration=4.0, points_per_scan=4096, lidar_noise=0.004, seed=4)
T_SPLIT = 2.5


def feed(pipe, ds, t_min=None, t_max=None):
    inside = lambda t: (t_min is None or t >= t_min) and (t_max is None or t < t_max)  # noqa: E731
    for beg, pts, t_rel in ds.lidar_scans_fast():
        if inside(beg):
            pipe.push_lidar(beg, pts, t_rel)
    for t, acc, gyr in ds.imu_stream():
        # the first half takes the IMU samples that close its last scan
        if inside(t) or (t_max is not None and t_max <= t < t_max + 0.05):
            pipe.push_imu(t, acc, gyr)
    for t, img in ds.images():
        if inside(t):
            pipe.push_img(t, img)
    return pipe


def as_np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


@pytest.fixture(scope="module")
def jax_snapshot(tmp_path_factory):
    """The JAX package's first half of KW, saved with its calib."""
    pipe = feed(JPipeline(small_config(JConfig, JCapacity)), JDataset(**KW),
                t_max=T_SPLIT)
    outs = pipe.spin() + pipe.finish()
    assert len(outs) >= 12 and pipe.init_done
    path = tmp_path_factory.mktemp("ck") / "jax.npz"
    jckpt.save(path, pipe.state, pipe.map, None, calib=pipe.calib)
    return path


def test_jax_checkpoint_continues_in_the_port(jax_snapshot):
    jp = JPipeline(small_config(JConfig, JCapacity))
    jp.warm_start(*jckpt.load(jax_snapshot))
    outs_j = feed(jp, JDataset(**KW), t_min=T_SPLIT).spin()
    tp = Pipeline(small_config(Config, CapacityConfig), device="cpu")
    tp.warm_start(*ckpt.load(jax_snapshot, device="cpu"))
    assert tp.init_done and tp.map_built and tp.calib is not None
    outs_t = feed(tp, SyntheticDataset(**KW), t_min=T_SPLIT).spin()
    assert len(outs_t) == len(outs_j) >= 10
    assert all(o.iters > 0 for o in outs_t)  # the EKF runs from the first frame
    for a, b in zip(outs_t[:10], outs_j[:10]):
        assert a.t == b.t
        assert np.linalg.norm(a.pos - b.pos) < 1e-3, (a.t, a.pos, b.pos)


def test_port_checkpoint_loads_into_jax(tmp_path):
    """LIVO, so the snapshot holds every part: state, map, visual map and
    calib, each array equal after the JAX package loads it."""
    kw = dict(duration=2.0, points_per_scan=2048, lidar_noise=0.004, seed=5,
              cam_hz=10.0, cam_size=(CW, CH), cam_f=CF, Rcl=RCL)
    pipe = feed(Pipeline(livo_config(Config, CapacityConfig, CameraConfig), device="cpu"),
                SyntheticDataset(**kw))
    pipe.spin()
    assert int(pipe.vio.vmap.n_pts) > 0
    path = tmp_path / "port.npz"
    ckpt.save(path, pipe.state, pipe.checkpointable_map(), pipe.vio.vmap, calib=pipe.calib)
    state, m, vmap, calib = jckpt.load(path)
    assert type(m).__name__ == "TiledMap"
    for got, want in ((state, pipe.state), (m, pipe.map), (vmap, pipe.vio.vmap),
                      (calib, pipe.calib)):
        got_np, want_np = as_np(got), {k: v.numpy() for k, v in want._asdict().items()}
        assert got_np.keys() == want_np.keys()
        for k in want_np:
            assert got_np[k].dtype == want_np[k].dtype, k
            np.testing.assert_array_equal(got_np[k], want_np[k], err_msg=k)


def test_snapshot_owns_its_arrays():
    """On the CPU the maps are updated in place too: a snapshot taken
    before a frame must not change with it (the server's autosave thread
    compresses it while the next frame runs)."""
    pipe = Pipeline(livo_config(Config, CapacityConfig, CameraConfig), device="cpu")
    kw = dict(duration=2.0, points_per_scan=2048, lidar_noise=0.004, seed=5,
              cam_hz=10.0, cam_size=(CW, CH), cam_f=CF, Rcl=RCL)
    feed(pipe, SyntheticDataset(**kw), t_max=1.5).spin()
    assert pipe.map_built and int(pipe.vio.vmap.n_pts) > 0
    snap = ckpt.to_host(pipe.state, pipe.checkpointable_map(), pipe.vio.vmap, pipe.calib)
    kept = {k: v.copy() for k, v in snap.items()}
    ds = SyntheticDataset(**kw)
    for beg, pts, t_rel in ds.lidar_scans_fast():
        if beg >= 1.5:
            pipe.push_lidar(beg, pts, t_rel)
    for t, acc, gyr in ds.imu_stream():
        if t >= 1.55:  # the first feed took the samples up to here
            pipe.push_imu(t, acc, gyr)
    for t, img in ds.images():
        if t >= 1.5:
            pipe.push_img(t, img)
    pipe.spin()
    after = ckpt.to_host(pipe.state, pipe.checkpointable_map(), pipe.vio.vmap, pipe.calib)
    moved = [k for k in kept if not np.array_equal(after[k], kept[k])]
    assert any(k.startswith("map/") for k in moved) and any(
        k.startswith("vmap/") for k in moved), moved  # the frames did write
    for k in kept:
        np.testing.assert_array_equal(snap[k], kept[k], err_msg=k)


def test_warm_suffix_and_snapshot_without_calib(tmp_path):
    pipe = Pipeline(small_config(Config, CapacityConfig), device="cpu")
    ckpt.save(tmp_path / "warm", pipe.state, pipe.map)  # numpy appends .npz
    assert (tmp_path / "warm.npz").exists()
    for name in ("warm", "warm.npz"):
        state, m, vmap, calib = ckpt.load(tmp_path / name, device="cpu")
        assert vmap is None and calib is None
        np.testing.assert_array_equal(state.cov.numpy(), pipe.state.cov.numpy())
    # the JAX package reads the suffix-less name the same way
    assert jckpt.load(tmp_path / "warm")[3] is None
    fresh = Pipeline(small_config(Config, CapacityConfig), device="cpu")
    fresh.warm_start(state, m, vmap, calib)
    assert fresh.map_built and not fresh.init_done  # IMU init re-runs


@pytest.fixture(scope="module")
def jax_hash_snapshot(tmp_path_factory):
    """The JAX package's first half of KW on the hash map, with its calib."""
    pipe = feed(JPipeline(other_backend(JConfig, JCapacity, "hash")), JDataset(**KW),
                t_max=T_SPLIT)
    outs = pipe.spin() + pipe.finish()
    assert len(outs) >= 12 and type(pipe.map).__name__ == "VoxelMap"
    path = tmp_path_factory.mktemp("ck") / "jax_hash.npz"
    jckpt.save(path, pipe.state, pipe.map, None, calib=pipe.calib)
    return path


def test_refuses_other_map_backends(jax_hash_snapshot, tmp_path):
    """A JAX hash-map snapshot loads into a port pipeline configured for
    the tiled map (the snapshot's backend wins, as in the JAX package)
    and continues within 1 mm of the JAX package; a map type that no
    backend has is refused."""
    jp = JPipeline(small_config(JConfig, JCapacity))
    jp.warm_start(*jckpt.load(jax_hash_snapshot))
    outs_j = feed(jp, JDataset(**KW), t_min=T_SPLIT).spin()
    tp = Pipeline(small_config(Config, CapacityConfig), device="cpu")
    tp.warm_start(*ckpt.load(jax_hash_snapshot, device="cpu"))
    assert type(tp.map).__name__ == "VoxelMap" and tp._map_mod is tvm
    outs_t = feed(tp, SyntheticDataset(**KW), t_min=T_SPLIT).spin()
    assert len(outs_t) == len(outs_j) >= 10
    assert all(o.iters > 0 for o in outs_t)
    for a, b in zip(outs_t[:10], outs_j[:10]):
        assert a.t == b.t
        assert np.linalg.norm(a.pos - b.pos) < 1e-3, (a.t, a.pos, b.pos)
    arrays = dict(np.load(jax_hash_snapshot))
    arrays["map_type"] = np.array("octree")
    np.savez(tmp_path / "octree.npz", **arrays)
    with pytest.raises(ValueError, match="octree"):
        ckpt.load(tmp_path / "octree.npz", device="cpu")


@pytest.mark.parametrize("backend", ["hash", "dense"])
def test_other_backend_checkpoints_both_directions(backend, tmp_path):
    """A port snapshot of a hash or dense map loads into the JAX package
    with every array unchanged; the JAX package's re-save of it loads
    back into the port unchanged."""
    pipe = feed(Pipeline(other_backend(Config, CapacityConfig, backend), device="cpu"),
                SyntheticDataset(**KW), t_max=1.5)
    pipe.spin()
    assert pipe.map_built and int(pipe.map.count) > 500
    path = tmp_path / "port.npz"
    ckpt.save(path, pipe.state, pipe.checkpointable_map(), calib=pipe.calib)
    assert str(np.load(path)["map_type"]) == {"hash": "voxel", "dense": "dense"}[backend]
    state, m, _, calib = jckpt.load(path)
    assert type(m) is {"hash": jvm.VoxelMap, "dense": jdm.DenseMap}[backend]
    for got, want in ((state, pipe.state), (m, pipe.map), (calib, pipe.calib)):
        got_np, want_np = as_np(got), {k: v.numpy() for k, v in want._asdict().items()}
        assert got_np.keys() == want_np.keys()
        for k in want_np:
            assert got_np[k].dtype == want_np[k].dtype, k
            np.testing.assert_array_equal(got_np[k], want_np[k], err_msg=k)
    jckpt.save(tmp_path / "jax.npz", state, m, None, calib=calib)
    _, m2, _, _ = ckpt.load(tmp_path / "jax.npz", device="cpu")
    assert type(m2) is type(pipe.map)
    for a, b in zip(m2, pipe.map):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_hash_rebuild_after_churn(jax_hash_snapshot):
    """The restored hash map in both packages: half of it deleted, the
    deleted region re-inserted at a shallow probe (holes in the chains
    leave duplicate entries), then rebuilt: array-identical throughout."""
    _, mj, _, _ = jckpt.load(jax_hash_snapshot)
    _, mt, _, _ = ckpt.load(jax_hash_snapshot, device="cpu")
    pts, n = tvm.extract_points(mt)
    lo = np.array([[-20.0, 0.0, -5.0]], np.float32)
    hi = np.array([[20.0, 20.0, 5.0]], np.float32)
    mj = jvm.delete_boxes(mj, jnp.asarray(lo), jnp.asarray(hi))
    mt = tvm.delete_boxes(mt, torch.from_numpy(lo), torch.from_numpy(hi))
    assert 0 < int(mt.count) < n
    again = pts + np.float32([0.01, -0.02, 0.015])
    valid = np.ones(len(again), bool)
    mj = jvm.insert(mj, jnp.asarray(again), jnp.asarray(valid), max_probe=4)
    mt = tvm.insert(mt, torch.from_numpy(again), torch.from_numpy(valid), 4)
    churned = int(mt.count)
    mj, mt = jvm.rebuild(mj), tvm.rebuild(mt)
    for k, v in mj._asdict().items():
        np.testing.assert_array_equal(getattr(mt, k).numpy(), np.asarray(v), err_msg=k)
    assert churned > int(mt.count) == len(tvm.extract_points(mt)[0]) > 0.5 * n


def read_log(d, name):
    return np.loadtxt(d / name, ndmin=2)


def test_log_files_match_jax(tmp_path):
    ds_kw = dict(duration=3.0, points_per_scan=2048, lidar_noise=0.004, seed=3)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jp = feed(JPipeline(small_config(JConfig, JCapacity), log_dir=jdir), JDataset(**ds_kw))
    jp.spin()
    jp.logger.close()
    tp = feed(Pipeline(small_config(Config, CapacityConfig), device="cpu", log_dir=tdir),
              SyntheticDataset(**ds_kw))
    tp.async_read = True  # the logger rides the deferred path too
    tp.spin()
    tp.finish()
    tp.logger.close()
    for name in ("mat_pre.txt", "mat_out.txt", "imu.txt", "pos_log.txt"):
        a, b = read_log(tdir, name), read_log(jdir, name)
        assert a.shape == b.shape and len(a) >= 15, (name, a.shape, b.shape)
        np.testing.assert_array_equal(a[:, 0], b[:, 0], err_msg=name)
        lsb = 1e-6 if name == "pos_log.txt" else 1e-8  # "%.6f" / "%.8f"
        for j in range(b.shape[1]):
            scale = np.abs(b[:, j]).max()
            atol = max(1e-5 * min(1.0, scale / 0.1), 2 * lsb)
            np.testing.assert_allclose(a[:, j], b[:, j], rtol=1e-6, atol=atol,
                                       err_msg=f"{name} column {j}")
    np.testing.assert_array_equal(read_log(tdir, "imu.txt"), read_log(jdir, "imu.txt"))


def test_trace_loggers_write_identical_files(tmp_path):
    """The port's TraceLogger and the JAX package's, fed the same packed
    states, IMU rows and camera poses, write the same bytes."""
    from fastlivo_tpu.logging_util import TraceLogger as JLogger

    from fastlivo_tpu_torch.logging_util import TraceLogger

    logs = []
    for cls, d in ((TraceLogger, tmp_path / "port"), (JLogger, tmp_path / "jax")):
        lg, r = cls(d), np.random.default_rng(0)
        for k in range(5):
            q, _ = np.linalg.qr(r.normal(size=(3, 3)))
            pack = np.concatenate([q.reshape(9), r.normal(size=15)])
            lg.log_pre(1.5 + 0.1 * k, pack)
            lg.log_post(1.5 + 0.1 * k, pack, n_points=100 + k)
            lg.log_pos(0.1 * k, pack)
            lg.log_imu(0.01 * k, r.normal(size=3), r.normal(size=3))
            lg.log_camera_pose(1.5 + 0.1 * k, q.astype(np.float32),
                               r.normal(size=3).astype(np.float32))
        lg.close()
        logs.append(d)
    for name in ("mat_pre.txt", "mat_out.txt", "imu.txt", "pos_log.txt", "camera_pose.txt"):
        assert (logs[0] / name).read_bytes() == (logs[1] / name).read_bytes(), name
