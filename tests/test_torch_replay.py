"""Port parity for offline replay and deferred readback.

The port's BlockReplayer against the JAX package's BlockReplayer (same
frame count, every position within 1 mm, equal `iters` but on the frames
where the two per-frame paths already differ by one iteration), the same
on the hash map (within 1 mm, `iters` equal on at least 90% of frames), its
LivoBlockReplayer in both modes against the JAX package's (within 2 mm),
a partial last block, and the port's deferred readbacks (`async_read` at
depth 1 and 3, `enable_block_read`) bit-identical to its synchronous
outputs; with `pcd_save_en` and `debug`, LivoBlockReplayer's per-frame
fallback paints the same RGB cloud and draws the same overlay as the
JAX package's.
"""
import numpy as np
import pytest

from fastlivo_tpu.config import CameraConfig as JCamera
from fastlivo_tpu.config import CapacityConfig as JCapacity
from fastlivo_tpu.config import Config as JConfig
from fastlivo_tpu.io.synthetic import SyntheticDataset as JDataset
from fastlivo_tpu.pipeline import Pipeline as JPipeline
from fastlivo_tpu.replay import BlockReplayer as JBlockReplayer
from fastlivo_tpu.replay import LivoBlockReplayer as JLivoBlockReplayer

from fastlivo_tpu_torch.config import CameraConfig, CapacityConfig, Config
from fastlivo_tpu_torch.io.synthetic import SyntheticDataset
from fastlivo_tpu_torch.pipeline import Pipeline
from fastlivo_tpu_torch.replay import BlockReplayer, LivoBlockReplayer

from test_torch_pipeline import CF, CH, CW, RCL, livo_config, other_backend, small_config

LIO_KW = dict(duration=4.0, points_per_scan=4096, lidar_noise=0.004, seed=3)
LIVO_KW = dict(duration=3.0, points_per_scan=2048, lidar_noise=0.004, seed=5,
               cam_hz=10.0, cam_size=(CW, CH), cam_f=CF, Rcl=RCL)


def feed(pipe, ds):
    for beg, pts, t_rel in ds.lidar_scans_fast():
        pipe.push_lidar(beg, pts, t_rel)
    for t, acc, gyr in ds.imu_stream():
        pipe.push_imu(t, acc, gyr)
    for t, img in ds.images():
        pipe.push_img(t, img)
    return pipe


def port_lio(**kw):
    return feed(Pipeline(small_config(Config, CapacityConfig), device="cpu", **kw),
                SyntheticDataset(**LIO_KW))


def port_livo():
    return feed(Pipeline(livo_config(Config, CapacityConfig, CameraConfig), device="cpu"),
                SyntheticDataset(**LIVO_KW))


def assert_same_outputs(a, b):
    """Bit-identical FrameOutputs (timing aside)."""
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.t == y.t and x.iters == y.iters and x.n_active == y.n_active
        assert x.n_points == y.n_points and x.res_rms == y.res_rms
        for f in ("pos", "quat", "vel"):
            np.testing.assert_array_equal(getattr(x, f), getattr(y, f))


def assert_close(outs_t, outs_j, tol):
    assert len(outs_t) == len(outs_j) >= 15
    for a, b in zip(outs_t, outs_j):
        assert a.t == b.t
        assert np.linalg.norm(a.pos - b.pos) < tol, (a.t, a.pos, b.pos)


@pytest.fixture(scope="module")
def per_frame_iter_mismatches():
    """Frames whose EKF iteration count differs between the two packages'
    per-frame paths on LIO_KW: the convergence test sits on its threshold
    there (the positions agree to a fraction of a millimetre)."""
    outs_j = feed(JPipeline(small_config(JConfig, JCapacity)), JDataset(**LIO_KW)).spin()
    outs_t = port_lio().spin()
    return {i for i, (a, b) in enumerate(zip(outs_t, outs_j)) if a.iters != b.iters}


@pytest.mark.parametrize("block", [8, 7])
def test_block_replayer_matches_jax(block, per_frame_iter_mismatches):
    """block 7 leaves a partial last block on this stream. `iters` is the
    JAX package's on every frame but those where the per-frame paths
    already differ by one iteration."""
    pipe_j = feed(JPipeline(small_config(JConfig, JCapacity)), JDataset(**LIO_KW))
    outs_j = JBlockReplayer(pipe_j, block=block).run()
    pipe = port_lio()
    outs_t = BlockReplayer(pipe, block=block).run()
    n_block = sum(1 for o in outs_t if o.n_points == 0 and o.iters > 0)
    assert n_block >= 20 and (block == 8 or n_block % block), n_block
    assert_close(outs_t, outs_j, 1e-3)
    differ = {i for i, (a, b) in enumerate(zip(outs_t, outs_j)) if a.iters != b.iters}
    assert differ <= per_frame_iter_mismatches, (differ, per_frame_iter_mismatches)
    assert all(abs(outs_t[i].iters - outs_j[i].iters) == 1 for i in differ)
    assert len(per_frame_iter_mismatches) <= 0.1 * len(outs_t)
    np.testing.assert_allclose([o.res_rms for o in outs_t],
                               [o.res_rms for o in outs_j], rtol=0.05, atol=1e-4)
    assert pipe.tum_trajectory().shape == (len(outs_t), 8)


def test_block_replayer_on_the_hash_map_matches_jax():
    """The block step on the hash map (its probe depth passed through);
    `cache_knn` is set and, as in the JAX package, the block step leaves
    it out."""
    cfgs = [other_backend(c, k, "hash") for c, k in ((JConfig, JCapacity),
                                                     (Config, CapacityConfig))]
    for cfg in cfgs:
        cfg.capacity.cache_knn = True
        cfg.capacity.max_probe = 8
    outs_j = JBlockReplayer(feed(JPipeline(cfgs[0]), JDataset(**LIO_KW)), block=8).run()
    pipe = feed(Pipeline(cfgs[1], device="cpu"), SyntheticDataset(**LIO_KW))
    outs_t = BlockReplayer(pipe, block=8).run()
    assert type(pipe.map).__name__ == "VoxelMap"
    assert sum(1 for o in outs_t if o.n_points == 0 and o.iters > 0) >= 20
    assert_close(outs_t, outs_j, 1e-3)
    differ = [i for i, (a, b) in enumerate(zip(outs_t, outs_j)) if a.iters != b.iters]
    assert len(differ) <= 0.1 * len(outs_t), differ


def test_livo_block_replayer_matches_jax_both_modes():
    """Block-packed (no per-frame consumer) and the deferred fallback
    (collect_cov set), each against the JAX replayer in the same mode."""
    for per_frame in (False, True):
        pipe_j = feed(JPipeline(livo_config(JConfig, JCapacity, JCamera)),
                      JDataset(**LIVO_KW))
        pipe_j.collect_cov = per_frame
        outs_j = JLivoBlockReplayer(pipe_j, block=8).run()
        pipe = port_livo()
        pipe.collect_cov = per_frame
        outs_t = LivoBlockReplayer(pipe, block=8).run()
        assert_close(outs_t, outs_j, 2e-3)
        assert pipe.vio.fid == pipe_j.vio.fid >= 15
        assert pipe.read_collector is None and pipe.vio.read_collector is None
        assert pipe.async_read is False and pipe.async_depth == 1
        if per_frame:  # the covariance of each frame, not a later one
            assert len(pipe.covs) == len(outs_t)
            for c_t, c_j in zip(pipe.covs, pipe_j.covs):
                np.testing.assert_allclose(c_t, c_j, rtol=0.05, atol=1e-9)


@pytest.mark.parametrize("depth", [1, 3])
def test_async_read_is_bit_identical_to_sync(depth):
    ref = port_lio()
    ref.collect_cov = True
    outs_ref = ref.spin()
    pipe = port_lio()
    pipe.collect_cov = True
    pipe.async_read = True
    pipe.async_depth = depth
    outs = pipe.spin()
    assert len(outs) == len(outs_ref) - depth  # the tail is in flight
    outs = outs + pipe.finish()
    assert_same_outputs(outs, outs_ref)
    for a, b in zip(pipe.covs, ref.covs):  # dispatch-time covariances
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pipe.tum_trajectory(), ref.tum_trajectory())


def test_livo_async_and_block_read_are_bit_identical_to_sync():
    ref = port_livo()
    outs_ref = ref.spin()
    for mode in ("async", "block"):
        pipe = port_livo()
        if mode == "async":
            pipe.async_read = True
            assert pipe.vio.async_read
        else:
            pipe.enable_block_read(4)
            assert pipe.vio.read_collector is pipe.read_collector
        outs = pipe.spin() + pipe.finish()
        assert_same_outputs(outs, outs_ref)
        assert pipe.vio.last_stats == ref.vio.last_stats
        np.testing.assert_array_equal(pipe.vio.last_rcw, ref.vio.last_rcw)


def test_block_read_is_bit_identical_and_refuses_per_frame_consumers():
    ref = port_lio()
    outs_ref = ref.spin()
    pipe = port_lio()
    pipe.enable_block_read(4)
    outs = pipe.spin()
    assert len(outs) < len(outs_ref)
    assert_same_outputs(outs + pipe.finish(), outs_ref)
    for attr, value in (("on_frame", print), ("materialize_dense", True),
                        ("collect_cov", True)):
        p = Pipeline(small_config(Config, CapacityConfig), device="cpu")
        setattr(p, attr, value)
        with pytest.raises(ValueError, match="per-frame consumers"):
            p.enable_block_read(4)


def test_block_replayer_refuses_livo():
    with pytest.raises(ValueError, match="LIO-only"):
        BlockReplayer(Pipeline(livo_config(Config, CapacityConfig, CameraConfig),
                               device="cpu"))


def test_livo_block_replayer_fallback_paints_and_draws_as_jax():
    """LivoBlockReplayer with `pcd_save_en` and `debug` falls back to
    per-frame emission (E-deep deferred lidar reads, synchronous camera
    reads under debug), as the JAX package's does: the same RGB cloud,
    chunk for chunk (positions within 1e-4 m, colours within 0.01), and
    the same last overlay within 0.5% of its pixels."""
    import contextlib
    import io

    runs = []
    for P, cfg, D, R, dev in (
            (JPipeline, livo_config(JConfig, JCapacity, JCamera), JDataset,
             JLivoBlockReplayer, None),
            (Pipeline, livo_config(Config, CapacityConfig, CameraConfig), SyntheticDataset,
             LivoBlockReplayer, "cpu")):
        cfg.pcd_save_en = cfg.debug = True
        pipe = feed(P(cfg) if dev is None else P(cfg, device=dev), D(**LIVO_KW))
        with contextlib.redirect_stdout(io.StringIO()):  # debug_show's dump
            outs = R(pipe, 4).run()
        runs.append((pipe, outs))
    (pj, oj), (pt, ot) = runs
    assert_close(ot, oj, 2e-3)
    assert len(pt.rgb_cloud) == len(pj.rgb_cloud) >= 10
    for ct, cj in zip(pt.rgb_cloud, pj.rgb_cloud):
        assert ct.shape == cj.shape
        np.testing.assert_allclose(ct[:, :3], cj[:, :3], atol=1e-4)
        np.testing.assert_allclose(ct[:, 3:], cj[:, 3:], atol=1e-2)
    assert pt.vio.last_overlay is not None
    assert np.any(pt.vio.last_overlay != pj.vio.last_overlay, axis=-1).mean() <= 5e-3
    assert not pt.async_read and pt.read_collector is None  # restored after the run
