"""Port parity: LIVO over a device mesh through `Pipeline(mesh=,
sharded_map=)`, as gloo ranks on the CPU
(tests/torch_mesh_ranks.py::livo_pipelines_rank), against the JAX
package's `Pipeline(cfg, mesh=make_mesh(2))` on the conftest's virtual
CPU devices, on the same recorded ~2.5 s of synthetic scans, IMU and
320x256 images (tests/test_mesh_product.py::_pipeline_cfg(True)'s
values).

- A world of 2, with the map replicated and with `sharded_map=True` (the
  image pool and the observation rings in per-rank slabs): every
  position within 2 mm of JAX's and the visual map's points within
  max(3, 1%); the two port runs equal, position for position and in
  every array of the whole visual map; the ranks in lockstep; the
  sharded run's per-rank pool and rings half the replicated ones.
- Compaction over slabs: the pipeline's load-factor compaction on the
  slabs gives the replicated run's compacted map, array for array; so
  does a camera frame through `Vio.update_staged` (the slabs gathered,
  the single-device stages run, the slabs cut again).
- A sharded-pool checkpoint (its gathers joined by every rank) loads
  into a single-device Pipeline of the port, and into the JAX package's
  loader, with the whole visual map of the replicated run.
- `serve --mesh 2 --sharded-map` with image messages: the odometry lines
  of JAX's mesh Server within 2 mm; the autosave holds the whole pool.
"""
import numpy as np
import pytest

from fastlivo_tpu import serve as jserve
from fastlivo_tpu.config import Config as JConfig
from fastlivo_tpu.config import load_config as jload_config
from fastlivo_tpu.io import checkpoint as jckpt
from fastlivo_tpu.parallel.sharded import make_mesh as jmake_mesh
from fastlivo_tpu.pipeline import Pipeline as JPipeline

from fastlivo_tpu_torch import serve
from fastlivo_tpu_torch.config import Config
from fastlivo_tpu_torch.io import checkpoint as ckpt
from fastlivo_tpu_torch.io.synthetic import SyntheticDataset
from fastlivo_tpu_torch.parallel.launch import launch
from fastlivo_tpu_torch.pipeline import Pipeline

import torch_mesh_ranks as ranks
from test_torch_mesh_cli import CAM_YAML, LIVO_YAML, serve_session

DURATION = 2.5


def livo_cfg(cls):
    """tests/test_mesh_product.py::_pipeline_cfg(True)'s values, from
    `cls()` (either package's Config)."""
    cfg = cls()
    cfg.img_enable = True
    cfg.dense_map_enable = True
    cfg.capacity.max_raw_points = 8192
    cfg.capacity.max_points = 4096
    cfg.capacity.max_cands = 8192
    cfg.capacity.vmap_points = 4096
    cfg.capacity.frame_ring = 16
    cfg.camera.width, cfg.camera.height = 320, 256
    cfg.camera.fx = cfg.camera.fy = 200.0
    cfg.camera.cx, cfg.camera.cy = 159.5, 127.5
    cfg.grid_size = 32
    cfg.outlier_threshold = 300.0
    cfg.img_point_cov = 100.0
    cfg.Rcl = [0.0, -1.0, 0.0, 0.0, 0.0, -1.0, 1.0, 0.0, 0.0]
    cfg.Pcl = [0.0, 0.0, 0.0]
    return cfg


def record(cfg, duration):
    """The synthetic streams `run --synthetic` makes for `cfg`, drawn
    once, and a host world cloud and an image of the scene after them."""
    cam = cfg.camera
    ds = SyntheticDataset(duration=duration, points_per_scan=8192, lidar_noise=0.004,
                          cam_hz=10.0, cam_size=(cam.width, cam.height), cam_f=cam.fx,
                          cam_fy=cam.fy, cam_c=(cam.cx, cam.cy),
                          cam_d=np.asarray(cam.d[:4]), Rcl=cfg.Rcl_mat, Pcl=cfg.Pcl_vec,
                          lid_rot=cfg.extrinsic_R, lid_off=cfg.extrinsic_T)
    cloud = ds.room.sample_surface(6000, np.random.default_rng(4)).astype(np.float32)
    return (list(ds.lidar_scans_fast()), list(ds.imu_stream()), ds.images(),
            (cloud, ds.render_image(duration)))


@pytest.fixture(scope="module")
def livo(tmp_path_factory):
    cfg = livo_cfg(Config)
    scans, imu, images, staged = record(cfg, DURATION)
    jp = JPipeline(livo_cfg(JConfig), mesh=jmake_mesh(2))
    for b, p, r in scans:
        jp.push_lidar(b, p, r)
    for t, a, g in imu:
        jp.push_imu(t, a, g)
    for t, img in images:
        jp.push_img(t, img)
    jp.spin()
    jp.finish()
    ck = str(tmp_path_factory.mktemp("ck") / "livo.npz")
    port = launch(ranks.livo_pipelines_rank, 2, (cfg, scans, imu, images, ck, staged),
                  timeout=120, deadline=600)
    return jp, port, ck


@pytest.mark.parametrize("sharded", [False, True], ids=["replicated", "sharded_map"])
def test_livo_pipeline_world_of_two_matches_jax(livo, sharded):
    jp, port, _ = livo
    jtraj = jp.tum_trajectory()
    got = [r[int(sharded)] for r in port]
    assert len(jtraj) >= 10 and len(got[0]["t"]) == len(jtraj)
    np.testing.assert_array_equal(got[0]["t"], jtraj[:, 0])
    assert np.abs(got[0]["pos"] - jtraj[:, 1:4]).max() < 2e-3
    n_j, n_t = int(jp.vio.vmap.n_pts), int(got[0]["whole"]["n_pts"])
    assert abs(n_t - n_j) <= max(3, 0.01 * n_j) and n_j > 20, (n_t, n_j)
    assert got[0]["vio_steps"] >= 10 and got[0]["collectives"] > 0
    for r in got[1:]:  # lockstep
        np.testing.assert_array_equal(r["pos"], got[0]["pos"])
        np.testing.assert_array_equal(r["quat"], got[0]["quat"])
        for f, v in r["whole"].items():
            np.testing.assert_array_equal(v, got[0]["whole"][f], err_msg=f)


def test_sharded_pool_matches_replicated_at_half_the_memory(livo):
    _, port, _ = livo
    cap = livo_cfg(Config).capacity
    for r in port:
        rep, sh = r
        np.testing.assert_array_equal(sh["pos"], rep["pos"])
        for f, v in sh["whole"].items():
            np.testing.assert_array_equal(v, rep["whole"][f], err_msg=f)
        assert rep["imgs_rows"] == 2 * sh["imgs_rows"] == cap.frame_ring
        assert rep["obs_rows"] == 2 * sh["obs_rows"] == cap.vmap_points
        # the pool and the rings halve, the rest is replicated
        assert sh["slab_bytes"] * 2 == rep["slab_bytes"] > 0
        assert rep["vmap_bytes"] - sh["vmap_bytes"] == sh["slab_bytes"]


def test_compaction_over_slabs_matches_replicated(livo):
    _, port, _ = livo
    for r in port:
        rep, sh = r
        assert sh["compacted_rows"] * 2 == rep["compacted_rows"]
        assert int(rep["compacted"]["n_pts"]) > 20
        for f, v in sh["compacted"].items():
            np.testing.assert_array_equal(v, rep["compacted"][f], err_msg=f)


def test_update_staged_over_slabs_matches_replicated(livo):
    _, port, _ = livo
    for r in port:
        rep, sh = (x["staged"] for x in r)
        assert rep["stats"]["tracked"] > 5 and sh["stats"] == rep["stats"]
        assert sh["obs_rows"] * 2 == rep["obs_rows"]
        for f, v in sh["state"].items():
            np.testing.assert_array_equal(v, rep["state"][f], err_msg=f)
        for f, v in sh["whole"].items():
            np.testing.assert_array_equal(v, rep["whole"][f], err_msg=f)
    for f, v in port[1][1]["staged"]["state"].items():  # lockstep
        np.testing.assert_array_equal(v, port[0][1]["staged"]["state"][f], err_msg=f)


def test_sharded_pool_checkpoint_loads_on_one_device(livo):
    _, port, ck = livo
    rep = port[0][0]
    state, m, visual, calib = ckpt.load(ck, device="cpu")
    assert visual.imgs.shape[0] == livo_cfg(Config).capacity.frame_ring
    for f, v in rep["whole"].items():
        np.testing.assert_array_equal(getattr(visual, f).numpy(), v, err_msg=f)
    np.testing.assert_array_equal(state.pos.numpy(), port[0][1]["state_pos"])
    pipe = Pipeline(livo_cfg(Config), device="cpu").warm_start(state, m, visual, calib)
    assert int(pipe.vio.vmap.n_pts) == int(rep["whole"]["n_pts"])
    _, _, jvisual, _ = jckpt.load(ck)
    np.testing.assert_array_equal(np.asarray(jvisual.imgs), rep["whole"]["imgs"])


@pytest.fixture(scope="module")
def livo_yamls(tmp_path_factory):
    d = tmp_path_factory.mktemp("livo")
    (d / "livo.yaml").write_text(LIVO_YAML)
    (d / "cam.yaml").write_text(CAM_YAML)
    return str(d / "livo.yaml"), str(d / "cam.yaml")


def livo_messages(duration=2.5):
    """The LIVO stream of `run --synthetic` for LIVO_YAML's camera, as
    wire messages in time order (images included)."""
    ds = SyntheticDataset(duration=duration, points_per_scan=4096, lidar_noise=0.004,
                          seed=3, cam_hz=10.0, cam_size=(320, 256), cam_f=200.0,
                          cam_c=(159.5, 127.5),
                          Rcl=np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], float))
    ev = [(t, serve.encode_imu(t, acc, gyr)) for t, acc, gyr in ds.imu_stream()]
    ev += [(beg, serve.encode_lidar(beg, pts[:, :3], t_rel.astype(np.float32)))
           for beg, pts, t_rel in ds.lidar_scans_fast()]
    ev += [(t, serve.encode_image(t, img)) for t, img in ds.images()]
    ev.sort(key=lambda e: e[0])
    return [m for _, m in ev]


def test_serve_mesh_with_images_matches_jax(livo_yamls, tmp_path):
    """`serve --mesh 2 --sharded-map` with image messages (rank 0 forwards
    each to the follower): JAX's mesh Server's lines within 2 mm; the
    autosave, whose gathers every rank joins, holds the whole pool."""
    msgs = livo_messages()
    jpath, path = str(tmp_path / "j.sock"), str(tmp_path / "t.sock")
    ck = str(tmp_path / "auto.npz")
    cfg = jload_config(*livo_yamls)
    want = serve_session(jserve.Server(cfg, jpath, mesh=jmake_mesh(2), sharded_map=True),
                         jpath, msgs)
    lines = serve_session(["--config", livo_yamls[0], "--camera", livo_yamls[1], "--unix",
                           path, "--device", "cpu", "--mesh", "2", "--sharded-map",
                           "--autosave", ck, "--autosave-every", "4"], path, msgs)
    assert len(lines) == len(want) >= 10
    for a, b in zip(lines, want):
        assert a["t"] == b["t"]
        assert np.linalg.norm(np.subtract(a["pos"], b["pos"])) < 2e-3, (a, b)
    _, _, visual, _ = ckpt.load(ck, device="cpu")
    assert visual.imgs.shape[0] == 16 and int(visual.n_pts) > 20
    assert (visual.img_fid >= 0).sum() > 5
