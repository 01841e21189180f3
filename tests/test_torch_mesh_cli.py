"""Port parity: the entry points over a device mesh, `run --mesh N
[--sharded-map]` and `serve --mesh N [--sharded-map]`, as gloo ranks on
the CPU (`--device cpu`), against the JAX package's mesh on the
conftest's virtual CPU devices.

- `run --synthetic --no-img --mesh 2 [--sharded-map]`: the trajectory
  within 1 mm of JAX's `run_synthetic` through `Pipeline(cfg,
  mesh=make_mesh(2))`; rank 0 writes the trajectory, the map PCD and
  the checkpoint, whose merged map has the PCD's points and loads into
  a single-device Pipeline of either package.
- `serve --mesh 2 [--sharded-map]` on a Unix socket: the odometry lines
  of JAX's `Server(cfg, mesh=make_mesh(2))` for the same messages, every
  position within 1 mm; the autosave (its gather is a collective) loads.
- LIVO (a 320x256 camera): `run --synthetic --mesh 2` within 2 mm of
  JAX's `run_synthetic` through `Pipeline(cfg, mesh=make_mesh(2))`
  (`serve --mesh 2` with images: tests/test_torch_vio_mesh_pipeline.py).
- The command-line refusals word for word JAX's; missing cards refused
  before any rank starts.
"""
import os
import threading
import time

import numpy as np
import pytest

from fastlivo_tpu import serve as jserve
from fastlivo_tpu.config import load_config as jload_config
from fastlivo_tpu.io import checkpoint as jckpt
from fastlivo_tpu.parallel.sharded import make_mesh as jmake_mesh
from fastlivo_tpu.pipeline import Pipeline as JPipeline
from fastlivo_tpu.run import main as jrun_main
from fastlivo_tpu.run import run_synthetic as jrun_synthetic

from fastlivo_tpu_torch import run, serve
from fastlivo_tpu_torch.io import checkpoint as ckpt
from fastlivo_tpu_torch.io.synthetic import SyntheticDataset
from fastlivo_tpu_torch.ops import tiled_map as tm
from fastlivo_tpu_torch.pipeline import Pipeline

from test_torch_serve import KW, connect, events, read_lines

# tests/test_mesh_product.py::_pipeline_cfg(False)'s capacities
MESH_YAML = ("capacity: {max_raw_points: 8192, max_points: 4096, max_cands: 8192, "
             "vmap_points: 4096, frame_ring: 16}\n")
# and _pipeline_cfg(True)'s camera settings, with its 320x256 camera
LIVO_YAML = MESH_YAML + ("img_enable: 1\ngrid_size: 32\noutlier_threshold: 300\n"
                         "img_point_cov: 100\ncamera: {Rcl: [0, -1, 0, 0, 0, -1, 1, 0, 0], "
                         "Pcl: [0, 0, 0]}\n")
CAM_YAML = ("cam_width: 320\ncam_height: 256\ncam_fx: 200\ncam_fy: 200\n"
            "cam_cx: 159.5\ncam_cy: 127.5\n")
SMALL_YAML = ("capacity: {max_points: 4096, max_raw_points: 8192, "
              "tiled_dir_dims: [32, 32, 16], tiled_pool: 1024}\n")


@pytest.fixture(scope="module")
def yamls(tmp_path_factory):
    d = tmp_path_factory.mktemp("cfg")
    (d / "mesh.yaml").write_text(MESH_YAML)
    (d / "small.yaml").write_text(SMALL_YAML)
    return str(d / "mesh.yaml"), str(d / "small.yaml")


@pytest.fixture(scope="module")
def jax_run(yamls):
    """`run --synthetic --no-img --duration 2` through JAX's mesh of 2."""
    cfg = jload_config(yamls[0])
    cfg.img_enable = False
    pipe = JPipeline(cfg, mesh=jmake_mesh(2))
    jrun_synthetic(pipe, 2.0, False)
    return pipe.tum_trajectory()


@pytest.mark.parametrize("sharded", [False, True], ids=["replicated", "sharded_map"])
def test_run_mesh_matches_jax(yamls, jax_run, tmp_path, sharded):
    out, pcd, ck = (str(tmp_path / f) for f in ("traj.txt", "map.pcd", "ck.npz"))
    argv = ["--config", yamls[0], "--synthetic", "--no-img", "--duration", "2",
            "--device", "cpu", "--mesh", "2", "--out", out, "--map-pcd", pcd,
            "--save-ckpt", ck] + (["--sharded-map"] if sharded else [])
    assert run.main(argv) == 0
    traj = np.loadtxt(out)
    assert traj.shape == jax_run.shape and len(traj) >= 8
    np.testing.assert_allclose(traj[:, 0], jax_run[:, 0], rtol=0, atol=1e-9)
    assert np.abs(traj[:, 1:4] - jax_run[:, 1:4]).max() < 1e-3
    np.testing.assert_allclose(traj[:, 4:], jax_run[:, 4:], atol=1e-5)
    with open(pcd) as f:
        n_pcd = int(next(line for line in f if line.startswith("POINTS")).split()[1])
    state, m, _, calib = ckpt.load(ck, device="cpu")
    assert tm.extract_points(m)[1] == n_pcd > 1000
    np.testing.assert_allclose(state.pos.numpy(), traj[-1, 1:4], atol=1e-6)
    Pipeline(run.load_config(yamls[0]), device="cpu").warm_start(state, m, calib=calib)
    jstate, jm, _, _ = jckpt.load(ck)
    assert int(jm.n_alloc) == int(m.n_alloc)


def serve_session(argv_or_server, path, msgs):
    """Send `msgs` and a flush to a server (a `serve.main` argv run on a
    thread, or a JAX Server); returns the odometry lines once it ends."""
    if isinstance(argv_or_server, list):
        rc = []
        th = threading.Thread(target=lambda: rc.append(serve.main(argv_or_server)),
                              daemon=True)
        th.start()
        t0 = time.monotonic()
        while not os.path.exists(path):
            assert th.is_alive() and time.monotonic() - t0 < 120
            time.sleep(0.1)
    else:
        argv_or_server.start_background()
    c = connect(path)
    for m in msgs:
        c.sendall(m)
    c.sendall(serve.encode_flush())
    lines = read_lines(c)
    c.close()
    if isinstance(argv_or_server, list):
        th.join(120)
        assert not th.is_alive() and rc == [0]
    else:
        argv_or_server.wait(60)
        assert argv_or_server._done.is_set()
    return lines


@pytest.fixture(scope="module")
def messages():
    """tests/test_torch_serve.py's stream (the single-device servers of
    both packages agree on it within 1 mm)."""
    return events(SyntheticDataset(**KW))


@pytest.fixture(scope="module")
def jax_serve(yamls, messages, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jsrv") / "j.sock")
    cfg = jload_config(yamls[1])
    cfg.img_enable = False
    return serve_session(jserve.Server(cfg, path, mesh=jmake_mesh(2)), path, messages)


@pytest.mark.parametrize("sharded", [False, True], ids=["replicated", "sharded_map"])
def test_serve_mesh_matches_jax(yamls, messages, jax_serve, tmp_path, sharded):
    path, ck = str(tmp_path / "t.sock"), str(tmp_path / "auto.npz")
    argv = ["--config", yamls[1], "--unix", path, "--device", "cpu", "--mesh", "2",
            "--autosave", ck, "--autosave-every", "4"] + (["--sharded-map"] if sharded else [])
    lines = serve_session(argv, path, messages)
    assert len(lines) == len(jax_serve) >= 10
    for a, b in zip(lines, jax_serve):
        assert a.keys() == b.keys() and a["t"] == b["t"]
        assert np.linalg.norm(np.subtract(a["pos"], b["pos"])) < 1e-3, (a, b)
    state, m, _, calib = ckpt.load(ck, device="cpu")
    np.testing.assert_allclose(state.pos.numpy(), lines[-1]["pos"], atol=1e-6)
    assert int(m.n_alloc) > 0


@pytest.mark.xfail(reason="the f32 summation-order drift between the packages (ROADMAP "
                   "Queue 3): on this 3 s stream one frame of the single-device servers "
                   "already differs by more than 1 mm", strict=False)
def test_serve_mesh_short_stream_matches_jax(yamls, tmp_path):
    """The 3 s stream of the same seed, mesh against mesh, at the same bound."""
    msgs = events(SyntheticDataset(**dict(KW, duration=3.0)))
    cfg = jload_config(yamls[1])
    cfg.img_enable = False
    jpath, path = str(tmp_path / "j.sock"), str(tmp_path / "t.sock")
    want = serve_session(jserve.Server(cfg, jpath, mesh=jmake_mesh(2)), jpath, msgs)
    lines = serve_session(["--config", yamls[1], "--unix", path, "--device", "cpu",
                           "--mesh", "2"], path, msgs)
    assert len(lines) == len(want) >= 10
    for a, b in zip(lines, want):
        assert a["t"] == b["t"]
        assert np.linalg.norm(np.subtract(a["pos"], b["pos"])) < 1e-3, (a, b)


REFUSALS = [
    ("run", ["--synthetic", "--mesh", "2", "--block", "8"]),
    ("run", ["--synthetic", "--sharded-map"]),
    ("run", ["--synthetic", "--mesh", "2", "--sharded-map", "--load-ckpt", "x.npz"]),
    ("serve", ["--unix", "s.sock", "--sharded-map"]),
    ("serve", ["--unix", "s.sock", "--mesh", "2", "--sharded-map", "--load-ckpt", "x.npz"]),
]


def error_line(main, argv, capsys):
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == 2
    return capsys.readouterr().err.strip().splitlines()[-1]


@pytest.mark.parametrize("entry,argv", REFUSALS,
                         ids=[f"{e}:{' '.join(a[1:])}" for e, a in REFUSALS])
def test_cli_errors_match_jax(yamls, capsys, entry, argv):
    argv = ["--config", yamls[1]] + argv
    jmain = jrun_main if entry == "run" else jserve.main
    tmain = run.main if entry == "run" else serve.main
    want = error_line(jmain, argv, capsys)
    assert "error: --" in want
    assert error_line(tmain, argv, capsys) == want


@pytest.fixture(scope="module")
def livo_yamls(tmp_path_factory):
    d = tmp_path_factory.mktemp("livo")
    (d / "livo.yaml").write_text(LIVO_YAML)
    (d / "cam.yaml").write_text(CAM_YAML)
    return str(d / "livo.yaml"), str(d / "cam.yaml")


def test_cli_refuses_camera_and_missing_cards(livo_yamls, yamls, tmp_path):
    """The camera is no longer refused with a mesh: `run --synthetic
    --mesh 2` in LIVO mode runs and stays within 2 mm of JAX's
    run_synthetic through its mesh Pipeline. Missing cards are still
    refused before any rank starts."""
    cfg = jload_config(*livo_yamls)
    pipe = JPipeline(cfg, mesh=jmake_mesh(2))
    jrun_synthetic(pipe, 2.5, True)
    want = pipe.tum_trajectory()
    out = str(tmp_path / "traj.txt")
    assert run.main(["--config", livo_yamls[0], "--camera", livo_yamls[1], "--synthetic",
                     "--duration", "2.5", "--device", "cpu", "--mesh", "2",
                     "--out", out]) == 0
    traj = np.loadtxt(out)
    assert traj.shape == want.shape and len(traj) >= 10
    np.testing.assert_allclose(traj[:, 0], want[:, 0], rtol=0, atol=1e-9)
    assert np.abs(traj[:, 1:4] - want[:, 1:4]).max() < 2e-3
    assert pipe.vio.vmap.n_pts > 20
    with pytest.raises(ValueError, match="needs 2 cards"):
        run.main(["--config", yamls[1], "--synthetic", "--no-img", "--mesh", "2"])
