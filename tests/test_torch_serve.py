"""Port parity for the socket server (serve.py).

The same synthetic stream sent over Unix sockets to the JAX package's
Server and to the port's (on the CPU): equal odometry line counts, every
position within 1 mm. Also: the wire format is the JAX package's byte
for byte, a bad length prefix is rejected, a silent subscriber gets the
broadcast, `--block-read` with `--log-dir` is refused, and an autosave
warm-starts either package.
"""
import json
import socket
import struct

import numpy as np
import pytest

from fastlivo_tpu import serve as jserve
from fastlivo_tpu.config import CapacityConfig as JCapacity
from fastlivo_tpu.config import Config as JConfig
from fastlivo_tpu.io import checkpoint as jckpt
from fastlivo_tpu.pipeline import Pipeline as JPipeline

from fastlivo_tpu_torch import serve
from fastlivo_tpu_torch.config import CapacityConfig, Config
from fastlivo_tpu_torch.io import checkpoint as ckpt
from fastlivo_tpu_torch.io.synthetic import SyntheticDataset
from fastlivo_tpu_torch.pipeline import Pipeline

from test_torch_pipeline import small_config

KW = dict(duration=4.0, points_per_scan=4096, lidar_noise=0.004, seed=3)


def events(ds, t_min=None):
    ev = [(t, serve.encode_imu(t, acc, gyr)) for t, acc, gyr in ds.imu_stream()]
    ev += [(beg, serve.encode_lidar(beg, pts[:, :3], t_rel.astype(np.float32)))
           for beg, pts, t_rel in ds.lidar_scans_fast()]
    ev.sort(key=lambda e: e[0])
    return [m for t, m in ev if t_min is None or t >= t_min]


def connect(address):
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    c.connect(address)
    c.settimeout(120)
    return c


def read_lines(c, until_flush=True, n_lines=None):
    """JSON lines from `c` until the flush ack (or `n_lines` lines)."""
    buf, lines = b"", []
    while True:
        if n_lines is not None and len(lines) >= n_lines:
            return lines
        chunk = c.recv(65536)
        if not chunk:
            return lines
        buf += chunk
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            d = json.loads(line)
            if until_flush and d.get("flushed"):
                return lines
            lines.append(d)


def stream(srv, msgs):
    """Send `msgs` and a flush over one connection; returns the odometry
    lines and waits for the server to finish."""
    srv.start_background()
    c = connect(srv.address)
    for m in msgs:
        c.sendall(m)
    c.sendall(serve.encode_flush())
    lines = read_lines(c)
    c.close()
    srv.wait(60)
    assert srv._done.is_set()
    return lines


def test_wire_format_is_the_jax_packages():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(7, 3)).astype(np.float32)
    t_rel = rng.uniform(0, 0.1, 7)
    img = rng.integers(0, 255, (4, 5, 3), dtype=np.uint8)
    assert serve.encode_imu(1.5, [0, 0, 9.8], [0.1, 0, 0]) == \
        jserve.encode_imu(1.5, [0, 0, 9.8], [0.1, 0, 0])
    assert serve.encode_lidar(2.0, pts, t_rel) == jserve.encode_lidar(2.0, pts, t_rel)
    assert serve.encode_image(2.5, img) == jserve.encode_image(2.5, img)
    assert serve.encode_image(2.5, img[..., 0]) == jserve.encode_image(2.5, img[..., 0])
    assert serve.encode_flush() == jserve.encode_flush()
    assert (serve.IMU, serve.LIDAR, serve.IMAGE, serve.FLUSH, serve.MAX_MSG) == \
        (jserve.IMU, jserve.LIDAR, jserve.IMAGE, jserve.FLUSH, jserve.MAX_MSG)


@pytest.mark.parametrize("async_read", [False, True])
def test_socket_stream_matches_jax(tmp_path, async_read):
    msgs = events(SyntheticDataset(**KW))
    jsrv = jserve.Server(small_config(JConfig, JCapacity), str(tmp_path / "j.sock"))
    jsrv.pipe.async_read = async_read
    lines_j = stream(jsrv, msgs)
    srv = serve.Server(small_config(Config, CapacityConfig), str(tmp_path / "t.sock"),
                       device="cpu")
    srv.pipe.async_read = async_read
    lines_t = stream(srv, msgs)
    assert len(lines_t) == len(lines_j) >= 15
    for a, b in zip(lines_t, lines_j):
        assert a.keys() == b.keys()
        assert a["t"] == b["t"] and a["auto_resets"] == b["auto_resets"] == 0
        assert np.linalg.norm(np.subtract(a["pos"], b["pos"])) < 1e-3, (a, b)


def test_bad_length_prefix_rejected(tmp_path):
    srv = serve.Server(small_config(Config, CapacityConfig), str(tmp_path / "s"),
                       device="cpu").start_background()
    c = connect(srv.address)
    c.sendall(struct.pack("<I", 1 << 30))
    buf = b""
    while b"\n" not in buf:
        buf += c.recv(4096)
    assert b"bad message length" in buf
    c.close()
    assert srv.wait(10)


def test_subscriber_receives_broadcast(tmp_path):
    srv = serve.Server(small_config(Config, CapacityConfig), str(tmp_path / "s"),
                       device="cpu").start_background()
    sub = connect(srv.address)
    pub = connect(srv.address)
    for m in events(SyntheticDataset(**dict(KW, duration=2.5, points_per_scan=2048))):
        pub.sendall(m)
    pub.sendall(serve.encode_flush())
    pub_lines = read_lines(pub)
    assert len(pub_lines) > 5
    sub_lines = read_lines(sub, until_flush=False, n_lines=len(pub_lines))
    assert sub_lines == pub_lines
    pub.close()
    sub.close()
    assert srv.wait(10)


def test_block_read_with_log_dir_is_refused(tmp_path):
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("img_enable: 0\n")
    with pytest.raises(SystemExit):
        serve.main(["--config", str(cfg), "--unix", str(tmp_path / "s"),
                    "--block-read", "4", "--log-dir", str(tmp_path / "Log"),
                    "--device", "cpu"])
    assert not (tmp_path / "s").exists()  # refused before binding


def test_autosave_warm_starts_both_packages(tmp_path):
    """A port server autosaves while streaming the first half; the port
    and the JAX package each warm-start from the file and track the
    second half (first 5 frames within 5 cm, RMS within 3 cm)."""
    kw = dict(duration=5.0, points_per_scan=2048, lidar_noise=0.004, seed=4)
    split = 2.5
    ds = SyntheticDataset(**kw)
    save = tmp_path / "auto.npz"
    srv = serve.Server(small_config(Config, CapacityConfig), str(tmp_path / "s"),
                       device="cpu", autosave=str(save), autosave_every=5)
    first = [m for t, m in sorted(
        [(t, serve.encode_imu(t, a, g)) for t, a, g in ds.imu_stream() if t < split + 0.05]
        + [(b, serve.encode_lidar(b, p[:, :3], r.astype(np.float32)))
           for b, p, r in ds.lidar_scans_fast() if b < split], key=lambda e: e[0])]
    lines = stream(srv, first)
    assert len(lines) >= 10 and save.exists() and not save.with_suffix(".npz.tmp").exists()
    base = ds.traj.base_pos
    for restore in ("port", "jax"):
        if restore == "port":
            pipe = Pipeline(small_config(Config, CapacityConfig), device="cpu")
            pipe.warm_start(*ckpt.load(save, device="cpu"))
        else:
            pipe = JPipeline(small_config(JConfig, JCapacity))
            pipe.warm_start(*jckpt.load(save))
        assert pipe.init_done and pipe.map_built
        for beg, pts, t_rel in ds.lidar_scans_fast():
            if beg >= split:
                pipe.push_lidar(beg, pts, t_rel)
        for t, acc, gyr in ds.imu_stream():
            if t >= split:
                pipe.push_imu(t, acc, gyr)
        outs = pipe.spin() + pipe.finish()
        assert len(outs) >= 20, restore
        errs = [np.linalg.norm(o.pos - (ds.traj.pose(o.t)[1] - base)) for o in outs]
        assert np.max(errs[:5]) < 0.05, (restore, errs[:5])
        assert np.sqrt(np.mean(np.square(errs))) < 0.03, restore
