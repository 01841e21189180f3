"""Port parity: the live viewer and offline playback (viz.py) against the
JAX package's.

The same frame outputs through both packages' `LiveViewer`s give the
same reservoir arrays and path rows, bit for bit, and the same number of
PNG frames; the PCD reader round-trips what the port's `run.save_pcd`
writes (positions within 1e-3, the %.4f of the ASCII writer; colours and
intensities exact), and the binary PointXYZRGB convention; importing the
module loads no matplotlib (the card machine has none).
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from fastlivo_tpu import viz as jviz

from fastlivo_tpu_torch import viz
from fastlivo_tpu_torch.run import save_pcd

ROOT = Path(__file__).resolve().parents[1]


class Out:
    """The FrameOutput fields a viewer reads."""

    def __init__(self, t, pos, pts=None, intensity=None):
        self.t, self.pos, self.iters = t, np.asarray(pos, float), 3
        self.pts_world, self.n_points = pts, 0 if pts is None else len(pts)
        self.intensity = intensity


def outputs(seed=0):
    rng = np.random.default_rng(seed)
    outs = []
    for k in range(7):
        n = int(rng.integers(200, 1500))
        pts = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
        inten = None
        if k % 3 == 1:
            inten = rng.uniform(0, 1, n).astype(np.float32)  # normalized
        elif k % 3 == 2:
            inten = rng.uniform(0, 300, n).astype(np.float32)
        outs.append(Out(0.1 * k, [0.01 * k, 0.02, 1.0], None if k == 3 else pts, inten))
    return outs


def test_live_viewer_matches_jax(tmp_path):
    pytest.importorskip("matplotlib")
    kw = dict(every=2, max_cloud=2500, per_frame=512)
    v, jv = viz.LiveViewer(tmp_path / "t", **kw), jviz.LiveViewer(tmp_path / "j", **kw)
    for o in outputs():
        a, b = v.update(o), jv.update(o)
        assert (a is None) == (b is None)
    assert v._n_cloud == jv._n_cloud and v._frame == jv._frame == 7
    np.testing.assert_array_equal(np.concatenate(v._cloud), np.concatenate(jv._cloud))
    np.testing.assert_array_equal(np.asarray(v._path), np.asarray(jv._path))
    frames = sorted((tmp_path / "t").glob("frame_*.png"))
    assert len(frames) == len(list((tmp_path / "j").glob("frame_*.png"))) == v._rendered == 4
    for f in frames + [tmp_path / "t" / "latest.png"]:
        assert f.read_bytes()[:4] == viz._PNG_MAGIC


def test_pcd_round_trips(tmp_path):
    pts = np.array([[1, 2, 3], [4, 5, 6]], np.float32)
    rgb = np.array([[255, 0, 0], [0, 255, 128]], np.float32)
    save_pcd(tmp_path / "c.pcd", pts, rgb)
    p2, r2 = viz._load_pcd(tmp_path / "c.pcd")
    np.testing.assert_allclose(p2, pts, atol=1e-3)
    np.testing.assert_array_equal(r2, rgb)
    for a, b in zip((p2, r2), jviz._load_pcd(tmp_path / "c.pcd")):
        np.testing.assert_array_equal(a, b)
    inten = np.array([10.0, 200.0], np.float32)
    save_pcd(tmp_path / "i.pcd", pts, intensity=inten)
    assert "FIELDS x y z intensity" in (tmp_path / "i.pcd").read_text()
    p2, r2 = viz._load_pcd(tmp_path / "i.pcd")
    np.testing.assert_allclose(r2[:, 0], inten, atol=1e-3)
    assert np.all(r2[:, 0] == r2[:, 1])
    save_pcd(tmp_path / "one.pcd", np.array([[1.0, 2.0, 3.0]], np.float32))
    p, r = viz._load_pcd(tmp_path / "one.pcd")
    assert p.shape == (1, 3) and r is None
    (tmp_path / "bad.pcd").write_bytes(b"VERSION 0.7\nFIELDS x y z\n")
    with pytest.raises(ValueError, match="truncated"):
        viz._load_pcd(tmp_path / "bad.pcd")


def test_pcd_binary_pointxyzrgb_float_bits(tmp_path):
    pts = np.array([[1.5, -2.0, 3.25], [0.0, 4.0, -1.0]], np.float32)
    rgb = np.array([[10, 200, 30], [255, 255, 0]], np.uint32)
    packed = ((rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]).astype(np.uint32)
    rows = np.concatenate([pts, packed.view(np.float32)[:, None]], axis=1)
    hdr = ("# .PCD v0.7\nVERSION 0.7\nFIELDS x y z rgb\nSIZE 4 4 4 4\n"
           "TYPE F F F F\nCOUNT 1 1 1 1\nWIDTH 2\nHEIGHT 1\n"
           "VIEWPOINT 0 0 0 1 0 0 0\nPOINTS 2\nDATA binary\n")
    with open(tmp_path / "b.pcd", "wb") as f:
        f.write(hdr.encode())
        f.write(rows.astype(np.float32).tobytes())
    p2, r2 = viz._load_pcd(tmp_path / "b.pcd")
    np.testing.assert_allclose(p2, pts, atol=1e-6)
    np.testing.assert_array_equal(r2, rgb.astype(np.float32))


def test_playback_matches_jax(tmp_path):
    pytest.importorskip("matplotlib")
    log = tmp_path / "Log"
    log.mkdir()
    rows = np.zeros((12, 22))
    rows[:, 0] = 0.1 * np.arange(12)
    rows[:, 4:7] = np.stack([0.05 * np.arange(12), 0.02 * np.arange(12), np.ones(12)], 1)
    np.savetxt(log / "pos_log.txt", rows)
    rng = np.random.default_rng(2)
    save_pcd(tmp_path / "map.pcd", rng.uniform(-2, 2, (500, 3)).astype(np.float32),
             rng.uniform(0, 255, (500, 3)).astype(np.float32))
    n = viz.playback(log, tmp_path / "t", every=4, pcd=tmp_path / "map.pcd")
    assert n == jviz.playback(log, tmp_path / "j", every=4, pcd=tmp_path / "map.pcd") == 3
    assert (tmp_path / "t" / "latest.png").exists()
    viz.main([str(log), "--out", str(tmp_path / "m"), "--every", "6"])
    assert len(list((tmp_path / "m").glob("frame_*.png"))) == 2


def test_import_loads_no_matplotlib():
    code = ("import sys, fastlivo_tpu_torch.viz, fastlivo_tpu_torch.run; "
            "bad = [m for m in sys.modules if m.startswith('matplotlib')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
