"""Port parity: the golden-trace reader (io/golden.py) against the JAX
package's, on Log/ traces that the port's own CLI writes (`--log-dir`).

Tolerances: every array `load` returns, `estimate_acc_scale` and
`frame_pairs` equal to the JAX package's bit for bit (both parse the
same text with numpy); the Euler round trip rot -> euler*57.3 -> rot
within 1e-12, and the port's conversions equal to the JAX package's.
"""
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from fastlivo_tpu.io import golden as jgolden

from fastlivo_tpu_torch import logging_util
from fastlivo_tpu_torch import run as trun
from fastlivo_tpu_torch.io import golden

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def log_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("golden")
    cfg = d / "cfg.yaml"
    cfg.write_text("img_enable: 0\nfilter_size_surf: 0.5\ncapacity:\n"
                   "  max_points: 4096\n  max_raw_points: 8192\n"
                   "  tiled_dir_dims: [32, 32, 16]\n  tiled_pool: 1024\n")
    assert trun.main(["--config", str(cfg), "--synthetic", "--no-img", "--duration", "2.5",
                      "--out", str(d / "traj.txt"), "--log-dir", str(d / "Log"),
                      "--device", "cpu"]) == 0
    return d / "Log"


def test_load_matches_jax_on_port_traces(log_dir):
    assert golden.available(log_dir) and jgolden.available(log_dir)
    assert not golden.available(log_dir.parent)
    tr, jtr = golden.load(log_dir), jgolden.load(log_dir)
    assert tr._fields == jtr._fields
    for f in tr._fields:
        np.testing.assert_array_equal(getattr(tr, f), getattr(jtr, f), f)
    assert len(tr.out_t) >= 10 and len(tr.imu_head) >= 100
    assert golden.estimate_acc_scale(tr) == jgolden.estimate_acc_scale(jtr)
    for k in (1, len(tr.out_t) // 2, len(tr.out_t) - 1):
        for a, b in zip(golden.frame_pairs(tr, k), jgolden.frame_pairs(jtr, k)):
            np.testing.assert_array_equal(a, b)
    # the logged posterior rotation comes back a rotation
    R = tr.out_rot
    np.testing.assert_allclose(R @ np.swapaxes(R, 1, 2), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-9)


def test_load_refuses_wrong_shapes(tmp_path):
    for name, cols in (("mat_pre.txt", 19), ("mat_out.txt", 19), ("imu.txt", 7)):
        np.savetxt(tmp_path / name, np.zeros((3, cols)))
    with pytest.raises(ValueError, match="unexpected trace shapes"):
        golden.load(tmp_path)


def test_euler_round_trip():
    R = Rotation.random(200, random_state=4).as_matrix()
    e = golden.rot_to_euler(R) * golden.EULER_SCALE
    np.testing.assert_array_equal(e, jgolden.rot_to_euler(R) * jgolden.EULER_SCALE)
    back = golden.euler_to_rot(e)
    np.testing.assert_array_equal(back, jgolden.euler_to_rot(e))
    np.testing.assert_allclose(back, R, atol=1e-12)
    # the trace writer uses the reader's convention
    assert logging_util.EULER_SCALE == golden.EULER_SCALE == 57.3
    np.testing.assert_array_equal(logging_util._euler_deg(R[0]), e[0])
