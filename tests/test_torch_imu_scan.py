"""Port parity of IMU propagation as the kernel's wrapper sees it.

`propagate_wire`, `propagate_packed` and `propagate` of the port against
the JAX package's on the same seeded groups (tests/torch_imu_cases.py):
B = 8, 32 (padded) and 64, past the kernel's 64-pair chunk at 256, 300,
512 and 1024 (no cap), leading skipped pairs, a group with no valid
pair, a negative tail, gyro samples below so3.exp's small-angle
threshold, and a chain of three groups carrying acc_s_last / angvel_last
from the pipeline's f32 zeros. Tolerance atol 1e-10 (f64 recursion on f32
inputs; the bound of tests/test_torch_imu.py). On the CPU these run the
plain loop, the kernel's oracle (the kernel itself is held to it on the
card, tests/test_torch_cuda.py). Also: the PoseTable of pose-pack views
that `propagate` returns on the card equals the plain loop's, the wire
`propagate` builds on the device equals `pack_pairs_wire`'s, and the
wrapper's input checks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastlivo_tpu import imu as jimu
from fastlivo_tpu import state as jstate

import torch_imu_cases as cases
from fastlivo_tpu_torch import imu as timu
from fastlivo_tpu_torch.ops import imu_scan


def jax_inputs(st, cal):
    sj = jstate.NavState(**{f: jnp.asarray(st[f]) for f in jstate.NavState._fields})
    return sj, jimu.ImuCalib(**{f: jnp.asarray(v) for f, v in cal.items()})


def run(fn, s, calib, w, a, g, xp):
    """(state, pose pack, acc_s_last', angvel_last') of one group through
    `fn` of the package `xp` (jimu or timu)."""
    if fn == "wire":
        return xp.propagate_wire(s, w, a, g, calib)
    args = cases.wire_arrays(w)
    if fn == "packed":
        return xp.propagate_packed(s, *args[:6], a, g, calib, row0_off=args[6])
    st, pose, a2, g2 = xp.propagate(s, *args[:6], a, g, calib, row0_off=args[6])
    return st, pose, a2, g2


def assert_close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-10,
                               err_msg=what)


@pytest.mark.parametrize("name", list(cases.CASES))
@pytest.mark.parametrize("fn", ["wire", "packed", "propagate"])
def test_propagation_matches_jax(fn, name):
    st_a, cal, wires, a0, g0 = cases.case(name)
    sj, cj = jax_inputs(st_a, cal)
    st, ct = cases.torch_state(st_a, "cpu"), cases.torch_calib(cal, "cpu")
    aj, gj = jnp.asarray(a0), jnp.asarray(g0)
    at, gt = torch.from_numpy(a0), torch.from_numpy(g0)
    for k, w in enumerate(wires):
        sj, out_j, aj, gj = run(fn, sj, cj, jnp.asarray(w), aj, gj, jimu)
        st, out_t, at, gt = run(fn, st, ct, torch.from_numpy(w), at, gt, timu)
        for f in jstate.NavState._fields:
            assert_close(getattr(st, f), getattr(sj, f), f"group {k} state.{f}")
        if fn == "propagate":
            for f in timu.PoseTable._fields:
                assert_close(getattr(out_t, f), getattr(out_j, f), f"group {k} pose.{f}")
                assert getattr(out_t, f).dtype == torch.float64
        else:
            assert out_t.shape == (w.shape[0] + 1, 24) and out_t.dtype == torch.float64
            assert_close(out_t, out_j, f"group {k} pose pack")
        assert_close(at, aj, f"group {k} acc_s_last")
        assert_close(gt, gj, f"group {k} angvel_last")
        assert at.dtype == gt.dtype == torch.float64


@pytest.mark.parametrize("name", list(cases.CASES))
def test_pose_views_and_device_wire_equal_the_plain_loop(name):
    """What `propagate` returns and builds on the card, here on the CPU:
    the pose-pack views equal the plain loop's PoseTable in value and
    dtype and undistort the same; the device-built wire equals
    `pack_pairs_wire`'s."""
    st_a, cal, wires, a0, g0 = cases.case(name)
    s, calib = cases.torch_state(st_a, "cpu"), cases.torch_calib(cal, "cpu")
    a, g = torch.from_numpy(a0), torch.from_numpy(g0)
    for w in wires:
        args = cases.wire_arrays(torch.from_numpy(w))
        assert torch.equal(timu._wire(*args), torch.from_numpy(w))
        assert torch.equal(timu._wire(*args[:6], float(cases.ROW0_OFF)), torch.from_numpy(w))
        s2, pose, a, g = timu.propagate_plain(s, *args[:6], a, g, calib, row0_off=args[6])
        views = timu.pose_views(timu._pack_pose(pose, s2))
        for f in timu.PoseTable._fields:
            got, want = getattr(views, f), getattr(pose, f)
            assert got.dtype == want.dtype and torch.equal(got, want), f
        rng = np.random.default_rng(3)
        pts = torch.from_numpy(rng.uniform(-20, 20, (500, 3)).astype(np.float32))
        t_rel = torch.from_numpy(np.sort(rng.uniform(0, 0.2, 500)).astype(np.float32))
        mask = torch.from_numpy(rng.random(500) > 0.1)
        assert torch.equal(timu.undistort(s2, views, pts, t_rel, mask, calib),
                           timu.undistort(s2, pose, pts, t_rel, mask, calib))
        s = s2
    with pytest.raises(ValueError, match="float32"):
        timu._wire(*args[:6], 0.1)


def check_args(**change):
    st_a, cal, wires, _, _ = cases.case("b8")
    args = dict(s=cases.torch_state(st_a, "cpu"), wire=torch.from_numpy(wires[0]),
                acc0=torch.zeros(3, dtype=torch.float64),
                gyr0=torch.zeros(3, dtype=torch.float64),
                calib=cases.torch_calib(cal, "cpu"))
    args.update(change)
    return args


def test_wrapper_checks_accept_the_pipeline_inputs():
    """Any B >= 1: the kernel has no pair cap (a 4 kHz IMU fills a bucket
    of 512 pairs per 10 Hz group)."""
    assert imu_scan.check_inputs(**check_args()) == 8
    for B in (512, 300):
        w = torch.zeros((B + 1, 9))
        assert imu_scan.check_inputs(**check_args(wire=w)) == B


@pytest.mark.parametrize("bad", ["f32_state", "f64_wire", "b_over_limit", "mixed_devices",
                                 "f64_calib", "strided_wire"])
def test_wrapper_checks_refuse(bad):
    a = check_args()
    s, w = a["s"], a["wire"]
    change, err = {
        "f32_state": ({"s": s._replace(cov=s.cov.float())}, TypeError),
        "f64_wire": ({"wire": w.double()}, TypeError),
        # once a wire over the 256-pair cap; with no cap left, the wire
        # the kernel still refuses: one row, no pair
        "b_over_limit": ({"wire": torch.zeros((1, 9))}, ValueError),
        "mixed_devices": ({"wire": torch.empty((9, 9), device="meta")}, ValueError),
        "f64_calib": ({"calib": a["calib"]._replace(cov_acc=a["calib"].cov_acc.double())},
                      TypeError),
        "strided_wire": ({"wire": torch.zeros((9, 18))[:, ::2]}, ValueError),
    }[bad]
    with pytest.raises(err):
        imu_scan.check_inputs(**check_args(**change))


def test_wrapper_takes_cuda_only():
    """The wrapper has no CPU path: on a CPU wire it raises, and
    `imu.propagate_wire` keeps the plain loop for a CPU state."""
    a = check_args()
    n0 = imu_scan.imu_propagate.launches
    with pytest.raises(ValueError, match="CUDA"):
        imu_scan.imu_propagate(a["s"], a["wire"], a["acc0"], a["gyr0"], a["calib"])
    assert imu_scan.imu_propagate.launches == n0
