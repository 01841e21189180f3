"""IMU propagation over one measurement group in one launch.

`imu_propagate` is the port of the device program that the JAX package
compiles from the `lax.scan` in `fastlivo_tpu/imu.py::propagate` (line
314; not a Pallas kernel). On a CUDA wire it launches the hand-written
kernel in csrc/imu_propagate.cu (built at first use, see _build.py): the
whole chain of IMU pairs, the covariance recursion, the pose pack and
the tail extrapolation in one launch, where the plain loop launches ~150
small kernels per pair. It takes CUDA tensors only: `imu.propagate_wire`
keeps the CPU's plain loop `imu.propagate_wire_plain`, which is also the
kernel's oracle on the card.

Contract: every output within 1e-10 absolute of the plain loop on the
card (the bound tests/test_torch_imu.py holds the loop to against JAX);
there the loop's 18x18 f64 products run through cuBLAS in another
summation order. Two launches on the same inputs are bit-equal.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..state import DIM_STATE, NavState

F32, F64 = torch.float32, torch.float64


def check_inputs(s: NavState, wire, acc0, gyr0, calib) -> int:
    """Raise unless the kernel takes these inputs: a (B+1, 9) f32 wire
    with B >= 1, an f64 state, f64 (3,) acc0 and gyr0, an f32
    calibration, all contiguous on the wire's device. Returns B."""
    if wire.ndim != 2 or wire.shape[1] != 9 or wire.shape[0] < 2:
        raise ValueError(f"imu_propagate: wire {tuple(wire.shape)}, want (B+1, 9) with "
                         f"B >= 1")
    if wire.dtype != F32:
        raise TypeError(f"imu_propagate: wire must be float32, got {wire.dtype}")
    shapes = {"rot": (3, 3), "cov": (DIM_STATE, DIM_STATE)}
    state = [(f"state.{f}", getattr(s, f), shapes.get(f, (3,)), F64) for f in s._fields]
    cal = [("calib.acc_scale", calib.acc_scale, (), F32)] + [
        (f"calib.{f}", getattr(calib, f), (3,), F32)
        for f in ("cov_acc", "cov_gyr", "cov_bias_acc", "cov_bias_gyr")]
    for name, t, shape, dtype in state + [("acc_s_last", acc0, (3,), F64),
                                          ("angvel_last", gyr0, (3,), F64)] + cal:
        if tuple(t.shape) != shape:
            raise ValueError(f"imu_propagate: {name} {tuple(t.shape)}, want {shape}")
        if t.dtype != dtype:
            raise TypeError(f"imu_propagate: {name} must be {dtype}, got {t.dtype}")
        if t.device != wire.device:
            raise ValueError(f"imu_propagate: {name} on {t.device}, the wire on {wire.device}")
        if not t.is_contiguous():
            raise ValueError(f"imu_propagate: {name} must be contiguous")
    if not wire.is_contiguous():
        raise ValueError("imu_propagate: the wire must be contiguous")
    return wire.shape[0] - 1


@functools.cache
def _launcher():
    from . import _build

    fn = _build.load("imu_propagate").imu_propagate_launch
    fn.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return _build.profiled("imu_propagate", fn)


def imu_propagate(s: NavState, wire: torch.Tensor, acc_s_last, angvel_last, calib):
    """`imu.propagate_wire`: (state at the segment end, (B+2, 24) f64 pose
    pack, acc_s_last', angvel_last' (f64)). acc_s_last and angvel_last may
    be f32 (the pipeline's first group) and are widened. A CUDA wire
    launches the kernel on the current stream (counted in
    `imu_propagate.launches`) and reads nothing back to the host. Any
    other device raises: nothing falls back."""
    if wire.device.type != "cuda":
        raise ValueError(f"imu_propagate: the kernel needs a CUDA wire, got {wire.device}")
    acc0, gyr0 = acc_s_last.to(F64), angvel_last.to(F64)
    B = check_inputs(s, wire, acc0, gyr0, calib)
    out = dict(dtype=F64, device=wire.device)
    rot, pos, vel = torch.empty((3, 3), **out), torch.empty(3, **out), torch.empty(3, **out)
    cov = torch.empty((DIM_STATE, DIM_STATE), **out)
    pack = torch.empty((B + 2, 24), **out)
    acc_last, gyr_last = torch.empty(3, **out), torch.empty(3, **out)
    ptrs = [t.data_ptr() for t in (
        wire, s.rot, s.pos, s.vel, s.bg, s.ba, s.grav, s.cov, acc0, gyr0,
        calib.acc_scale, calib.cov_acc, calib.cov_gyr, calib.cov_bias_acc,
        calib.cov_bias_gyr, rot, pos, vel, cov, pack, acc_last, gyr_last)]
    err = _launcher()(*ptrs, B, torch.cuda.current_stream(wire.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"imu_propagate: kernel launch failed (cudaError {err})")
    imu_propagate.launches += 1
    return NavState(rot, pos, vel, s.bg, s.ba, s.grav, cov), pack, acc_last, gyr_last


imu_propagate.launches = 0
