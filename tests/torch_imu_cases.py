"""Seeded inputs of one measurement group's IMU propagation, for the
port's tests on the CPU (against the JAX package) and on the card
(against the plain loop). numpy and torch only: the card tests import no
JAX.

A case is a list of groups, each a (B+1, 9) f32 wire in
`imu.pack_pairs_wire`'s layout; the state, the calibration and the
segment-start acc / gyro (the pipeline's f32 zeros) are shared. A chain
carries the state and acc / gyro from group to group.
"""
import numpy as np
import torch

from fastlivo_tpu_torch.imu import BIG_T, ImuCalib
from fastlivo_tpu_torch.state import NavState

ROW0_OFF = np.float32(0.02)

# name: [(B, leading skipped pairs, valid pairs, tail_dt, small-angle gyro)]
CASES = {
    "b8": [(8, 0, 8, 0.003, False)],
    "b32_padded": [(32, 0, 21, 0.0021, False)],
    "b64": [(64, 0, 64, 0.001, False)],
    "leading_skipped": [(16, 2, 10, 0.002, False)],
    "no_valid_pair": [(8, 3, 0, 0.004, False)],
    "negative_tail": [(16, 0, 12, -0.0023, False)],
    "small_angle": [(16, 0, 12, 0.003, True)],
    "chain_of_three": [(16, 1, 12, 0.002, False), (16, 0, 10, -0.001, False),
                       (32, 0, 20, 0.003, False)],
    # past the kernel's chunk of 64 pairs: whole chunks, a ragged last one
    # after leading skipped pairs, padding inside a chunk
    "b256": [(256, 0, 256, 0.002, False)],
    "b300": [(300, 2, 280, -0.001, False)],
    "b512": [(512, 0, 400, 0.003, False)],
    "b1024": [(1024, 0, 1024, 0.001, False)],
}


def _exp(phi):
    t = np.linalg.norm(phi)
    K = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]], [-phi[1], phi[0], 0]])
    return np.eye(3) + np.sin(t) / t * K + (1 - np.cos(t)) / t**2 * K @ K


def state_arrays(rng, small_angle=False) -> dict:
    """A random f64 state: rotated, moving, with biases and an SPD
    covariance. Under `small_angle` the gyro bias is ~1e-6 rad/s, so that
    zero gyro samples give rotation vectors below so3.exp's Taylor
    threshold."""
    A = rng.normal(size=(18, 18)) * 0.01
    return {
        "rot": _exp(rng.normal(size=3) * 0.5),
        "pos": rng.normal(size=3),
        "vel": rng.normal(size=3) * 0.5,
        "bg": rng.normal(size=3) * (1e-6 if small_angle else 1e-3),
        "ba": rng.normal(size=3) * 1e-2,
        "grav": np.array([0.01, -0.02, -9.81]),
        "cov": A @ A.T + np.eye(18) * 1e-3,
    }


def calib_arrays() -> dict:
    f = np.float32
    return {
        "acc_scale": np.array(9.81 / 9.79, f),
        "cov_acc": np.array([0.011, 0.0093, 0.013], f),
        "cov_gyr": np.array([1.1e-4, 0.9e-4, 1.3e-4], f),
        "cov_bias_acc": np.full(3, 1e-5, f),
        "cov_bias_gyr": np.full(3, 1e-5, f),
        "lid_rot": np.eye(3, dtype=f),
        "lid_off": np.array([0.05, -0.02, 0.1], f),
    }


def wire(rng, B, lead, n_valid, tail_dt, small_angle) -> np.ndarray:
    """One group's (B+1, 9) f32 wire: `lead` skipped pairs (offs at row
    0's), then `n_valid` pairs of ~5 ms, then padding (offs BIG_T).
    Under `small_angle` every other valid pair has a gyro of 0 or ~5e-5
    rad/s (so3.exp's Taylor forms: |w dt| below 1e-6), the rest turn at
    up to ~2 rad/s."""
    w = np.zeros((B + 1, 9), np.float32)
    w[:lead, 7] = ROW0_OFF
    w[lead + n_valid:B, 7] = BIG_T
    t = float(ROW0_OFF)
    for i in range(lead, lead + n_valid):
        dt = 0.005 + rng.uniform(-2e-4, 2e-4)
        t += dt
        w[i, 0:3] = np.array([0.1, -0.2, 9.79]) + rng.normal(0, 0.5, 3)
        w[i, 3:6] = np.array([0.3, -0.2, 0.5]) + rng.normal(0, 1.0, 3)
        if small_angle and i % 2 == 0:
            w[i, 3:6] = 0.0 if i % 4 == 0 else rng.normal(0, 5e-5, 3)
        w[i, 6] = dt
        w[i, 7] = t
        w[i, 8] = 1.0
    w[B, 0] = tail_dt
    w[B, 1] = ROW0_OFF
    return w


def case(name, seed=0):
    """(state arrays, calib arrays, [wire per group], acc0, gyr0) of a
    case; acc0 and gyr0 are the pipeline's f32 zeros."""
    rng = np.random.default_rng(seed)
    groups = CASES[name]
    small = any(g[4] for g in groups)
    wires = [wire(rng, *g) for g in groups]
    z = np.zeros(3, np.float32)
    return state_arrays(rng, small), calib_arrays(), wires, z, z.copy()


def torch_state(d: dict, device) -> NavState:
    return NavState(**{f: torch.as_tensor(d[f], dtype=torch.float64, device=device)
                       for f in NavState._fields})


def torch_calib(d: dict, device) -> ImuCalib:
    return ImuCalib(**{f: torch.as_tensor(d[f], device=device) for f in ImuCalib._fields})


def wire_arrays(w):
    """`propagate`'s separate arguments from a wire (numpy or torch):
    acc_avg, gyr_avg, dt, offs, pair_valid, tail_dt, row0_off."""
    P = w.shape[0] - 1
    return w[:P, 0:3], w[:P, 3:6], w[:P, 6], w[:P, 7], w[:P, 8] > 0.5, w[P, 0], w[P, 1]
