"""Reader for the reference's logged state traces (golden data).

The reference writes its filter logs into a `Log/` directory
(laserMapping.cpp:1449-1453 pre-update and :1810-1815 post-update, and
IMU_Processing.cpp:681 per IMU pair); the port's `--log-dir` writes the
same files (logging_util.TraceLogger):

  - ``mat_pre.txt``  — per frame, 19 cols: t, euler*57.3 (3), pos (3),
    vel (3), bias_g (3), bias_a (3), gravity (3); state *before* the
    EKF update, i.e. the IMU-propagated prior at the group end time.
  - ``mat_out.txt``  — same + trailing feats_undistort count (20 cols);
    state *after* the update.
  - ``imu.txt``      — per used propagation pair, 7 cols: head stamp
    relative to first_lidar_time, pairwise-averaged gyro (3), pairwise-
    averaged accel (3) — logged BEFORE bias subtraction and gravity
    scaling (IMU_Processing.cpp:670-681).

Euler convention: RotMtoEuler (so3_math.h:83-103) factors R = Rz*Ry*Rx
and the logger multiplies by the literal 57.3 (NOT 180/pi)
(laserMapping.cpp:1449 ``euler_cur.transpose()*57.3``).

Port of the JAX package's io/golden.py. `available` and `load` take the
log directory as an argument: there is no default location.
"""
from __future__ import annotations

from pathlib import Path
from typing import NamedTuple

import numpy as np

EULER_SCALE = 57.3  # the reference's literal deg factor, laserMapping.cpp:1449


class GoldenTraces(NamedTuple):
    pre_t: np.ndarray  # (K,) group-end time rel. first_lidar_time
    pre_rot: np.ndarray  # (K, 3, 3)
    pre_state: np.ndarray  # (K, 15): pos, vel, bg, ba, grav
    out_t: np.ndarray  # (K,)
    out_rot: np.ndarray  # (K, 3, 3)
    out_state: np.ndarray  # (K, 15)
    out_npts: np.ndarray  # (K,) feats_undistort count (0 on VIO frames)
    imu_head: np.ndarray  # (M,) pair head stamp rel. first_lidar_time
    imu_gyr: np.ndarray  # (M, 3) raw pairwise-averaged gyro
    imu_acc: np.ndarray  # (M, 3) raw pairwise-averaged accel


def euler_to_rot(e_scaled: np.ndarray) -> np.ndarray:
    """Invert the logged euler*57.3 back to a rotation matrix.

    R = Rz(z) Ry(y) Rx(x) — the factorization RotMtoEuler extracts
    (so3_math.h:89-93: x from R32/R33, y from -R31, z from R21/R11).
    Batched: e_scaled (..., 3) -> (..., 3, 3).
    """
    e = np.asarray(e_scaled, dtype=np.float64) / EULER_SCALE
    x, y, z = e[..., 0], e[..., 1], e[..., 2]
    cx, sx = np.cos(x), np.sin(x)
    cy, sy = np.cos(y), np.sin(y)
    cz, sz = np.cos(z), np.sin(z)
    R = np.empty(e.shape[:-1] + (3, 3), dtype=np.float64)
    R[..., 0, 0] = cz * cy
    R[..., 0, 1] = cz * sy * sx - sz * cx
    R[..., 0, 2] = cz * sy * cx + sz * sx
    R[..., 1, 0] = sz * cy
    R[..., 1, 1] = sz * sy * sx + cz * cx
    R[..., 1, 2] = sz * sy * cx - cz * sx
    R[..., 2, 0] = -sy
    R[..., 2, 1] = cy * sx
    R[..., 2, 2] = cy * cx
    return R


def rot_to_euler(R: np.ndarray) -> np.ndarray:
    """RotMtoEuler equivalent (so3_math.h:83-103), batched, unscaled (rad)."""
    R = np.asarray(R, dtype=np.float64)
    sy = np.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    singular = sy < 1e-6
    x = np.where(
        singular,
        np.arctan2(-R[..., 1, 2], R[..., 1, 1]),
        np.arctan2(R[..., 2, 1], R[..., 2, 2]),
    )
    y = np.arctan2(-R[..., 2, 0], sy)
    z = np.where(singular, 0.0, np.arctan2(R[..., 1, 0], R[..., 0, 0]))
    return np.stack([x, y, z], axis=-1)


def available(log_dir: str | Path) -> bool:
    log_dir = Path(log_dir)
    return (
        (log_dir / "mat_pre.txt").exists()
        and (log_dir / "mat_out.txt").exists()
        and (log_dir / "imu.txt").exists()
    )


def load(log_dir: str | Path) -> GoldenTraces:
    log_dir = Path(log_dir)
    pre = np.loadtxt(log_dir / "mat_pre.txt", dtype=np.float64, ndmin=2)
    out = np.loadtxt(log_dir / "mat_out.txt", dtype=np.float64, ndmin=2)
    imu = np.loadtxt(log_dir / "imu.txt", dtype=np.float64, ndmin=2)
    if pre.shape[1] != 19 or out.shape[1] != 20 or imu.shape[1] != 7:
        raise ValueError(
            f"unexpected trace shapes: pre {pre.shape}, out {out.shape}, imu {imu.shape}"
        )
    return GoldenTraces(
        pre_t=pre[:, 0],
        pre_rot=euler_to_rot(pre[:, 1:4]),
        pre_state=pre[:, 4:19],
        out_t=out[:, 0],
        out_rot=euler_to_rot(out[:, 1:4]),
        out_state=out[:, 4:19],
        out_npts=out[:, 19],
        imu_head=imu[:, 0],
        imu_gyr=imu[:, 1:4],
        imu_acc=imu[:, 4:7],
    )


def estimate_acc_scale(tr: GoldenTraces, n: int = 200) -> float:
    """Estimate the reference's G/|mean_acc| accelerometer normalization
    (IMU_Processing.cpp:685). |mean_acc| is internal to its init phase
    (which pre-dates imu.txt), so recover it from the mean accel norm of
    the first `n` logged pairs — the rig is static at start, so those
    average to the same |mean_acc| up to sensor noise / n**0.5."""
    norms = np.linalg.norm(tr.imu_acc[:n], axis=1)
    return 9.81 / float(norms.mean())


def frame_pairs(tr: GoldenTraces, k: int):
    """IMU pairs the reference integrated for frame k (k >= 1).

    Pair i covers [head[i], head[i+1]] (tails are the next head: the
    reference chains pairs over consecutive samples and re-prepends the
    last sample of a group to the next, IMU_Processing.cpp:618).
    A pair belongs to frame k when its tail is in (t_{k-1}, t_k]
    (pairs whose tail predates the previous group end are skipped,
    :668; group samples are bounded by the group end time,
    laserMapping.cpp:566-573).

    Returns (heads, tails, gyr, acc) for the frame, possibly empty.
    """
    t_prev, t_k = tr.out_t[k - 1], tr.pre_t[k]
    tails = np.append(tr.imu_head[1:], np.inf)
    m = (tails > t_prev + 1e-9) & (tails <= t_k + 1e-9)
    return tr.imu_head[m], tails[m], tr.imu_gyr[m], tr.imu_acc[m]
