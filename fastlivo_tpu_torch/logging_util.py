"""State-trace logging and trajectory export (the Log/ subsystem).

Mirrors the reference's observability surface (SURVEY.md §5):
  - `TraceLogger` writes `mat_pre.txt` / `mat_out.txt` rows — time,
    euler(deg), position, velocity, gyro bias, accel bias, gravity —
    exactly the columns `fout_pre`/`fout_out` emit
    (reference: src/laserMapping.cpp:1449-1453, 1810-1815), and an
    `imu.txt` stream (IMU_Processing.cpp:681), so the reference's
    `Log/plot.py` workflow applies unchanged.
  - `write_tum` exports `t x y z qx qy qz qw` rows
    (laserMapping.cpp:1738-1748) for evo-style ATE evaluation.
  - `plot_traces` renders the pre/post overlay plots (Log/plot.py:7-46)
    when matplotlib is importable.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np


EULER_SCALE = 57.3  # the reference's literal deg factor, laserMapping.cpp:1449


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


def _euler_deg(R: np.ndarray) -> np.ndarray:
    """RotMtoEuler (so3_math.h:83-103) scaled by the reference's literal
    57.3 (laserMapping.cpp:1449 writes euler*57.3, NOT 180/pi) so our
    Log/ files are bit-compatible with its plot/eval tooling."""
    return rot_to_euler(np.asarray(R, np.float64)[None])[0] * EULER_SCALE


def rot_to_quat_wxyz(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion [w, x, y, z] (the FrameOutput /
    odometry convention). One shared host-side implementation — the
    runtime used to import a private twin from io/synthetic (review
    r5: three parallel converters)."""
    x, y, z, w = rot_to_quat_xyzw(R)
    return np.array([w, x, y, z])


def rot_to_quat_xyzw(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> quaternion [x, y, z, w] (Eigen::Quaterniond
    constructor convention used by the fout_tum writer,
    laserMapping.cpp:1740-1746)."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 0.0)) * 2
        q = np.zeros(3)
        q[i] = 0.25 * s
        q[j] = (R[j, i] + R[i, j]) / s
        q[k] = (R[k, i] + R[i, k]) / s
        w = (R[k, j] - R[j, k]) / s
        x, y, z = q
    return np.array([x, y, z, w])


class TraceLogger:
    def __init__(self, log_dir: str | Path):
        self.dir = Path(log_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._pre = open(self.dir / "mat_pre.txt", "w")
        self._out = open(self.dir / "mat_out.txt", "w")
        self._imu = open(self.dir / "imu.txt", "w")
        self._tum = None  # camera_pose.txt, opened on first use

    def _row(self, f, t, state, extra=()):
        # `state` is either a NavState or the packed 24-vector from
        # state.pack24_host (one transfer instead of six per row)
        if isinstance(state, np.ndarray):
            R = state[0:9].reshape(3, 3)
            rest = state[9:24]
        else:
            R = np.asarray(state.rot, np.float64)
            rest = np.concatenate(
                [
                    np.asarray(state.pos, np.float64),
                    np.asarray(state.vel, np.float64),
                    np.asarray(state.bg, np.float64),
                    np.asarray(state.ba, np.float64),
                    np.asarray(state.grav, np.float64),
                ]
            )
        row = np.concatenate([_euler_deg(R), rest, extra])
        f.write("%20.8f " % t + " ".join("%.8f" % v for v in row) + "\n")

    def log_pre(self, t, state):
        self._row(self._pre, t, state)

    def log_post(self, t, state, n_points: int = 0):
        """mat_out row: the 19 state columns plus the reference's
        trailing feats_undistort count (laserMapping.cpp:1810-1815
        appends `feats_undistort->points.size()` — the golden reader
        requires the 20-column shape)."""
        self._row(self._out, t, state, extra=[float(n_points)])

    def log_imu(self, t, acc, gyr):
        vals = list(np.asarray(gyr, np.float64)) + list(np.asarray(acc, np.float64))
        self._imu.write("%.8f " % t + " ".join("%.6f" % v for v in vals) + "\n")

    def log_pos(self, t: float, state):
        """pos_log.txt row (dump_lio_state_to_log, laserMapping.cpp:
        226-256: t, SO3-log angle, pos, omega=0, vel, acc=0, bg, ba,
        gravity — 25 columns (t + 8 groups of 3); the reference's call site is commented out
        but the format is part of its Log/ surface)."""
        if not hasattr(self, "_pos") or self._pos is None:
            self._pos = open(self.dir / "pos_log.txt", "w")
        if isinstance(state, np.ndarray):  # packed 24-vector (pack24_host)
            R = state[0:9].reshape(3, 3)
            pos, vel = state[9:12], state[12:15]
            bg, ba, grav = state[15:18], state[18:21], state[21:24]
        else:
            R = np.asarray(state.rot, np.float64)
            pos = np.asarray(state.pos, np.float64)
            vel = np.asarray(state.vel, np.float64)
            bg = np.asarray(state.bg, np.float64)
            ba = np.asarray(state.ba, np.float64)
            grav = np.asarray(state.grav, np.float64)
        # matrix log (so3): theta * axis
        cs = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
        th = np.arccos(cs)
        if th < 1e-9:
            ang = np.zeros(3)
        else:
            w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                          R[1, 0] - R[0, 1]]) / (2.0 * np.sin(th))
            ang = th * w
        z = np.zeros(3)
        row = np.concatenate([ang, pos, z, vel, z, bg, ba, grav])
        self._pos.write("%f " % t + " ".join("%f" % v for v in row) + "\n")

    def log_camera_pose(self, t: float, rcw: np.ndarray, pcw: np.ndarray):
        """camera_pose.txt row under pose_output_en
        (laserMapping.cpp:1738-1748): scan begin time, then the
        world->camera transform T_f_w_ — translation and quaternion
        x y z w — at fixed 6-decimal precision."""
        if self._tum is None:
            self._tum = open(self.dir / "camera_pose.txt", "w")
        q = rot_to_quat_xyzw(rcw)
        vals = [t] + list(np.asarray(pcw, np.float64)) + list(q)
        self._tum.write(" ".join("%.6f" % v for v in vals) + "\n")

    def close(self):
        for f in (self._pre, self._out, self._imu, self._tum,
                  getattr(self, "_pos", None)):
            if f is not None:
                f.close()


def write_tum(path: str | Path, rows: np.ndarray):
    """rows: (T, 8) [t x y z qx qy qz qw]."""
    with open(path, "w") as f:
        for r in np.asarray(rows):
            f.write(" ".join("%.9f" % v for v in r) + "\n")


def load_tum(path: str | Path) -> np.ndarray:
    return np.loadtxt(path, ndmin=2).reshape(-1, 8)


def ate_rmse(est: np.ndarray, gt: np.ndarray, assoc_tol: float = 0.02):
    """Absolute trajectory error (translation RMSE) after timestamp
    association and SE(3)-free comparison (frames already share origin)."""
    errs = []
    gt_t = gt[:, 0]
    for r in est:
        i = np.argmin(np.abs(gt_t - r[0]))
        if abs(gt_t[i] - r[0]) <= assoc_tol:
            errs.append(np.linalg.norm(r[1:4] - gt[i, 1:4]))
    if not errs:
        return np.nan
    return float(np.sqrt(np.mean(np.square(errs))))


def plot_traces(log_dir: str | Path, out_png: Optional[str | Path] = None):
    """The Log/plot.py overlay (reference plot.py:7-28): pre vs post
    attitude / position / velocity / biases / gravity."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = Path(log_dir)
    pre = np.loadtxt(d / "mat_pre.txt", ndmin=2)
    post = np.loadtxt(d / "mat_out.txt", ndmin=2)
    lab = ["att(deg)", "pos(m)", "vel(m/s)", "bg", "ba", "grav"]
    fig, axs = plt.subplots(3, 2, figsize=(14, 10))
    for blk in range(6):
        ax = axs[blk // 2][blk % 2]
        for j in range(3):
            c = 1 + blk * 3 + j
            ax.plot(pre[:, 0], pre[:, c], "--", lw=0.8)
            ax.plot(post[:, 0], post[:, c], lw=0.8)
        ax.set_title(lab[blk])
        ax.grid(True)
    fig.tight_layout()
    out = out_png or (d / "traces.png")
    fig.savefig(out, dpi=110)
    plt.close(fig)
    return out


def ate_rmse_aligned(est: np.ndarray, gt: np.ndarray,
                     assoc_tol: float = 0.02):
    """evo-style ATE: associate by timestamp, rigidly align (Umeyama,
    rotation+translation, no scale), then translation RMSE — the metric
    the reference's TUM exports are evaluated with externally
    (README.md's evo workflow over Log/camera_pose.txt)."""
    pairs_e, pairs_g = [], []
    gt_t = gt[:, 0]
    for r in np.asarray(est):
        i = np.argmin(np.abs(gt_t - r[0]))
        if abs(gt_t[i] - r[0]) <= assoc_tol:
            pairs_e.append(r[1:4])
            pairs_g.append(gt[i, 1:4])
    if len(pairs_e) < 3:
        return np.nan
    E = np.asarray(pairs_e)
    G = np.asarray(pairs_g)
    mu_e, mu_g = E.mean(0), G.mean(0)
    H = (E - mu_e).T @ (G - mu_g) / len(E)
    U, _, Vt = np.linalg.svd(H)
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1.0
    R = Vt.T @ S @ U.T  # gt <- est rotation
    t = mu_g - R @ mu_e
    errs = np.linalg.norm((E @ R.T + t) - G, axis=1)
    return float(np.sqrt(np.mean(errs ** 2)))
