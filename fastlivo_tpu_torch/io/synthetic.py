"""Synthetic LIVO dataset generator.

The reference is validated exclusively by rosbag replay (SURVEY.md §4);
no bags ship in this container, so this module generates a physically
consistent substitute with exact ground truth: a box-room world with a
procedural texture, a smooth analytic trajectory (static warm-up for IMU
initialization, then sinusoidal translation + yaw), and sensor streams
derived from it:

  - IMU at `imu_hz`: gyro = body rates + bias + noise; accel = specific
    force R^T (a_world - g) + bias + noise  (the propagation convention
    of IMU_Processing.cpp:723: acc_world = R a + g with g ~ (0,0,-9.81)).
  - LiDAR at `lidar_hz`: points sampled on the room surfaces at each
    point's sample time using the true pose at that instant — so scans
    carry genuine motion distortion that the pipeline must undo.
  - Camera at `cam_hz` (optional): pinhole rendering of the textured
    room by ray casting, for VIO validation.

Everything is float64 on the host; consumers cast to f32 at the device
boundary.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

G = 9.81
G_W = np.array([0.0, 0.0, -G])


def _rx(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def _ry(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def _rz(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


@dataclasses.dataclass
class Trajectory:
    """Smooth analytic trajectory: static until t_static, then ramped
    sinusoidal translation and yaw."""

    t_static: float = 2.0
    ramp: float = 1.0
    amp: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.2, 0.9, 0.25])
    )
    freq: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.24, 0.31, 0.4])
    )
    yaw_rate: float = 0.25  # rad/s steady yaw sweep
    base_pos: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, 1.2])
    )

    def _s(self, t):
        """Motion ramp in [0,1], C2-smooth (smoothstep of degree 5)."""
        x = np.clip((t - self.t_static) / self.ramp, 0.0, 1.0)
        return x * x * x * (x * (x * 6 - 15) + 10)

    def pose(self, t: float) -> Tuple[np.ndarray, np.ndarray]:
        s = self._s(t)
        tt = t - self.t_static
        w = 2 * np.pi * self.freq
        pos = self.base_pos + s * self.amp * np.sin(w * tt)
        yaw = s * self.yaw_rate * tt
        pitch = 0.08 * s * np.sin(2 * np.pi * 0.17 * tt)
        roll = 0.06 * s * np.sin(2 * np.pi * 0.21 * tt + 1.0)
        rot = _rz(yaw) @ _ry(pitch) @ _rx(roll)
        return rot, pos

    def derivatives(self, t: float, h: float = 1e-4):
        """(rot, pos, vel, acc_world, omega_body) by central differences."""
        rot, pos = self.pose(t)
        rp, pp = self.pose(t + h)
        rm, pm = self.pose(t - h)
        vel = (pp - pm) / (2 * h)
        acc = (pp - 2 * pos + pm) / (h * h)
        dR = (rp - rm) / (2 * h)
        W = rot.T @ dR  # skew(omega_body)
        omega = np.array([W[2, 1], W[0, 2], W[1, 0]])
        return rot, pos, vel, acc, omega

    def imu_sample(self, t: float):
        rot, _, _, acc, omega = self.derivatives(t)
        f_body = rot.T @ (acc - G_W)  # specific force
        return f_body, omega


@dataclasses.dataclass
class BoxRoom:
    """Axis-aligned box interior [lo, hi]; surfaces carry a procedural
    texture for camera rendering."""

    lo: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([-6.0, -5.0, 0.0])
    )
    hi: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([6.0, 5.0, 3.2])
    )

    def sample_surface(self, n: int, rng: np.random.Generator) -> np.ndarray:
        """Uniform-ish points on the 6 faces."""
        ext = self.hi - self.lo
        areas = 2 * np.array(
            [ext[1] * ext[2], ext[0] * ext[2], ext[0] * ext[1]]
        )
        probs = np.repeat(areas / 2, 2) / areas.sum()
        face = rng.choice(6, size=n, p=probs)
        u = rng.uniform(size=(n, 2))
        pts = np.empty((n, 3))
        axis = face // 2
        side = face % 2
        for a in range(3):
            o = [i for i in range(3) if i != a]
            m = axis == a
            pts[m, a] = np.where(side[m] == 0, self.lo[a], self.hi[a])
            pts[m, o[0]] = self.lo[o[0]] + u[m, 0] * ext[o[0]]
            pts[m, o[1]] = self.lo[o[1]] + u[m, 1] * ext[o[1]]
        return pts

    def ray_hit(self, origin: np.ndarray, dirs: np.ndarray) -> np.ndarray:
        """Intersect rays (M,3) from `origin` with the box interior.
        Returns hit points (M,3); rays that miss get NaN."""
        with np.errstate(divide="ignore", invalid="ignore"):
            t_lo = (self.lo - origin) / dirs
            t_hi = (self.hi - origin) / dirs
        t_far = np.nanmin(np.maximum(t_lo, t_hi), axis=1)
        hits = origin + t_far[:, None] * dirs
        hits[t_far <= 1e-6] = np.nan
        return hits

    def texture(self, pts: np.ndarray) -> np.ndarray:
        """Procedural grayscale texture with rich gradients, sampled at
        world points (N,3) -> intensity [0,255]."""
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        v = (
            0.35 * np.sin(2.1 * x + 0.7) * np.cos(1.7 * y)
            + 0.25 * np.sin(3.3 * z + 1.3 * x)
            + 0.2 * np.sin(5.1 * y + 2.2 * z + 0.5)
            + 0.2 * np.sin(0.9 * (x + y + z))
        )
        return np.clip((v + 1.0) * 0.5, 0, 1) * 255.0


@dataclasses.dataclass
class SyntheticDataset:
    duration: float = 10.0
    imu_hz: float = 200.0
    lidar_hz: float = 10.0
    cam_hz: float = 0.0  # 0 disables images
    points_per_scan: int = 8192
    cam_size: Tuple[int, int] = (320, 256)  # (W, H)
    cam_f: float = 200.0
    # fy / principal point; None = fx / image center. run_synthetic
    # passes the CONFIG intrinsics — rendering with a centered pp while
    # the solver projects with the config's (cx, cy) put a constant
    # pixel offset between images and model (review r5)
    cam_fy: float | None = None
    cam_c: Tuple[float, float] | None = None
    cam_d: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(4)
    )  # radtan [k1, k2, p1, p2]; rendering honors it
    gyro_bias: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.002, -0.0015, 0.001])
    )
    acc_noise: float = 0.01
    gyro_noise: float = 0.001
    lidar_noise: float = 0.0
    seed: int = 0
    # lidar->IMU extrinsics (body = IMU frame)
    lid_rot: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(3))
    lid_off: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    # camera->lidar extrinsics: x_cam = Rcl x_lidar + Pcl
    Rcl: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(3))
    Pcl: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))

    def __post_init__(self):
        self.traj = Trajectory()
        self.room = BoxRoom()
        self.rng = np.random.default_rng(self.seed)

    # --- streams ---------------------------------------------------------
    def imu_stream(self):
        """[(t, acc(3,), gyr(3,)), ...] over the duration."""
        out = []
        n = int(self.duration * self.imu_hz)
        for i in range(n + 1):
            t = i / self.imu_hz
            f, w = self.traj.imu_sample(t)
            acc = f + self.rng.normal(0, self.acc_noise, 3)
            gyr = w + self.gyro_bias + self.rng.normal(0, self.gyro_noise, 3)
            out.append((t, acc, gyr))
        return out

    def lidar_pose(self, t: float):
        rot, pos = self.traj.pose(t)
        return rot @ self.lid_rot, rot @ self.lid_off + pos


    def lidar_scans_fast(self, pose_bins: int = 32):
        """Like lidar_scans but with pose interpolation on a per-scan time
        grid — O(bins) pose evaluations per scan instead of O(points)."""
        out = []
        period = 1.0 / self.lidar_hz
        n = int(self.duration * self.lidar_hz)
        for i in range(n):
            beg = i * period
            t_rel = np.sort(self.rng.uniform(0, period * 0.99, self.points_per_scan))
            w = self.room.sample_surface(self.points_per_scan, self.rng)
            bin_t = np.linspace(0, period * 0.99, pose_bins)
            idx = np.searchsorted(bin_t, t_rel, side="left").clip(0, pose_bins - 1)
            pts = np.empty_like(w)
            for b in range(pose_bins):
                m = idx == b
                if not np.any(m):
                    continue
                R_wl, t_wl = self.lidar_pose(beg + bin_t[b])
                pts[m] = (w[m] - t_wl) @ R_wl
            t_rel = bin_t[idx]  # points timestamped at their pose bin
            if self.lidar_noise:
                pts += self.rng.normal(0, self.lidar_noise, pts.shape)
            # 4th column: surface-texture reflectivity (real decoders emit
            # [x y z intensity]; feeds the LIO-mode PointXYZI cloud)
            inten = self.room.texture(w)[:, None]
            out.append((beg, np.concatenate([pts, inten], 1), t_rel))
        return out

    def cam_pose(self, t: float):
        """World-from-camera pose. x_cam = Rcl x_lidar + Pcl."""
        R_wl, t_wl = self.lidar_pose(t)
        R_wc = R_wl @ self.Rcl.T
        t_wc = t_wl - R_wc @ self.Pcl
        return R_wc, t_wc

    def _undistort_np(self, xd: np.ndarray, iters: int = 8) -> np.ndarray:
        """Numpy twin of camera.undistort (fixed-point radtan inverse)."""
        k1, k2, p1, p2 = self.cam_d
        xn = xd.copy()
        for _ in range(iters):
            x, y = xn[:, 0], xn[:, 1]
            r2 = x * x + y * y
            radial = 1.0 + k1 * r2 + k2 * r2 * r2
            dx = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x) - x
            dy = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y - y
            xn = xd - np.stack([dx, dy], -1)
        return xn

    def render_image(self, t: float) -> np.ndarray:
        """Ray-cast grayscale image (H, W) uint8 at time t. When cam_d is
        nonzero the rendered image matches the distorted pinhole model
        (each pixel's ray comes from the undistorted normalized coords)."""
        W, H = self.cam_size
        f = self.cam_f
        fy = self.cam_f if self.cam_fy is None else self.cam_fy
        cx, cy = (self.cam_c if self.cam_c is not None
                  else ((W - 1) / 2.0, (H - 1) / 2.0))
        u, v = np.meshgrid(np.arange(W), np.arange(H))
        xd = np.stack([(u - cx) / f, (v - cy) / fy], -1).reshape(-1, 2)
        if np.any(np.abs(self.cam_d) > 1e-12):
            xn = self._undistort_np(xd)
        else:
            xn = xd
        d_cam = np.concatenate([xn, np.ones((len(xn), 1))], -1)
        R_wc, t_wc = self.cam_pose(t)
        d_w = d_cam @ R_wc.T
        hits = self.room.ray_hit(t_wc, d_w)
        tex = self.room.texture(np.nan_to_num(hits))
        tex[np.isnan(hits[:, 0])] = 0
        return tex.reshape(H, W).astype(np.uint8)

    def images(self):
        if self.cam_hz <= 0:
            return []
        out = []
        n = int(self.duration * self.cam_hz)
        for i in range(n):
            t = (i + 0.35) / self.cam_hz  # offset from scan boundaries
            out.append((t, self.render_image(t)))
        return out

    def ground_truth(self, times) -> np.ndarray:
        """(T, 7): pos (3) + quaternion wxyz (4) of the IMU body."""
        rows = []
        for t in times:
            rot, pos = self.traj.pose(t)
            q = _rot_to_quat(rot)
            rows.append(np.concatenate([pos, q]))
        return np.asarray(rows)


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """[w, x, y, z] — delegates to the shared logging_util converter
    (was a third parallel implementation; review r5)."""
    from ..logging_util import rot_to_quat_wxyz

    return rot_to_quat_wxyz(np.asarray(R, np.float64))
