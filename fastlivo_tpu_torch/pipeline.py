"""Per-frame orchestration of the LiDAR-inertial path.

Port of the LIO path of the JAX package's pipeline.py (the reference's
node loop, src/laserMapping.cpp:1260-1818), on the tiled map backend.

Frame protocol per measurement group (sync.py):
  - IMU-init phase: accumulate static samples (IMU_init,
    IMU_Processing.cpp:137-182); groups are consumed without estimation.
  - lidar-end group: propagate to scan end, motion-compensate the scan
    with the merged per-scan pose table, slide the local map
    (lasermap_fov_segment :363-421), voxel-downsample, run the LIO
    iterated EKF (:1506-1732) once `flg_EKF_inited` (0.5 s after
    `first_lidar_time`, :79,1317), then insert the scan into the map
    (map_incremental :692-706).

The steady-state frame is `frame_step.lidar_frame_step` with one
device-to-host read of its packed stats row. The first frames (map
bootstrap and the pre-EKF warm-up) take the staged path with the host
voxel filter.

Not ported yet, and refused by the constructor: the camera frame
(`img_enable`), the dense and hash map backends, `plane_fit: ref` and
`cache_knn`. Deferred readback, block replay, trace logging,
visualisation and staged profiling are absent.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from . import imu as imu_mod
from . import lio as lio_mod
from .config import Config
from .device import resolve_device
from .frame_step import lidar_frame_step, stage_scan
from .logging_util import rot_to_quat_wxyz
from .ops import tiled_map as tmod
from .ops.voxel_filter import voxel_downsample
from .state import NavState, identity_state, pack24
from .sync import MeasureGroup, Synchronizer

INIT_TIME = 0.5  # seconds before the EKF activates (laserMapping.cpp:79)
REBUILD_CHECK_EVERY = 32  # frames between map load-factor checks


@dataclasses.dataclass
class FrameOutput:
    t: float  # scan end time (odometry stamp)
    pos: np.ndarray  # (3,)
    quat: np.ndarray  # (4,) [w, x, y, z]
    vel: np.ndarray  # (3,)
    n_active: int
    iters: int
    n_points: int
    timing: dict
    # posterior point-to-plane residual RMS over active rows; 0 during
    # warm-up
    res_rms: float = 0.0
    pts_world: Optional[np.ndarray] = None  # dense undistorted world cloud
    intensity: Optional[np.ndarray] = None  # per-point, aligned with pts_world


class Pipeline:
    def __init__(self, cfg: Config, device=None):
        """`device`: where the state, the map and every kernel live;
        CUDA unless the caller passes "cpu" (see device.py)."""
        cap = cfg.capacity
        if cfg.img_enable:
            raise NotImplementedError(
                "the camera frame is not ported yet (ROADMAP Queue 1 item 8); "
                "set img_enable = False")
        lio_mod.check_supported(cap.map_backend, cap.plane_fit, cap.cache_knn)
        self.cfg = cfg
        self.device = resolve_device(device)
        dev = self.device
        # merged per-scan pose-table capacity: one segment per
        # measurement group, each bounded by max_imu_per_group rows plus
        # its start row
        self.max_scan_poses = max(8 * (cap.max_imu_per_group + 1), 128)
        self._decimation_warned = False
        self.sync = Synchronizer(img_enable=False)
        self.initializer = imu_mod.ImuInitializer()
        self.init_done = False
        self.calib: Optional[imu_mod.ImuCalib] = None
        self.state: NavState = identity_state(dev)
        self.map = self._make_map()
        self.map_built = False
        self._rms_high_streak = 0
        self.auto_resets = 0  # divergence-watchdog restart count
        self._frames_since_rebuild_check = 0
        self._fss_dev = torch.tensor(cfg.filter_size_surf, dtype=torch.float32,
                                     device=dev)
        # grow-only pow2 shape buckets (see _stage_scan / _propagate);
        # the scan bucket also fixes the EKF batch size, so it is kept
        # for equal outputs
        self._scan_bucket = 0
        self._imu_bucket = 0
        self.tracker = lio_mod.LocalMapTracker(cfg.cube_side_length,
                                               mode=cap.slider)
        self.first_lidar_time: Optional[float] = None
        self.last_imu: Optional[tuple] = None  # (t, acc, gyr)
        self.last_group_end: Optional[float] = None
        self.acc_s_last = torch.zeros(3, dtype=torch.float32, device=dev)
        self.angvel_last = torch.zeros(3, dtype=torch.float32, device=dev)
        # per-scan pose-table segments: (device pose pack, host kept-row
        # indices) per consumed group, merged on the device per scan
        self._scan_tables: List[tuple] = []
        self._scan_id = None
        self.outputs: List[FrameOutput] = []
        self.on_frame = None  # per-frame callback, called with each FrameOutput
        # host pack24 of the previous frame's posterior (from the frame's
        # stats read); feeds the local-map slider
        self._last_post = None
        # host copy of the map occupancy from the last stats row (None
        # until a fused frame resolves, or after a compaction)
        self._map_occ_host: Optional[float] = None
        self.trajectory: List[np.ndarray] = []  # TUM rows
        self.last_effect = None  # (down_pts, active_mask) of the last frame
        # library consumers that read outputs[i].pts_world (the dense
        # world cloud of each frame) set this
        self.materialize_dense = False
        # eval runs: collect the per-frame posterior covariance (NEES)
        self.collect_cov = False
        self.covs: List[np.ndarray] = []

    def _make_map(self) -> tmod.TiledMap:
        cap = self.cfg.capacity
        return tmod.empty_tiled_map(cap.tiled_dir_dims, cap.tiled_pool,
                                    self.cfg.filter_size_map,
                                    device=self.device)

    # --- ingestion passthrough ------------------------------------------
    def push_lidar(self, stamp, pts, t_rel):
        self.sync.push_lidar(stamp, pts, t_rel)

    def push_imu(self, stamp, acc, gyr):
        self.sync.push_imu(stamp, acc, gyr)

    def spin(self) -> List[FrameOutput]:
        """Process every ready measurement group; returns new outputs."""
        n0 = len(self.outputs)
        if self.sync.reset_flagged:
            self._reset_imu()
            self.sync.reset_flagged = False
        for g in self.sync.drain():
            self._process_group(g)
        return self.outputs[n0:]

    def _reset_imu(self):
        """Loop-back recovery (laserMapping.cpp:1273-1279 +
        ImuProcess::Reset, IMU_Processing.cpp:31-44): a sensor-timestamp
        regression cleared the sync buffers; restart IMU initialization
        and drop the propagation context. The state itself is kept."""
        warnings.warn("sensor loop-back detected: resetting IMU processor",
                      RuntimeWarning)
        dev = self.device
        self.initializer = imu_mod.ImuInitializer()
        self.init_done = False
        self.calib = None
        self.last_imu = None
        self.last_group_end = None
        self.acc_s_last = torch.zeros(3, dtype=torch.float32, device=dev)
        self.angvel_last = torch.zeros(3, dtype=torch.float32, device=dev)
        self._scan_tables = []
        self._scan_id = None
        self.sync.reset_open_scan()

    # --- internals -------------------------------------------------------
    def _feed_initializer(self, g: MeasureGroup):
        for i in range(len(g.imu_t)):
            self.initializer.push(g.imu_acc[i], g.imu_gyr[i])
        if len(g.imu_t):
            self.last_imu = (g.imu_t[-1], g.imu_acc[-1], g.imu_gyr[-1])
        if self.initializer.done:
            cfg = self.cfg
            dev = self.device
            self.calib = self.initializer.calib(
                cfg.mapping.acc_cov_scale, cfg.mapping.gyr_cov_scale,
                cfg.extrinsic_R, cfg.extrinsic_T, device=dev,
            )
            f64 = dict(dtype=torch.float64, device=dev)
            self.state = self.state._replace(
                grav=torch.as_tensor(self.initializer.gravity(), **f64),
                bg=torch.as_tensor(self.initializer.mean_gyr, **f64),
                rot=torch.eye(3, **f64),
            )
            self.init_done = True
            self.last_group_end = g.scan.beg_time if g.scan else float(g.imu_t[-1])

    def _propagate(self, g: MeasureGroup, end_time: float):
        """Propagate state+cov over the group's IMU block; stash the pose
        segment for scan-end undistortion."""
        scan = g.scan
        cap = self.cfg.capacity.max_imu_per_group
        # prepend the previous group's last sample (IMU_Processing.cpp:618)
        if self.last_imu is not None:
            imu_t = np.concatenate([[self.last_imu[0]], g.imu_t])
            imu_acc = np.concatenate([[self.last_imu[1]], g.imu_acc])
            imu_gyr = np.concatenate([[self.last_imu[2]], g.imu_gyr])
        else:
            imu_t, imu_acc, imu_gyr = g.imu_t, g.imu_acc, g.imu_gyr
        if len(g.imu_t):
            self.last_imu = (g.imu_t[-1], g.imu_acc[-1], g.imu_gyr[-1])

        if self.last_group_end is None:
            self.last_group_end = (scan.beg_time if scan is not None
                                   else float(imu_t[0]))
        acc_avg, gyr_avg, dt, offs, valid, tail_dt, row0_off = imu_mod.prepare_pairs(
            imu_t, imu_acc, imu_gyr,
            beg_time=scan.beg_time,
            end_time=end_time,
            last_end_time=self.last_group_end,
            max_pairs=cap,
        )
        # pow2 bucket of the group's live pair count, grow-only
        n_rows = max(len(imu_t) - 1, 0)
        B = min(cap, 1 << max(3, int(max(n_rows - 1, 1)).bit_length()))
        B = max(B, self._imu_bucket)
        self._imu_bucket = B
        wire = imu_mod.pack_pairs_wire(
            acc_avg[:B], gyr_avg[:B], dt[:B], offs[:B], valid[:B],
            tail_dt, row0_off
        )
        st, pose_pack, self.acc_s_last, self.angvel_last = imu_mod.propagate_wire(
            self.state, torch.as_tensor(wire, device=self.device),
            self.acc_s_last, self.angvel_last, self.calib,
        )
        self.state = st
        self.last_group_end = end_time
        # kept rows: row0 + the valid pairs (host-known, no device read)
        keep = np.concatenate([[True], valid[:B]])
        self._scan_tables.append(
            (pose_pack, np.nonzero(keep)[0].astype(np.int32)))

    def _merged_pose_table(self) -> imu_mod.PoseTable:
        """Per-scan pose table merged on the device from the groups' pose
        packs; the host only builds the gather plan."""
        segs = self._scan_tables
        flat, off = [], 0
        for pack, idx in segs:
            flat.append(idx + off)
            off += pack.shape[0] - 1  # base rows (last row = state pack)
        flat = np.concatenate(flat)
        M = self.max_scan_poses
        if len(flat) > M:
            raise ValueError(f"scan pose table overflow: {len(flat)} > {M}")
        K = len(flat)
        idx_p = np.full(M, flat[-1], np.int64)
        idx_p[:K] = flat
        valid = np.zeros(M, bool)
        valid[:K] = True
        dev = self.device
        return imu_mod.merge_pose_packs(
            [p for p, _ in segs], torch.as_tensor(idx_p, device=dev),
            torch.as_tensor(valid, device=dev), m_out=M,
        )

    def _process_group(self, g: MeasureGroup) -> Optional[FrameOutput]:
        if self.cfg.debug:
            g.debug_show()  # laserMapping.cpp:1295-1298
        scan = g.scan
        if scan is not None and self._scan_id is not scan:
            self._scan_id = scan
            self._scan_tables = []

        if not self.init_done:
            self._feed_initializer(g)
            if scan is not None:
                self.first_lidar_time = scan.beg_time
            return None

        t0 = time.perf_counter()
        with record_function("frame.propagate"):
            self._propagate(g, scan.end_time)

        # ---- lidar-end frame: undistort the whole scan ------------------
        with record_function("frame.pose_table"):
            pose_table = self._merged_pose_table()
        cap = self.cfg.capacity
        N = len(scan.pts)
        rawcap = cap.max_raw_points
        if N > rawcap:
            stride = -(-N // rawcap)
            if not self._decimation_warned:
                self._decimation_warned = True
                warnings.warn(
                    f"raw scan of {N} points exceeds capacity.max_raw_points="
                    f"{rawcap}; stride-decimating by {stride} (coverage loss)."
                    " Raise the capacity to keep full scans.",
                    RuntimeWarning,
                )
            sel = slice(0, N, stride)
            pts_np = scan.pts[sel, :3]
            t_rel_np = scan.t_rel[sel]
            N = len(pts_np)
            inten_np = scan.pts[sel, 3] if scan.pts.shape[1] > 3 else None
        else:
            pts_np, t_rel_np = scan.pts[:, :3], scan.t_rel
            inten_np = scan.pts[:, 3] if scan.pts.shape[1] > 3 else None
        ekf_inited = (
            self.first_lidar_time is not None
            and scan.beg_time - self.first_lidar_time >= INIT_TIME
        )

        # ---- sliding local map (lasermap_fov_segment) -------------------
        # slides on the previous frame's posterior (already on the host)
        # instead of the predicted position: one frame of motion against
        # a margin of hundreds of metres
        pos_np = (self._last_post[9:12] if self._last_post is not None
                  else self.state.pos.cpu().numpy())
        boxes = self.tracker.update(pos_np)
        if boxes and self.map_built:
            dev = self.device
            lo = torch.as_tensor(np.asarray([b[0] for b in boxes], np.float32),
                                 device=dev)
            hi = torch.as_tensor(np.asarray([b[1] for b in boxes], np.float32),
                                 device=dev)
            with record_function("frame.delete_boxes"):
                self.map = tmod.delete_boxes(self.map, lo, hi)
        self._maybe_rebuild()

        fused = self.map_built and ekf_inited and self.cfg.lidar_enable
        dense_world = None
        if fused:
            # ---- steady state: the frame step, one stats read ----------
            pts_j, trel_j, pmask_j, B = self._stage_scan(pts_np, t_rel_np, N)
            (st, m2, down_j, dmask_j, _n_act, _iters,
             dense_j, active_j, stats_j) = lidar_frame_step(
                self.state, self.map, pose_table, self.calib,
                pts_j, trel_j, pmask_j, self._fss_dev,
                laser_point_cov=float(self.cfg.laser_point_cov),
                # the downsample output never exceeds the live input
                # count, so the EKF batch shrinks with the bucket
                max_points=min(cap.max_points, B),
                max_iter=self.cfg.max_iteration,
                knn_radius=cap.knn_voxel_radius,
                dense_out=self.cfg.dense_map_enable,
            )
            self.state = st
            self.map = m2
            with record_function("frame.stats_read"):
                stats = stats_j.cpu().numpy()
            n_down, n_active, iters = int(stats[0]), int(stats[1]), int(stats[2])
            post_pack = stats[3:27]
            res_rms = float(stats[27])
            self._map_occ_host = float(stats[28])
            if self.cfg.dense_map_enable:
                need_dense = (self.cfg.pcd_save_en or self.on_frame is not None
                              or self.materialize_dense)
                dense_world = dense_j[:N].cpu().numpy() if need_dense else None
            self.last_effect = (down_j, active_j)
            t_undistort = t_down = t0
            t_ekf = t_map = time.perf_counter()
        else:
            # ---- bootstrap path (first frames): staged -----------------
            buf, trel, pmask = self._pad_scan_np(pts_np, t_rel_np, N)
            dev = self.device
            und = imu_mod.undistort(
                self.state, pose_table, torch.as_tensor(buf, device=dev),
                torch.as_tensor(trel, device=dev),
                torch.as_tensor(pmask, device=dev), self.calib,
            )
            feats_undistort = und.cpu().numpy()[:N]
            t_undistort = time.perf_counter()
            down, dmask = voxel_downsample(
                feats_undistort, self.cfg.filter_size_surf,
                max_out=cap.max_points,
            )
            n_down = int(dmask.sum())
            t_down = time.perf_counter()

            # first frame: build the map and return (laserMapping.cpp:1411)
            if not self.map_built:
                if n_down > 5:
                    world = self._to_world(down)
                    self.map = tmod.insert(self.map, world,
                                           torch.as_tensor(dmask, device=dev))
                    self.map_built = True
                return None

            iters = 0
            n_active = 0
            t_ekf = time.perf_counter()
            world = self._to_world(down)
            self.map = tmod.insert(self.map, world,
                                   torch.as_tensor(dmask, device=dev))
            t_map = time.perf_counter()
            if self.cfg.dense_map_enable:
                rot_tmp = self.state.rot.cpu().numpy()
                pos_tmp = self.state.pos.cpu().numpy()
                R_wl = rot_tmp @ self.cfg.extrinsic_R
                t_wl = rot_tmp @ self.cfg.extrinsic_T + pos_tmp
                dense_world = feats_undistort @ R_wl.T + t_wl
            post_pack = pack24(self.state).cpu().numpy()
            res_rms = 0.0  # no EKF residuals before warm-up completes

        return self._emit_output(
            scan=scan, post_pack=post_pack, n_down=n_down,
            n_active=n_active, iters=iters, res_rms=res_rms,
            dense_world=dense_world, inten_np=inten_np,
            timing={
                "undistort": t_undistort - t0,
                "downsample": t_down - t_undistort,
                "ekf": t_ekf - t_down,
                "map": t_map - t_ekf,
                "total": t_map - t0,
            },
        )

    def _emit_output(self, *, scan, post_pack, n_down, n_active, iters,
                     res_rms, dense_world, inten_np, timing) -> FrameOutput:
        """Host-side frame finalization: FrameOutput, hooks, trajectory
        and the divergence watchdog."""
        self._last_post = post_pack  # feeds next frame's map slider
        rot_np = np.array(post_pack[0:9]).reshape(3, 3)
        pos_np = np.array(post_pack[9:12])
        quat = rot_to_quat_wxyz(rot_np)
        out = FrameOutput(
            t=scan.end_time,
            pos=pos_np,
            quat=quat,
            vel=np.array(post_pack[12:15]),
            n_active=n_active,
            iters=iters,
            n_points=n_down,
            res_rms=res_rms,
            timing=timing,
        )
        if self.cfg.dense_map_enable and dense_world is not None:
            out.pts_world = dense_world
            if inten_np is not None:
                out.intensity = np.asarray(inten_np[: len(dense_world)],
                                           np.float32)
        if self.collect_cov:
            self.covs.append(self.state.cov.cpu().numpy())
        self.outputs.append(out)
        if self.on_frame is not None:
            self.on_frame(out)
        self.trajectory.append(
            np.array([out.t, *pos_np, quat[1], quat[2], quat[3], quat[0]]))
        # divergence watchdog (capacity.auto_reset_rms)
        thr = self.cfg.capacity.auto_reset_rms
        if thr > 0.0 and res_rms > 0.0:
            if res_rms > thr:
                self._rms_high_streak += 1
                if self._rms_high_streak >= self.cfg.capacity.auto_reset_frames:
                    self._mapping_restart(res_rms)
            else:
                self._rms_high_streak = 0
        return out

    def _mapping_restart(self, res_rms: float):
        """Divergence-watchdog action (default off via
        capacity.auto_reset_rms = 0): restart the map from scratch at the
        current pose, keep the trajectory, zero the velocity and re-open
        the covariance on rotation/velocity/biases/gravity so the EKF
        re-estimates them against the fresh map."""
        warnings.warn(
            f"divergence watchdog: res_rms {res_rms:.3f} > "
            f"{self.cfg.capacity.auto_reset_rms} for "
            f"{self._rms_high_streak} frames — restarting mapping at "
            "the current pose",
            RuntimeWarning,
        )
        self.map = self._make_map()
        self.map_built = False
        self.tracker = lio_mod.LocalMapTracker(
            self.cfg.cube_side_length, mode=self.cfg.capacity.slider)
        cov = self.state.cov.cpu().numpy().copy()
        for blk, var in ((slice(0, 3), 0.1), (slice(6, 9), 1.0),
                         (slice(9, 12), 1e-3), (slice(12, 15), 1e-2),
                         (slice(15, 18), 0.1)):
            sub = cov[blk, blk]
            np.fill_diagonal(sub, np.maximum(np.diagonal(sub), var))
        self.state = self.state._replace(
            vel=torch.zeros_like(self.state.vel),
            cov=torch.as_tensor(cov, device=self.device),
        )
        # cooldown: no re-trigger while the filter re-converges
        self._rms_high_streak = -3 * self.cfg.capacity.auto_reset_frames
        self.auto_resets += 1

    def _maybe_rebuild(self):
        """Load-factor-triggered compaction of the tiled map (the ikd-Tree
        Criterion_Check/rebuild role, ikd_Tree.cpp:1018-1035), checked
        every REBUILD_CHECK_EVERY frames from the occupancy in the last
        stats row."""
        if not self.map_built:
            return
        self._frames_since_rebuild_check += 1
        if self._frames_since_rebuild_check < REBUILD_CHECK_EVERY:
            return
        self._frames_since_rebuild_check = 0
        occ = self._map_occ_host
        if occ is None:
            occ = float(self.map.n_alloc)
        if occ > 0.85 * self.map.slot_key.shape[0]:
            self.map = tmod.compact(self.map)
            self._map_occ_host = None  # stale after compaction

    def _pad_scan_np(self, pts_np, t_rel_np, N):
        """Zero-padded (max_raw_points,) host scan buffers (bootstrap)."""
        rawcap = self.cfg.capacity.max_raw_points
        buf = np.zeros((rawcap, 3), np.float32)
        buf[:N] = pts_np
        trel = np.zeros(rawcap, np.float32)
        trel[:N] = t_rel_np
        pmask = np.zeros(rawcap, bool)
        pmask[:N] = True
        return buf, trel, pmask

    def _stage_scan(self, pts_np, t_rel_np, N):
        """The scan as one packed array of a grow-only pow2 bucket size B
        >= N (at least 1024); the frame step runs at that size. Returns
        (pts (B, 3), t_rel (B,), mask (B,), B)."""
        rawcap = self.cfg.capacity.max_raw_points
        B = min(rawcap, 1 << max(10, int(max(N - 1, 1)).bit_length()))
        B = max(B, self._scan_bucket)
        self._scan_bucket = B
        w = np.zeros((B + 1, 4), np.float32)
        w[:N, 0:3] = pts_np
        w[:N, 3] = t_rel_np
        w[B, 0] = N
        return (*stage_scan(torch.as_tensor(w, device=self.device), R=B), B)

    def _to_world(self, pts_body: np.ndarray) -> torch.Tensor:
        """Host lidar-frame points -> world frame at the current pose (f32)."""
        p = torch.as_tensor(pts_body, device=self.device)
        p_imu = p @ self.calib.lid_rot.T + self.calib.lid_off
        return p_imu @ self.state.rot.to(torch.float32).T + self.state.pos.to(torch.float32)

    def tum_trajectory(self) -> np.ndarray:
        """(T, 8) TUM rows: t x y z qx qy qz qw (laserMapping.cpp:1738-1748)."""
        return np.asarray(self.trajectory)
