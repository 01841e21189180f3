"""Per-frame orchestration of the LiDAR-inertial(-visual) system.

Port of the JAX package's pipeline.py (the reference's node loop,
src/laserMapping.cpp:1260-1818), on every map backend of
`capacity.map_backend`: the tiled map (default), the dense rolling grid
and the voxel hash.

Frame protocol per measurement group (sync.py):
  - IMU-init phase: accumulate static samples (IMU_init,
    IMU_Processing.cpp:137-182); groups are consumed without estimation.
  - lidar-end group: propagate to scan end, motion-compensate the scan
    with the merged per-scan pose table, slide the local map
    (lasermap_fov_segment :363-421), voxel-downsample, run the LIO
    iterated EKF (:1506-1732) once `flg_EKF_inited` (0.5 s after
    `first_lidar_time`, :79,1317), then insert the scan into the map
    (map_incremental :692-706).
  - image group (`img_enable`): propagate to the image time, then the
    VIO update (vio.Vio.update, laserMapping.cpp:1319-1390) on the
    previous lidar frame's dense world cloud, which stays on the device.

The steady-state frame is `frame_step.lidar_frame_step` with one
device-to-host read of its packed stats row. The first frames (map
bootstrap and the pre-EKF warm-up) take the staged path with the host
voxel filter.

Readback modes (outputs bit-identical to the synchronous path, later):
  - `async_read`: the stats row is copied to the host without blocking
    and read `async_depth` frames later (readback.DeferredRead); call
    `finish()` at the end of a stream.
  - `enable_block_read(E)` / replay.LivoBlockReplayer: the rows of E
    events are stacked on the device and read in one copy per block.
`log_dir` writes the reference's Log/ traces (logging_util.TraceLogger);
`mesh` (parallel.sharded.Mesh) runs the steady frame and the camera frame
over a device mesh, one Pipeline per rank on the same stream
(parallel/product.MeshRunner), with the map replicated or, with
`sharded_map`, block-sharded and the visual map's image pool and
observation rings in per-rank slabs;
`warm_start` restores an io/checkpoint snapshot. `profile_every` N > 0
runs the four stages of every N-th steady frame once more, each on its
own, and records their times in `last_stage_profile` (ms).

With images, `pcd_save_en` paints each emitted frame's world cloud from
the latest camera image (`Vio.colorize`) into `rgb_cloud`, and `debug`
keeps the camera frame's reads synchronous for its overlay
(`Vio.last_overlay`). `on_frame` is the visualization hook
(viz.LiveViewer.update).
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
from . import native
from . import visual_map as vmap_mod
from .config import Config
from .device import resolve_device
from .frame_step import lidar_frame_step, stage_scan
from .io import checkpoint as ckpt_mod
from .logging_util import TraceLogger, rot_to_quat_wxyz
from .ops import dense_map as dm
from .ops import tiled_map as tmod
from .ops import voxel_map as vm
from .ops.voxel_filter import voxel_downsample, voxel_downsample_device
from .readback import DeferredRead
from .state import NavState, identity_state, pack24
from .sync import MeasureGroup, Synchronizer
from .vio import Vio

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
    def __init__(self, cfg: Config, device=None, log_dir=None, mesh=None,
                 sharded_map: bool = False):
        """`device`: where the state, the map and every kernel live;
        CUDA unless the caller passes "cpu" (see device.py). `log_dir`:
        write the Log/ traces (mat_pre, mat_out, imu, pos_log and, with
        pose_output_en, camera_pose) there; under a mesh rank 0 writes
        them.

        `mesh`: this rank's parallel.sharded.Mesh. Every rank builds its
        Pipeline on the mesh's device and feeds it the same stream; the
        steady frame runs over the mesh (parallel/product.MeshRunner).
        Positions match the single-device path to f32-reduction epsilon.
        `sharded_map` (needs a mesh and the tiled backend): block-shard
        the map over the mesh, each rank's pool holding ~tiled_pool/N
        tiles (parallel/sharded_backend.py), and the camera frame's image
        pool and observation rings in per-rank slabs (vio.Vio). Under a
        mesh rank 0 alone draws the debug overlay, paints `rgb_cloud`
        and writes the traces."""
        cap = cfg.capacity
        lio_mod.check_supported(cap.map_backend, cap.plane_fit)
        if sharded_map:
            if mesh is None:
                raise ValueError("sharded_map requires a mesh")
            if cap.map_backend != "tiled":
                raise ValueError("sharded_map requires the tiled map backend "
                                 f"(map_backend={cap.map_backend!r})")
        self.mesh_runner = None
        self.lead = mesh is None or mesh.rank == 0
        if mesh is not None:
            from .parallel.product import MeshRunner

            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's {mesh.device}")
            device = mesh.device
            self.mesh_runner = MeshRunner(mesh, sharded_map=sharded_map,
                                          halo_tiles=cap.halo_tiles,
                                          snap_dims=cap.tiled_dir_dims)
            self.mesh_runner.check_capacity(cap)
            if mesh.rank != 0:
                log_dir = None  # rank 0 writes the traces
        self.cfg = cfg
        self.logger = TraceLogger(log_dir) if log_dir is not None else None
        self.device = resolve_device(device)
        dev = self.device
        # merged per-scan pose-table capacity: one segment per
        # measurement group, each bounded by max_imu_per_group rows plus
        # its start row
        self.max_scan_poses = max(8 * (cap.max_imu_per_group + 1), 128)
        self._decimation_warned = False
        self.rgb_cloud: List[np.ndarray] = []  # accumulated (x, y, z, r, g, b) rows
        self.sync = Synchronizer(img_enable=cfg.img_enable)
        # the camera frame's state (visual map, image pool), on `device`
        self.vio: Optional[Vio] = (Vio(cfg, device=dev, mesh_runner=self.mesh_runner)
                                   if cfg.img_enable else None)
        self.ready = False  # a lidar-end frame has run (image gate)
        self.initializer = imu_mod.ImuInitializer()
        self.init_done = False
        self.calib: Optional[imu_mod.ImuCalib] = None
        self.state: NavState = identity_state(dev)
        self._map_mod = lio_mod.BACKENDS[cap.map_backend]
        if sharded_map:
            from .parallel.sharded_backend import ShardedTiledBackend

            self._map_mod = ShardedTiledBackend(mesh)
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
        self.profile_every = 0  # > 0: staged re-run every N steady frames
        self._n_steady = 0  # steady-state lidar frames (profile cadence)
        self.last_stage_profile: Optional[dict] = None
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
        # device pose pack of the last IMU group (its last row is pack24
        # of the propagated state); None once an update moved the state.
        # Read only for the mat_pre trace row.
        self._prop_pack_dev = None
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
        # deferred readback (see the module doc): frames in flight, each
        # with its DeferredRead and the host metadata of its output
        self._async_read = False
        self.async_depth = 1
        self._pending: List[dict] = []
        # block-packed readback (replay.BlockReadCollector); owned by the
        # pipeline (flushed from spin/finish) when enable_block_read set it
        self.read_collector = None
        self._own_collector = False

    @property
    def async_read(self) -> bool:
        return self._async_read

    @async_read.setter
    def async_read(self, v: bool):
        self._async_read = bool(v)
        if self.vio is not None:  # camera frames defer their stats too
            self.vio.async_read = self._async_read

    @property
    def _sharded(self) -> bool:
        return getattr(self._map_mod, "is_sharded", False)

    def _make_map(self):
        """An empty map of this pipeline's backend."""
        cap, vs, dev = self.cfg.capacity, self.cfg.filter_size_map, self.device
        if self._sharded:
            return self._map_mod.empty(cap.tiled_dir_dims, cap.tiled_pool, vs)
        if self._map_mod is tmod:
            return tmod.empty_tiled_map(cap.tiled_dir_dims, cap.tiled_pool, vs,
                                        device=dev)
        if self._map_mod is vm:
            return vm.empty_map(cap.map_table_size, vs, device=dev)
        return dm.empty_dense_map(cap.dense_dims, vs, device=dev)

    # --- ingestion passthrough ------------------------------------------
    def push_lidar(self, stamp, pts, t_rel):
        self.sync.push_lidar(stamp, pts, t_rel)

    def push_imu(self, stamp, acc, gyr):
        self.sync.push_imu(stamp, acc, gyr)

    def push_img(self, stamp, img):
        self.sync.push_img(stamp, img)

    def spin(self) -> List[FrameOutput]:
        """Process every ready measurement group; returns new outputs
        (with deferred readback, a frame's output materializes later:
        call `finish()` at the end of a stream)."""
        n0 = len(self.outputs)
        if self.sync.reset_flagged:
            self._reset_imu()
            self.sync.reset_flagged = False
        for g in self.sync.drain():
            self._process_group(g)
            c = self.read_collector
            if self._own_collector and c is not None and len(c) >= c.E:
                c.flush()
        if not self.async_read and self._pending:
            self._resolve_pending()  # async_read was turned off mid-stream
        return self.outputs[n0:]

    def finish(self) -> List[FrameOutput]:
        """Resolve every deferred frame (end of stream); returns the late
        outputs (none in the synchronous mode)."""
        n0 = len(self.outputs)
        if self._own_collector and self.read_collector is not None:
            self.read_collector.drain()
        self._resolve_pending()
        if self.vio is not None:
            self.vio.resolve_pending()
        return self.outputs[n0:]

    def enable_block_read(self, block: int) -> None:
        """Live block-packed readback (`serve --block-read E`): the stats
        rows of every `block` events (a lidar frame and a camera frame are
        one event each) are read in one deferred copy, flushed from
        `spin()`. Outputs are bit-identical, up to ~2*block events late.
        Per-frame host consumers need per-frame reads and are refused."""
        from .replay import BlockReadCollector

        if (self.logger is not None or self.cfg.pcd_save_en
                or self.on_frame is not None or self.materialize_dense
                or self.collect_cov or self.cfg.debug):
            raise ValueError(
                "enable_block_read: per-frame consumers (logging, PCD, "
                "on_frame, materialize_dense, collect_cov, debug) need "
                "per-frame reads; use async_read instead")
        c = BlockReadCollector(self, int(block))
        self.read_collector = c
        self._own_collector = True
        if self.vio is not None:
            self.vio.read_collector = c

    def _resolve_oldest(self) -> Optional[FrameOutput]:
        """Emit the oldest deferred frame (waits for its copy only)."""
        if not self._pending:
            return None
        pend = self._pending.pop(0)
        stats = pend["stats"].result()
        dense = pend["dense"].result() if pend["dense"] is not None else None
        self._map_occ_host = float(stats[28])
        return self._emit_output(
            scan=pend["scan"], post_pack=stats[3:27],
            n_down=int(stats[0]), n_active=int(stats[1]), iters=int(stats[2]),
            res_rms=float(stats[27]), dense_world=dense,
            inten_np=pend["inten_np"], cov_handle=pend["cov_handle"],
            timing=pend["timing"])

    def _resolve_pending(self) -> None:
        """Emit every deferred frame (stream end, reset)."""
        while self._pending:
            self._resolve_oldest()

    def warm_start(self, state, m, visual=None, calib=None):
        """Restore a snapshot (io/checkpoint.load's tuple), moved to this
        pipeline's device. The snapshot's map backend replaces the
        config's. With `calib` the static IMU initialization is skipped
        and the EKF engages on the first restored scan; without it the
        maps load and IMU init re-runs on the live stream. Under a
        replicated mesh every rank restores the same snapshot; a sharded
        map is refused (rebuild it from the stream)."""
        if self._sharded:
            raise ValueError("a sharded map cannot restore a single-device map "
                             "checkpoint (rebuild the map from the stream)")
        dev = self.device

        def to_dev(nt):
            return type(nt)(*(t.to(dev) for t in nt))

        self.state = to_dev(state)
        self.map = to_dev(m)
        self._map_mod = lio_mod.map_module(self.map)
        self.map_built = True
        self._map_occ_host = None
        if visual is not None and self.vio is not None:
            self.vio.vmap = to_dev(visual)
            self.vio._n_pts_host = None
        if calib is not None:
            self.calib = to_dev(calib)
            self.init_done = True
        return self

    def checkpoint_arrays(self) -> Optional[dict]:
        """io/checkpoint.to_host of the estimator (state, map, visual map,
        calib). Under a mesh it is a collective that every rank calls at
        the same point: a sharded map's points and the visual map's slabs
        are gathered; rank 0 returns the arrays, the others None."""
        vmap = None if self.vio is None else self.vio.vmap
        mesh = self.vio.slab_mesh if self.vio is not None else None
        if self.lead:
            return ckpt_mod.to_host(self.state, self.checkpointable_map(), vmap,
                                    self.calib, mesh=mesh)
        if self._sharded:
            self._map_mod.extract_points(self.map)
        if mesh is not None:
            vmap_mod.gather_slabs(vmap, mesh)
        return None

    def checkpointable_map(self):
        """The map as io/checkpoint.save takes it. A sharded map merges
        its shards' live points into one TiledMap (ownership is disjoint,
        so tiled_map.build_host reproduces the content); this is a
        collective, called on every rank."""
        if self._sharded:
            pts_all, _ = self._map_mod.extract_points(self.map)
            cap = self.cfg.capacity
            return tmod.build_host(pts_all, cap.tiled_dir_dims, cap.tiled_pool,
                                   float(self.cfg.filter_size_map), device=self.device)
        return self.map

    def _reset_imu(self):
        """Loop-back recovery (laserMapping.cpp:1273-1279 +
        ImuProcess::Reset, IMU_Processing.cpp:31-44): a sensor-timestamp
        regression cleared the sync buffers; restart IMU initialization
        and drop the propagation context. The state itself is kept."""
        warnings.warn("sensor loop-back detected: resetting IMU processor",
                      RuntimeWarning)
        self._resolve_pending()  # emit the frames in flight first
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
            self._prop_pack_dev = None  # state changed outside propagation
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
            # also the warm restart: the first restored group anchors the
            # IMU-time continuity at its own start
            self.last_group_end = (scan.beg_time if scan is not None
                                   else float(imu_t[0]))
        acc_avg, gyr_avg, dt, offs, valid, tail_dt, row0_off = imu_mod.prepare_pairs(
            imu_t, imu_acc, imu_gyr,
            beg_time=scan.beg_time,
            end_time=end_time,
            last_end_time=self.last_group_end,
            max_pairs=cap,
        )
        if self.logger is not None and self.first_lidar_time is not None:
            # per-pair averaged IMU trace (fout_imu, IMU_Processing.cpp:681)
            for i in np.nonzero(valid)[0]:
                self.logger.log_imu(imu_t[i] - self.first_lidar_time,
                                    acc_avg[i], gyr_avg[i])
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
        self._prop_pack_dev = pose_pack
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
        if self.first_lidar_time is None and scan is not None:
            # warm restart with calib: backdate the epoch so that the EKF
            # is engaged from the first restored frame
            self.first_lidar_time = scan.beg_time - INIT_TIME

        t0 = time.perf_counter()
        end_time = scan.end_time if g.is_lidar_end else scan.beg_time + g.img_offset_time
        with record_function("frame.propagate"):
            self._propagate(g, end_time)

        if not g.is_lidar_end:
            # VIO update at the image time (laserMapping.cpp:1319-1390),
            # on every image group once a lidar frame has run
            if self.vio is not None and self.ready and self.first_lidar_time is not None:
                self.state = self.vio.update(self.state, self.state, g.img)
                self._prop_pack_dev = None  # posterior != propagated
            return None

        # ---- lidar-end frame: undistort the whole scan ------------------
        if self.logger is not None:
            # the propagated (pre-update) state row: the group's pose
            # pack ends with it (one read, paid only when logging)
            pre = (self._prop_pack_dev[-1] if self._prop_pack_dev is not None
                   else pack24(self.state))
            self.logger.log_pre(scan.end_time, pre.cpu().numpy())
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
        self.ready = True
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
                self.map = self._map_mod.delete_boxes(self.map, lo, hi)
        self._maybe_rebuild()

        fused = self.map_built and ekf_inited and self.cfg.lidar_enable
        dense_world = None
        if fused:
            # ---- steady state: the frame step, one stats read ----------
            pts_j, trel_j, pmask_j, B = self._stage_scan(pts_np, t_rel_np, N)
            step = (lidar_frame_step if self.mesh_runner is None
                    else self.mesh_runner.lidar_frame_step)
            (st, m2, down_j, dmask_j, _n_act, _iters,
             dense_j, active_j, stats_j) = step(
                self.state, self.map, pose_table, self.calib,
                pts_j, trel_j, pmask_j, self._fss_dev,
                laser_point_cov=float(self.cfg.laser_point_cov),
                # the downsample output never exceeds the live input
                # count, so the EKF batch shrinks with the bucket
                max_points=min(cap.max_points, B),
                max_iter=self.cfg.max_iteration,
                knn_radius=cap.knn_voxel_radius,
                max_probe=cap.max_probe,
                # the camera frame takes the dense world cloud
                dense_out=self.cfg.dense_map_enable or self.vio is not None,
                cache_knn=cap.cache_knn,
                plane_fit=cap.plane_fit,
            )
            self.state = st
            self._prop_pack_dev = None  # posterior != propagated
            self.map = m2
            self._n_steady += 1
            if self.profile_every and self._n_steady % self.profile_every == 0:
                self.last_stage_profile = self._profile_stages(
                    pose_table, *self._pad_scan_np(pts_np, t_rel_np, N))
            if self.vio is not None:
                # device-to-device handoff: only the row count is host-side
                self.vio.set_last_cloud_device(dense_j, N)
            self.last_effect = (down_j, active_j)
            if self.async_read or self.read_collector is not None:
                return self._defer(scan, inten_np, N, st, stats_j, dense_j, t0)
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
            # the C++ filter, as the JAX package's bootstrap takes it,
            # else its numpy twin
            got = native.voxel_downsample_native(
                feats_undistort, self.cfg.filter_size_surf, max_out=cap.max_points)
            if got is None:
                got = voxel_downsample(feats_undistort, self.cfg.filter_size_surf,
                                       max_out=cap.max_points)
            down, dmask = got
            n_down = int(dmask.sum())
            t_down = time.perf_counter()

            # first frame: build the map and return (laserMapping.cpp:1411)
            if not self.map_built:
                if n_down > 5:
                    world = self._to_world(down)
                    # the backends' default probe depth, as in the JAX package
                    self.map = self._map_mod.insert(self.map, world,
                                                    torch.as_tensor(dmask, device=dev))
                    self.map_built = True
                return None

            iters = 0
            n_active = 0
            t_ekf = time.perf_counter()
            world = self._to_world(down)
            self.map = self._map_mod.insert(self.map, world,
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
            if self.vio is not None:
                self.vio.set_last_cloud(dense_world)

        self._resolve_pending()  # keep the outputs in frame order
        return self._emit_output(
            scan=scan, post_pack=post_pack, n_down=n_down,
            n_active=n_active, iters=iters, res_rms=res_rms,
            dense_world=dense_world, inten_np=inten_np,
            cov_handle=self.state.cov,
            timing={
                "undistort": t_undistort - t0,
                "downsample": t_down - t_undistort,
                "ekf": t_ekf - t_down,
                "map": t_map - t_ekf,
                "total": t_map - t0,
            },
        )

    def _defer(self, scan, inten_np, N, st, stats_j, dense_j, t0) -> Optional[FrameOutput]:
        """The fused frame's readback, deferred: to the block collector,
        or started now and resolved `async_depth` frames later (after
        this frame's dispatches). The covariance handle is this frame's:
        a later frame replaces `self.state`."""
        t_done = time.perf_counter()
        timing = {"undistort": 0.0, "downsample": 0.0, "ekf": t_done - t0,
                  "map": 0.0, "total": t_done - t0}
        if self.read_collector is not None:
            self.read_collector.add_lidar(stats_j, dict(
                scan=scan, inten_np=inten_np, cov_handle=st.cov, timing=timing))
            return None
        need_dense = self.cfg.dense_map_enable and (
            self.cfg.pcd_save_en or self.on_frame is not None
            or self.materialize_dense)
        self._pending.append(dict(
            stats=DeferredRead(stats_j),
            dense=DeferredRead(dense_j[:N]) if need_dense else None,
            scan=scan, inten_np=inten_np, cov_handle=st.cov, timing=timing))
        out = None
        while len(self._pending) > self.async_depth:
            out = self._resolve_oldest()
        return out

    def _emit_output(self, *, scan, post_pack, n_down, n_active, iters,
                     res_rms, dense_world, inten_np, cov_handle,
                     timing) -> FrameOutput:
        """Host-side frame finalization: trace logging, FrameOutput,
        hooks, trajectory and the divergence watchdog. Shared by the
        synchronous path and the deferred resolutions."""
        self._last_post = post_pack  # feeds next frame's map slider
        if self.logger is not None:
            self.logger.log_post(scan.end_time, post_pack, n_points=len(scan.pts))
            self.logger.log_pos(scan.beg_time - (self.first_lidar_time or 0.0),
                                post_pack)
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
        if self.cfg.pose_output_en and self.logger is not None and self.vio is not None:
            # camera_pose.txt (fout_tum, laserMapping.cpp:1738-1748): the
            # world->camera pose of the latest camera frame, or from the
            # current state before the first one
            self.vio.resolve_pending()
            if self.vio.last_rcw is not None:
                rcw, pcw = self.vio.last_rcw, self.vio.last_pcw
            else:
                rcw = self.vio.Rci.cpu().numpy() @ rot_np.T
                pcw = -rcw @ pos_np + self.vio.Pci.cpu().numpy()
            self.logger.log_camera_pose(scan.beg_time, rcw, pcw)
        if (self.cfg.pcd_save_en and self.vio is not None and out.pts_world is not None
                and self.lead):
            # the accumulated RGB world cloud (pcl_wait_save,
            # laserMapping.cpp:726-746, 778): the frame's cloud painted from
            # the latest image, in-frame points only
            cmask, rgb = self.vio.colorize(out.pts_world)
            if cmask.any():
                self.rgb_cloud.append(
                    np.concatenate([out.pts_world[cmask], rgb[cmask]], axis=1))
        if self.collect_cov:
            self.covs.append(cov_handle.cpu().numpy())
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
        if self.vio is not None:
            self.vio.reset_map()
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

    def _profile_stages(self, pose_table, buf, trel, pmask) -> dict:
        """Per-stage times of a steady frame (the reference's per-frame
        printf, laserMapping.cpp:1805: match/solve/ICP/map-incre), in ms:
        the frame's four stages run once more, each on its own, after the
        frame step. As in the JAX package the EKF runs with the default
        options and the results are dropped. The insert goes into a copy
        of the map, made outside the timed window, so the pipeline's
        outputs do not change. On CUDA each stage ends in a wait for the
        device. Under a replicated mesh each rank runs the stages on its
        own; a sharded map has no single-device stages (returns None)."""
        if self._sharded:
            return None
        cap = self.cfg.capacity
        dev = self.device
        calib = self.calib
        times = {}

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        def timed(stage, fn, *args, **kw):
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            sync()
            times[stage] = (time.perf_counter() - t0) * 1e3
            return out

        mask = torch.as_tensor(pmask, device=dev)
        und = timed("undistort", imu_mod.undistort, self.state, pose_table,
                    torch.as_tensor(buf, device=dev), torch.as_tensor(trel, device=dev),
                    mask, calib)
        down, dmask = timed("downsample", voxel_downsample_device, und, mask,
                            self._fss_dev, cap.max_points)
        timed("ekf", lio_mod.lio_update, self.state, self.map, down, dmask,
              calib.lid_rot, calib.lid_off, laser_point_cov=float(self.cfg.laser_point_cov),
              max_iter=self.cfg.max_iteration, knn_radius=cap.knn_voxel_radius,
              max_probe=cap.max_probe)
        scratch = type(self.map)(*(t.clone() for t in self.map))
        sync()

        def insert():
            p_imu = down @ calib.lid_rot.T + calib.lid_off
            world = (p_imu @ self.state.rot.to(torch.float32).T
                     + self.state.pos.to(torch.float32))
            return self._map_mod.insert(scratch, world, dmask, cap.max_probe)

        timed("map", insert)
        return times

    def _maybe_rebuild(self):
        """Load-factor-triggered map upkeep (the ikd-Tree Criterion_Check/
        rebuild role, ikd_Tree.cpp:1018-1035), checked every
        REBUILD_CHECK_EVERY frames from the occupancy in the last stats
        row: the tiled map compacts away dead tiles past 0.85 of its pool,
        the hash map re-inserts into a fresh table past 0.7 of its slots
        (probe chains broken by deletions included); the dense grid needs
        none."""
        if not self.map_built:
            return
        self._frames_since_rebuild_check += 1
        if self._frames_since_rebuild_check < REBUILD_CHECK_EVERY:
            return
        self._frames_since_rebuild_check = 0
        occ = self._map_occ_host
        if self._sharded:
            # the stats row carries the fullest shard's allocation; the
            # per-shard pool is the binding constraint
            if occ is None:
                occ = self._map_mod.max_occupancy(self.map)
            if occ > 0.85 * self._map_mod.pool_per_shard(self.map):
                self.map = self._map_mod.compact(self.map)
                self._map_occ_host = None
        elif self._map_mod is tmod:
            if occ is None:
                occ = float(self.map.n_alloc)
            if occ > 0.85 * self.map.slot_key.shape[0]:
                self.map = tmod.compact(self.map)
                self._map_occ_host = None  # stale after compaction
        elif self._map_mod is vm:
            if occ is None:
                occ = float(self.map.count)
            if occ > 0.7 * self.map.check.shape[0]:
                self.map = vm.rebuild(self.map)
                self._map_occ_host = None
        # visual-map capacity: drop points outside the local cube when the
        # point pool nears exhaustion (see visual_map.compact)
        if self.vio is not None:
            vmap = self.vio.vmap
            n_pts = self.vio._n_pts_host
            if n_pts is None:
                n_pts = int(vmap.n_pts)
            if n_pts > 0.9 * vmap.pos.shape[0]:
                self.vio.vmap = vmap_mod.compact(
                    vmap, self.state.pos.to(torch.float32),
                    torch.tensor(self.cfg.cube_side_length, dtype=torch.float32,
                                 device=self.device), mesh=self.vio.slab_mesh)
                self.vio._n_pts_host = None

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
