"""Offline replay in blocks: one host read per block of frames.

Port of the JAX package's replay.py. Two replayers:

  - `BlockReplayer` (LIO only): once the pipeline is in its steady
    state, K lidar frames run back to back in `lidar_block_step` (IMU
    propagation, then the per-frame path's `lidar_frame_step`), and the K frames' summaries are read in one packed
    (K, 43) f64 copy. The JAX package chains the K steps in a `lax.scan`;
    here they are a host loop over the same per-frame functions. As in
    the JAX package, the sliding local map moves once per block, the
    block's own pow2 buckets set the scan size R and the EKF batch
    (`min(max_points, R)`), and each group's IMU pairs are staged by
    `prepare_pairs` from the group alone.
  - `LivoBlockReplayer` (LIO or LIVO): the per-frame path itself, with
    the stats rows of E events (lidar and camera frames) stacked on the
    device by a `BlockReadCollector` and read in one copy per block; its
    outputs equal the per-frame path's except that the map slider reads a
    posterior E to 2E-1 frames old. With a per-frame consumer (trace
    logging, PCD, `on_frame`, `materialize_dense`, `collect_cov`, debug)
    it falls back to E-deep deferred readback.
"""
from __future__ import annotations

import time
import warnings
from typing import List

import numpy as np
import torch

from . import imu as imu_mod
from .frame_step import lidar_frame_step
from .logging_util import rot_to_quat_wxyz
from .readback import DeferredRead
from .state import NavState

F64 = torch.float64


def lidar_block_step(state: NavState, m, calib: imu_mod.ImuCalib,
                     acc_avg, gyr_avg, dt, offs, pair_valid, tail_dt, row0_off,
                     pts_raw, t_rel, rmask, acc_s_last, angvel_last,
                     filter_size_surf: torch.Tensor, laser_point_cov: float,
                     max_points: int, max_iter: int, knn_radius: int,
                     max_probe: int = 12, plane_fit: str = "tls"):
    """K chained scan steps on any map backend; inputs are stacked on a
    leading axis K. Each step is `imu.propagate` followed by the
    per-frame path's own `frame_step.lidar_frame_step`.

    As in the JAX package, the block step takes `plane_fit` and
    `max_probe` but not `cache_knn`: a `BlockReplayer` searches the map
    at every search even when the config sets `cache_knn`.

    Returns (state', map' (the map, updated in place), acc_s_last',
    angvel_last', ys) with ys one packed (K, 43) f64 tensor, one row per
    frame: [pre rot9|pos3|vel3 (0:15), post rot9|pos3|vel3|bg3|ba3|grav3
    (15:39), n_active, iters, res_rms, map_occupancy (39:43)]."""
    st, mm = state, m
    acc_s = acc_s_last.to(state.pos.dtype)
    angv = angvel_last.to(state.pos.dtype)
    tail = torch.tensor([1, 2, 27, 28], device=pts_raw.device)
    ys = []
    for k in range(acc_avg.shape[0]):
        st1, pose, acc_s, angv = imu_mod.propagate(
            st, acc_avg[k], gyr_avg[k], dt[k], offs[k], pair_valid[k],
            tail_dt[k], acc_s, angv, calib, row0_off=row0_off[k])
        st, mm, *_, stats = lidar_frame_step(
            st1, mm, pose, calib, pts_raw[k], t_rel[k], rmask[k],
            filter_size_surf, laser_point_cov, max_points, max_iter,
            knn_radius, max_probe, dense_out=False, plane_fit=plane_fit)
        ys.append(torch.cat([st1.rot.reshape(9).to(F64), st1.pos.to(F64),
                             st1.vel.to(F64), stats[3:27], stats[tail]]))
    return st, mm, acc_s, angv, torch.stack(ys)


SUMMARY_TAIL = 39  # counters start here in a packed summary row


def _unpack_summary(rows: np.ndarray) -> dict:
    """Host-side inverse of `lidar_block_step`'s rows over (E, >= 39) rows."""
    E = len(rows)
    return {
        "pre_R": rows[:, 0:9].reshape(E, 3, 3),
        "pre_p": rows[:, 9:12], "pre_v": rows[:, 12:15],
        "po_R": rows[:, 15:24].reshape(E, 3, 3),
        "po_p": rows[:, 24:27], "po_v": rows[:, 27:30],
        "po_bg": rows[:, 30:33], "po_ba": rows[:, 33:36],
        "po_gv": rows[:, 36:39],
        "tail": rows[:, SUMMARY_TAIL:],
    }


def _pack24_np(R, p, v, bg, ba, gv) -> np.ndarray:
    return np.concatenate([np.asarray(R, np.float64).reshape(9), p, v, bg, ba, gv])


class BlockReplayer:
    """Drives a Pipeline's steady state in K-frame blocks (LIO only).

    Feed all sensor data into the pipeline's synchronizer, then call
    `run()`. Bootstrap frames (IMU init, map build, pre-EKF warm-up) go
    through the per-frame path; the steady-state lidar groups are staged
    and run in blocks."""

    def __init__(self, pipe, block: int = 8):
        if pipe.cfg.img_enable:
            raise ValueError("BlockReplayer is LIO-only; use LivoBlockReplayer")
        self.pipe = pipe
        self.K = block
        # the previous block's packed posterior (host): the map slider's
        # input and the logger's pre-row biases, without device reads
        self._last_po_pos = None
        self._last_po_bias = None
        self._scan_bucket = 0  # grow-only pow2 shape buckets (_stage)
        self._imu_bucket = 0

    def _stage(self, groups):
        """Host-side staging of K groups into stacked arrays, at pow2
        buckets of the block's largest scan and IMU-pair count."""
        p = self.pipe
        cap = p.cfg.capacity
        n_scan_max = max(min(len(g.scan.pts), cap.max_raw_points) for g in groups)
        n_imu_max = max(len(g.imu_t) + 1 for g in groups)
        P = min(cap.max_imu_per_group,
                1 << max(3, int(max(n_imu_max - 1, 1)).bit_length()))
        R = min(cap.max_raw_points,
                1 << max(10, int(max(n_scan_max - 1, 1)).bit_length()))
        P = self._imu_bucket = max(P, self._imu_bucket)
        R = self._scan_bucket = max(R, self._scan_bucket)
        K = len(groups)
        A = np.zeros((K, P, 3), np.float32)
        G = np.zeros((K, P, 3), np.float32)
        D = np.zeros((K, P), np.float32)
        O = np.full((K, P), imu_mod.BIG_T, np.float32)
        V = np.zeros((K, P), bool)
        TD = np.zeros(K, np.float32)
        R0 = np.zeros(K, np.float32)
        PTS = np.zeros((K, R, 3), np.float32)
        TR = np.zeros((K, R), np.float32)
        PM = np.zeros((K, R), bool)
        ts = []
        for k, g in enumerate(groups):
            scan = g.scan
            end_time = scan.end_time
            ts.append(end_time)
            if p.last_imu is not None:
                imu_t = np.concatenate([[p.last_imu[0]], g.imu_t])
                imu_acc = np.concatenate([[p.last_imu[1]], g.imu_acc])
                imu_gyr = np.concatenate([[p.last_imu[2]], g.imu_gyr])
            else:
                imu_t, imu_acc, imu_gyr = g.imu_t, g.imu_acc, g.imu_gyr
            if len(g.imu_t):
                p.last_imu = (g.imu_t[-1], g.imu_acc[-1], g.imu_gyr[-1])
            a, gy, d, o, v, td, r0 = imu_mod.prepare_pairs(
                imu_t, imu_acc, imu_gyr,
                beg_time=scan.beg_time, end_time=end_time,
                last_end_time=p.last_group_end, max_pairs=P)
            A[k], G[k], D[k], O[k], V[k], TD[k], R0[k] = a, gy, d, o, v, td, r0
            p.last_group_end = end_time
            if p.logger is not None and p.first_lidar_time is not None:
                for i in np.nonzero(v)[0]:
                    p.logger.log_imu(imu_t[i] - p.first_lidar_time, a[i], gy[i])
            pts_use, trel_use = scan.pts, scan.t_rel
            if len(pts_use) > R:
                # the per-frame path's stride decimation
                stride = -(-len(pts_use) // R)
                if not p._decimation_warned:
                    p._decimation_warned = True
                    warnings.warn(
                        f"raw scan of {len(pts_use)} points exceeds "
                        f"capacity.max_raw_points={R}; stride-decimating "
                        f"by {stride} (coverage loss). Raise the "
                        "capacity to keep full scans.", RuntimeWarning)
                idx = np.arange(0, len(pts_use), stride)
                pts_use, trel_use = pts_use[idx], trel_use[idx]
            n = min(len(pts_use), R)
            PTS[k, :n] = pts_use[:n, :3]
            TR[k, :n] = trel_use[:n]
            PM[k, :n] = True
        return (A, G, D, O, V, TD, R0, PTS, TR, PM), ts

    def run(self) -> List:
        """Process everything in the synchronizer; returns the pipeline's
        FrameOutput list (appended in place)."""
        from .pipeline import INIT_TIME

        p = self.pipe
        if p.sync.reset_flagged:
            p._reset_imu()
            p.sync.reset_flagged = False
        pending = []
        for g in p.sync.drain():
            steady = (p.map_built and p.init_done and p.ready and g.is_lidar_end
                      and p.first_lidar_time is not None
                      and g.scan.beg_time - p.first_lidar_time >= INIT_TIME)
            if not steady:
                if pending:
                    self._flush(pending)
                    pending = []
                p._process_group(g)
                # the per-frame path moved p.state: the cached packed
                # posterior rows no longer describe it
                self._last_po_pos = self._last_po_bias = None
                continue
            pending.append(g)
            if len(pending) == self.K:
                self._flush(pending)
                pending = []
        if pending:
            self._flush(pending)
        return p.outputs

    def _flush(self, groups):
        from .pipeline import FrameOutput

        p = self.pipe
        cap = p.cfg.capacity
        dev = p.device
        t0 = time.perf_counter()
        # one sliding-map pass per block, on the previous block's posterior
        pos_np = (self._last_po_pos if self._last_po_pos is not None
                  else p.state.pos.cpu().numpy())
        boxes = p.tracker.update(pos_np)
        if boxes and p.map_built:
            lo = torch.as_tensor(np.asarray([b[0] for b in boxes], np.float32), device=dev)
            hi = torch.as_tensor(np.asarray([b[1] for b in boxes], np.float32), device=dev)
            p.map = p._map_mod.delete_boxes(p.map, lo, hi)
        p._maybe_rebuild()
        pre_bias_state = p.state
        arrays, ts = self._stage(groups)
        A, G, D, O, V, TD, R0, PTS, TR, PM = (torch.as_tensor(a, device=dev)
                                              for a in arrays)
        st, m2, acc_f, ang_f, ys = lidar_block_step(
            p.state, p.map, p.calib, A, G, D, O, V, TD, R0, PTS, TR, PM,
            p.acc_s_last, p.angvel_last, p._fss_dev,
            laser_point_cov=float(p.cfg.laser_point_cov),
            max_points=min(cap.max_points, PTS.shape[1]),
            max_iter=p.cfg.max_iteration, knn_radius=cap.knn_voxel_radius,
            max_probe=cap.max_probe, plane_fit=cap.plane_fit)
        p.state = st
        p.map = m2
        p.acc_s_last, p.angvel_last = acc_f, ang_f
        p._prop_pack_dev = None
        K = len(groups)
        u = _unpack_summary(ys.cpu().numpy())  # the block's one read
        wall = time.perf_counter() - t0
        pre_R, pre_p, pre_v = u["pre_R"], u["pre_p"], u["pre_v"]
        po_R, po_p, po_v = u["po_R"], u["po_p"], u["po_v"]
        po_bg, po_ba, po_gv = u["po_bg"], u["po_ba"], u["po_gv"]
        n_act, iters, res_rms = u["tail"][:, 0], u["tail"][:, 1], u["tail"][:, 2]
        p._map_occ_host = float(u["tail"][-1, 3])
        self._last_po_pos = po_p[-1]
        # the pipeline's own slider input stays fresh for a later spin()
        p._last_post = _pack24_np(po_R[-1], po_p[-1], po_v[-1],
                                  po_bg[-1], po_ba[-1], po_gv[-1])
        if p.logger is not None:
            if self._last_po_bias is not None:
                bg0, ba0, gv0 = self._last_po_bias
            else:
                bg0, ba0, gv0 = (t.cpu().numpy() for t in (
                    pre_bias_state.bg, pre_bias_state.ba, pre_bias_state.grav))
        self._last_po_bias = (po_bg[-1], po_ba[-1], po_gv[-1])
        for k in range(K):
            if p.logger is not None:
                # pre-row biases are the previous frame's posterior
                # (propagation never changes them)
                pbg = bg0 if k == 0 else po_bg[k - 1]
                pba = ba0 if k == 0 else po_ba[k - 1]
                pgv = gv0 if k == 0 else po_gv[k - 1]
                p.logger.log_pre(ts[k], _pack24_np(pre_R[k], pre_p[k], pre_v[k],
                                                   pbg, pba, pgv))
                p.logger.log_post(ts[k], _pack24_np(po_R[k], po_p[k], po_v[k],
                                                    po_bg[k], po_ba[k], po_gv[k]),
                                  n_points=len(groups[k].scan.pts))
            quat = rot_to_quat_wxyz(po_R[k])
            out = FrameOutput(
                t=ts[k], pos=po_p[k].copy(), quat=quat, vel=po_v[k].copy(),
                n_active=int(n_act[k]), iters=int(iters[k]), n_points=0,
                timing={"undistort": 0.0, "downsample": 0.0,
                        "ekf": wall / K, "map": 0.0, "total": wall / K},
                res_rms=float(res_rms[k]))
            p.outputs.append(out)
            p.trajectory.append(np.array(
                [out.t, *out.pos, quat[1], quat[2], quat[3], quat[0]]))


class BlockReadCollector:
    """Collects per-frame (29,) f64 stats rows as device tensors and reads
    a whole block in one copy.

    The pipeline and the Vio hand rows over in dispatch order (lidar rows
    with their output's metadata, camera rows for Vio._apply_stats), so a
    flush preserves per-frame output order and content."""

    def __init__(self, pipe, block: int):
        self.pipe = pipe
        self.E = block
        self.entries: List = []  # ("lidar", meta) | ("cam", None)
        self.rows: List = []  # device f64 rows, dispatch order
        self._inflight = None  # (DeferredRead, entries) of the last flush

    def __len__(self):
        return len(self.entries)

    def add_lidar(self, stats_j, meta: dict):
        self.rows.append(stats_j)
        self.entries.append(("lidar", meta))

    def add_cam(self, stats_j):
        self.rows.append(stats_j)
        self.entries.append(("cam", None))

    def flush(self):
        """Start this block's one copy (a partial block padded to E rows)
        and emit the previous block's frames, whose copy had a block's
        head start. Call `drain()` at the end of a stream."""
        if not self.entries:
            return
        rows = [r.to(F64) for r in self.rows]
        if len(rows) < self.E:
            rows += [torch.zeros_like(rows[0])] * (self.E - len(rows))
        inflight = (DeferredRead(torch.stack(rows)), list(self.entries))
        self.entries.clear()
        self.rows.clear()
        prev, self._inflight = self._inflight, inflight
        if prev is not None:
            self._emit(prev)

    def drain(self):
        """End-of-stream barrier: flush and emit everything pending."""
        self.flush()
        if self._inflight is not None:
            prev, self._inflight = self._inflight, None
            self._emit(prev)

    def _emit(self, inflight):
        read, entries = inflight
        arr = read.result()
        p = self.pipe
        for (kind, meta), row in zip(entries, arr):
            if kind == "lidar":
                p._map_occ_host = float(row[28])
                p._emit_output(
                    scan=meta["scan"], post_pack=row[3:27],
                    n_down=int(row[0]), n_active=int(row[1]),
                    iters=int(row[2]), res_rms=float(row[27]),
                    dense_world=None, inten_np=meta["inten_np"],
                    cov_handle=meta["cov_handle"], timing=meta["timing"])
            else:
                p.vio._apply_stats(row)


class LivoBlockReplayer:
    """Offline replay (LIVO, or LIO) in blocks of E measurement events:
    the per-frame path with block-packed readback (see the module doc)."""

    def __init__(self, pipe, block: int = 8):
        self.pipe = pipe
        self.E = max(int(block), 1)

    def _per_frame_consumers(self) -> bool:
        p = self.pipe
        return (p.logger is not None or p.cfg.pcd_save_en
                or p.on_frame is not None or p.materialize_dense
                or p.collect_cov or p.cfg.debug)

    def run(self) -> List:
        p = self.pipe
        if self._per_frame_consumers():
            return self._run_deferred()
        collector = BlockReadCollector(p, self.E)
        prev = (p.read_collector,
                p.vio.read_collector if p.vio is not None else None)
        p.read_collector = collector
        if p.vio is not None:
            p.vio.read_collector = collector
        try:
            if p.sync.reset_flagged:
                p._reset_imu()
                p.sync.reset_flagged = False
            for g in p.sync.drain():
                p._process_group(g)
                if len(collector) >= self.E:
                    collector.flush()
            collector.drain()
            p.finish()  # warm-up frames may have used deferred reads
        finally:
            p.read_collector = prev[0]
            if p.vio is not None:
                p.vio.read_collector = prev[1]
        return p.outputs

    def _run_deferred(self) -> List:
        """Fallback for per-frame consumers: E-deep deferred readback (one
        read per frame, up to E frames off the dispatch path)."""
        p = self.pipe
        prev = (p.async_read, p.async_depth,
                p.vio.async_depth if p.vio is not None else None)
        p.async_read = True
        p.async_depth = self.E
        if p.vio is not None:
            p.vio.async_depth = self.E
        try:
            p.spin()
            p.finish()
        finally:
            p.async_read = prev[0]
            p.async_depth = prev[1]
            if p.vio is not None:
                p.vio.async_depth = prev[2]
        return p.outputs
