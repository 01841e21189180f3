"""Measurement synchronization (host side).

Re-implements the semantics of the reference's `sync_packages`
(reference: src/laserMapping.cpp:520-690) and its grouping types
`MeasureGroup` / `LidarMeasureGroup` (include/common_lib.h:148-192)
without ROS: plain Python deques fed by `push_*` calls, drained by
`next_group()`.

Grouping rules (mirroring the reference exactly):
  - A lidar scan opens a `ScanBundle`; its end time is
    beg_time + last point offset (:552-554; offsets in ms).
  - While an image timestamp falls inside the open scan, an IMAGE group
    is emitted carrying that image plus all IMU samples <= image time
    (:613-637) — `is_lidar_end=False`.
  - When no (more) images precede the scan end, a LIDAR-END group is
    emitted with all IMU <= scan end (:557-581, :588-611) —
    `is_lidar_end=True` — closing the scan.
  - Emission blocks until IMU coverage exists: last IMU must exceed
    scan_end + 0.02 s for lidar groups (:558) or image time for image
    groups (:615).
  - Scans with <= 1 point are dropped (with their paired image, :538-549).
  - A sensor-time regression ("loop back", rosbag restart) clears
    buffers and signals reset (laserMapping.cpp:428-431, 475-480).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class MeasureGroup:
    """One synchronized measurement packet (common_lib.h:148-157)."""

    imu_t: np.ndarray  # (K,) f64 absolute stamps
    imu_acc: np.ndarray  # (K, 3)
    imu_gyr: np.ndarray  # (K, 3)
    img: Optional[np.ndarray] = None  # (H, W) or (H, W, 3) uint8
    img_offset_time: float = 0.0  # seconds from scan begin (:618)
    is_lidar_end: bool = False
    # the owning scan (shared across the scan's groups)
    scan: Optional["ScanBundle"] = None

    def debug_show(self):
        """Sync-structure dump (LidarMeasureGroup::debug_show,
        common_lib.h:176-191): IMU stamps relative to the scan begin,
        image offset, end flag and scan size."""
        beg = self.scan.beg_time if self.scan is not None else 0.0
        print("Lidar selector debug:")
        print(f"lidar_beg_time:{beg:.20g}")
        offs = " ".join(f"{t - beg:.20g}" for t in self.imu_t)
        print(f"In measures: {offs} img_time:{self.img_offset_time:.20g}")
        end = self.scan.end_time - beg if self.scan is not None else 0.0
        npts = len(self.scan.pts) if self.scan is not None else 0
        print(f"is_lidar_end:{int(self.is_lidar_end)} lidar_end_time:{end:.20g}")
        print(f"lidar_.points.size(): {npts}\n")


@dataclasses.dataclass
class ScanBundle:
    """One lidar scan with per-point relative times (seconds)."""

    beg_time: float
    pts: np.ndarray  # (N, 3+) body-frame points, sorted by time
    t_rel: np.ndarray  # (N,) f64 seconds from beg_time, ascending

    @property
    def end_time(self) -> float:
        return self.beg_time + (float(self.t_rel[-1]) if len(self.t_rel) else 0.0)


class Synchronizer:
    IMU_COVER_MARGIN = 0.02  # seconds (laserMapping.cpp:558)

    def __init__(self, img_enable: bool = True):
        self.img_enable = img_enable
        self.lidar_buf: deque[ScanBundle] = deque()
        self.imu_t: deque[float] = deque()
        self.imu_acc: deque[np.ndarray] = deque()
        self.imu_gyr: deque[np.ndarray] = deque()
        self.img_buf: deque[np.ndarray] = deque()
        self.img_time_buf: deque[float] = deque()
        self._open_scan: Optional[ScanBundle] = None
        self.last_timestamp_imu = -np.inf
        self.last_timestamp_lidar = -np.inf
        self.last_timestamp_img = -np.inf
        self.reset_flagged = False

    # --- ingestion (the ROS callbacks, laserMapping.cpp:424-518) ---------
    def push_lidar(self, stamp: float, pts: np.ndarray, t_rel: np.ndarray):
        if stamp < self.last_timestamp_lidar:
            self.lidar_buf.clear()
            self.reset_flagged = True
        self.last_timestamp_lidar = stamp
        order = np.argsort(np.asarray(t_rel), kind="stable")
        pts = np.asarray(pts)[order]
        t_rel = np.asarray(t_rel, dtype=np.float64)[order]
        self.lidar_buf.append(ScanBundle(float(stamp), pts, t_rel))

    def push_imu(self, stamp: float, acc, gyr):
        if stamp < self.last_timestamp_imu:
            self.imu_t.clear(); self.imu_acc.clear(); self.imu_gyr.clear()
            self.reset_flagged = True
        self.last_timestamp_imu = stamp
        self.imu_t.append(float(stamp))
        self.imu_acc.append(np.asarray(acc, np.float64))
        self.imu_gyr.append(np.asarray(gyr, np.float64))

    def push_img(self, stamp: float, img: np.ndarray):
        if not self.img_enable:  # img_cbk no-ops when img_en=0 (:498-501)
            return
        if stamp < self.last_timestamp_img:
            self.img_buf.clear(); self.img_time_buf.clear()
            self.reset_flagged = True
        self.last_timestamp_img = stamp
        self.img_buf.append(img)
        self.img_time_buf.append(float(stamp))

    def reset_open_scan(self):
        """Drop the partially-consumed scan after a loop-back reset (its
        buffer entry was already cleared by the regression handler)."""
        self._open_scan = None

    # --- draining --------------------------------------------------------
    def _pop_imu_until(self, t: float) -> MeasureGroup:
        """Pop IMU samples with stamp <= t (reference keeps popping while
        the front is < t, including the first sample past t check :566)."""
        ts, accs, gyrs = [], [], []
        while self.imu_t and self.imu_t[0] <= t:
            ts.append(self.imu_t.popleft())
            accs.append(self.imu_acc.popleft())
            gyrs.append(self.imu_gyr.popleft())
        return MeasureGroup(
            imu_t=np.asarray(ts, np.float64),
            imu_acc=np.asarray(accs).reshape(-1, 3),
            imu_gyr=np.asarray(gyrs).reshape(-1, 3),
        )

    def next_group(self) -> Optional[MeasureGroup]:
        """Emit the next synchronized group, or None if not ready."""
        if not self.lidar_buf and not self.img_buf:
            return None
        if self._open_scan is None:
            # consume degenerate (<=1 point) scans and KEEP GOING: the
            # reference's sync_packages returns false for such a scan
            # but its main loop retries immediately (laserMapping.cpp:
            # 1260) — returning None here would stall drain() until the
            # next external push, delaying ready groups behind it
            while self.lidar_buf and len(self.lidar_buf[0].pts) <= 1:
                self.lidar_buf.popleft()
                if self.img_buf:
                    self.img_buf.popleft()
                    self.img_time_buf.popleft()
            if not self.lidar_buf:
                return None
            self._open_scan = self.lidar_buf[0]

        scan = self._open_scan
        end_time = scan.end_time

        def close_scan() -> MeasureGroup:
            g = self._pop_imu_until(end_time)
            g.is_lidar_end = True
            g.scan = scan
            self.lidar_buf.popleft()
            self._open_scan = None
            return g

        if not self.img_buf:
            if self.last_timestamp_imu < end_time + self.IMU_COVER_MARGIN:
                return None
            return close_scan()

        img_time = self.img_time_buf[0]
        if img_time > end_time:
            if self.last_timestamp_imu < end_time + self.IMU_COVER_MARGIN:
                return None
            return close_scan()

        if self.last_timestamp_imu < img_time:
            return None
        g = self._pop_imu_until(img_time)
        g.img = self.img_buf.popleft()
        self.img_time_buf.popleft()
        g.img_offset_time = img_time - scan.beg_time
        g.is_lidar_end = False
        g.scan = scan
        return g

    def drain(self) -> List[MeasureGroup]:
        out = []
        while True:
            g = self.next_group()
            if g is None:
                return out
            out.append(g)
