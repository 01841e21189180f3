"""Per-vendor LiDAR decode + decimation (host side, vectorized numpy).

Re-implements the reference `Preprocess` handlers
(reference: src/preprocess.cpp) without ROS/PCL: each decoder takes
plain numpy field arrays (as produced by io/rosbag.py or any loader) and
returns `(pts (N,4) [x y z intensity] f32, t_rel (N,) f64 seconds)`
sorted in arrival order, with the vendor's gating applied:

  - AVIA (avia_handler :73-162): tag-bit filter ((tag & 0x30) in
    {0x00, 0x10}), line < N_SCANS, 1-in-`point_filter_num` decimation of
    the tag-valid stream, near-duplicate drop vs the previous raw point,
    blind-zone cull; per-point offset_time ns -> s.
  - VELO16 (velodyne_handler :259-431): uses per-point `time` when the
    scan provides it, otherwise reconstructs per-ring offsets from yaw
    at 10 Hz (omega = 3.61 deg/ms) exactly like :321-347.
  - OUST64 (oust64_handler :164-257): t ns -> s, stride + blind cull.
  - XT32 (xt32_handler :432-465): absolute per-point `timestamp` seconds
    -> offsets from the first point; stride; the reference compares
    squared range against un-squared `blind` (:459) — kept as-is.

The LOAM-style plane/edge feature extraction (`give_feature`,
preprocess.cpp:466-935) lives in features.py; `decode` routes through it
when `feature_extract_enable` is set (OFF in every shipped config).
"""
from __future__ import annotations

import numpy as np

from .config import AVIA, OUST64, VELO16, XT32, PreprocessConfig


def _stride_mask(valid: np.ndarray, n: int) -> np.ndarray:
    """Keep every n-th element of the valid-stream (valid_num % n == 0
    semantics, 1-indexed count like the reference :144-146)."""
    cnt = np.cumsum(valid)
    return valid & (cnt % n == 0)


def decode_avia(
    xyz: np.ndarray,  # (N, 3)
    reflectivity: np.ndarray,  # (N,)
    tag: np.ndarray,  # (N,) uint8
    line: np.ndarray,  # (N,) uint8
    offset_time_ns: np.ndarray,  # (N,)
    cfg: PreprocessConfig,
):
    xyz = np.asarray(xyz, np.float64)
    if len(xyz) == 0:
        # Livox drivers emit empty CustomMsgs during startup/stalls;
        # the reference's i=1..point_num loop trivially yields an empty
        # cloud there — match it instead of IndexError-ing below
        return np.zeros((0, 4), np.float32), np.zeros(0, np.float64)
    tag = np.asarray(tag)
    t30 = tag & 0x30
    ok = (np.asarray(line) < cfg.n_scans) & ((t30 == 0x10) | (t30 == 0x00))
    ok[0] = False  # loop starts at i=1 (:139)
    keep = _stride_mask(ok, cfg.point_filter_num)
    # near-duplicate + blind gates (:151-155). The reference compares
    # against pl_full[i-1], which is the ZERO vector unless point i-1
    # was itself tag-valid AND stride-kept (pl_full is only written
    # inside the stride branch, :145-150) — so with point_filter_num>=2
    # the dedup almost always compares against (0,0,0) and passes; a
    # raw-previous comparison (the old behavior here) wrongly dropped
    # dual-return repeats the reference keeps.
    prev_written = np.roll(keep, 1)
    prev_written[0] = False
    prev = np.where(prev_written[:, None], np.roll(xyz, 1, axis=0), 0.0)
    dedup = np.any(np.abs(xyz - prev) > 1e-7, axis=1)
    r2 = np.sum(xyz * xyz, axis=1)
    keep &= dedup & (r2 > cfg.blind * cfg.blind)
    pts = np.concatenate(
        [xyz[keep], np.asarray(reflectivity, np.float64)[keep, None]], axis=1
    ).astype(np.float32)
    t_rel = np.asarray(offset_time_ns, np.float64)[keep] * 1e-9
    return pts, t_rel


def decode_velodyne(
    xyz: np.ndarray,
    intensity: np.ndarray,
    time_s: np.ndarray,  # per-point offset seconds (or zeros)
    ring: np.ndarray,
    cfg: PreprocessConfig,
):
    xyz = np.asarray(xyz, np.float64)
    N = len(xyz)
    t = np.asarray(time_s, np.float64).copy()
    ring = np.asarray(ring)
    consumed = np.zeros(N, bool)  # first point per ring is consumed (:335)
    if not (N and t[-1] > 0):  # offsets not given: yaw reconstruction
        omega = 0.361 * 10  # deg/ms (:271)
        yaw = np.degrees(np.arctan2(xyz[:, 1], xyz[:, 0]))
        for layer in range(cfg.n_scans):
            m = np.where(ring == layer)[0]
            if len(m) == 0:
                continue
            yf = yaw[m[0]]
            off = np.where(yaw[m] <= yf, (yf - yaw[m]) / omega,
                           (yf - yaw[m] + 360.0) / omega)
            # monotonicity fix (:344): the reference adds AT MOST ONE
            # 360/omega correction per point, against the running
            # CORRECTED time_last — once a wrap occurs every subsequent
            # candidate (bounded by one period) is below the corrected
            # last, so the +period sticks for the rest of the ring but
            # never compounds (a cumsum of raw decreases double-counted
            # jitter wraps)
            dec = np.diff(off) < 0
            wrapped = np.concatenate(
                [[False], np.maximum.accumulate(dec)]) if len(off) else off
            off = off + wrapped * (360.0 / omega)
            off[0] = 0.0
            t[m] = off * 1e-3  # ms -> s
            consumed[m[0]] = True
    # the stride runs on the RAW point index (i % point_filter_num ==
    # 0, :421), independent of ring validity / first-point skips —
    # unlike the AVIA handler's valid-stream count
    ok = (ring < cfg.n_scans) & ~consumed
    keep = ok & (np.arange(N) % cfg.point_filter_num == 0)
    r2 = np.sum(xyz * xyz, axis=1)
    keep &= r2 > cfg.blind * cfg.blind
    pts = np.concatenate(
        [xyz[keep], np.asarray(intensity, np.float64)[keep, None]], axis=1
    ).astype(np.float32)
    return pts, t[keep]


def decode_ouster(
    xyz: np.ndarray,
    intensity: np.ndarray,
    t_ns: np.ndarray,
    ring: np.ndarray,
    cfg: PreprocessConfig,
):
    xyz = np.asarray(xyz, np.float64)
    r2 = np.sum(xyz * xyz, axis=1)
    # raw-index stride (i % point_filter_num == 0, :235)
    keep = np.arange(len(xyz)) % cfg.point_filter_num == 0
    keep &= r2 > cfg.blind * cfg.blind
    pts = np.concatenate(
        [xyz[keep], np.asarray(intensity, np.float64)[keep, None]], axis=1
    ).astype(np.float32)
    return pts, np.asarray(t_ns, np.float64)[keep] * 1e-9


def decode_xt32(
    xyz: np.ndarray,
    intensity: np.ndarray,
    timestamp_s: np.ndarray,  # absolute per-point seconds
    cfg: PreprocessConfig,
):
    xyz = np.asarray(xyz, np.float64)
    ts = np.asarray(timestamp_s, np.float64)
    t_rel = ts - (ts[0] if len(ts) else 0.0)
    r2 = np.sum(xyz * xyz, axis=1)
    # raw-index stride (i % point_filter_num == 0, :456)
    keep = np.arange(len(xyz)) % cfg.point_filter_num == 0
    keep &= r2 > cfg.blind  # un-squared blind, reference quirk (:459)
    pts = np.concatenate(
        [xyz[keep], np.asarray(intensity, np.float64)[keep, None]], axis=1
    ).astype(np.float32)
    return pts, t_rel[keep]


def decode(fields: dict, cfg: PreprocessConfig):
    """Dispatch by cfg.lidar_type (Preprocess::process, :43-70).

    `fields` carries vendor-specific numpy arrays, keys as in the
    decode_* signatures."""
    if cfg.feature_extract_enable:
        return decode_features(fields, cfg)
    if cfg.lidar_type == AVIA:
        return decode_avia(
            fields["xyz"], fields["reflectivity"], fields["tag"],
            fields["line"], fields["offset_time_ns"], cfg,
        )
    if cfg.lidar_type == VELO16:
        return decode_velodyne(
            fields["xyz"], fields["intensity"], fields["time_s"],
            fields["ring"], cfg,
        )
    if cfg.lidar_type == OUST64:
        return decode_ouster(
            fields["xyz"], fields["intensity"], fields["t_ns"],
            fields.get("ring"), cfg,
        )
    if cfg.lidar_type == XT32:
        return decode_xt32(
            fields["xyz"], fields["intensity"], fields["timestamp_s"], cfg
        )
    raise ValueError(f"unknown lidar_type {cfg.lidar_type}")


def decode_features(fields: dict, cfg: PreprocessConfig):
    """Feature-extraction path (handlers' `feature_enabled` branches):
    per-ring LOAM classification via features.give_feature; the surf set
    becomes the scan fed to the pipeline (matching the reference, whose
    downstream consumes pl_surf either way)."""
    from .features import extract_features_rings

    xyz = np.asarray(fields["xyz"], np.float64)
    if len(xyz) == 0:  # empty driver message (startup/stall): empty scan
        return np.zeros((0, 4), np.float32), np.zeros(0, np.float64)
    if cfg.lidar_type == AVIA:
        tag = np.asarray(fields["tag"])
        line = np.asarray(fields["line"])
        # feature path accepts ONLY (tag & 0x30) == 0x10 (:101) and
        # applies the dedup + squared-radius blind gate (:96-100)
        prev = np.roll(xyz, 1, axis=0)
        # the reference SKIPS when ANY coordinate delta < 1e-8 (:96-98),
        # i.e. keeping requires ALL three deltas >= 1e-8
        dedup = np.all(np.abs(xyz - prev) >= 1e-8, axis=1)
        dedup[0] = False
        r2 = xyz[:, 0] ** 2 + xyz[:, 1] ** 2
        ok = ((tag & 0x30) == 0x10) & (line <= cfg.n_scans) & dedup & (r2 >= cfg.blind)
        t_ms = np.asarray(fields["offset_time_ns"], np.float64) * 1e-6
        ring = line
    elif cfg.lidar_type == OUST64:
        r2 = np.sum(xyz * xyz, axis=1)
        ok = r2 >= cfg.blind * cfg.blind
        t_ms = np.asarray(fields["t_ns"], np.float64) * 1e-6
        ring = np.asarray(fields["ring"])
    elif cfg.lidar_type == VELO16:
        ok = np.ones(len(xyz), bool)
        t_ms = np.asarray(fields["time_s"], np.float64) * 1e3
        ring = np.asarray(fields["ring"])
    else:
        raise ValueError(
            f"feature extraction unsupported for lidar_type {cfg.lidar_type}"
        )
    surf, corn = extract_features_rings(
        xyz[ok], t_ms[ok], ring[ok], cfg.blind, cfg.point_filter_num,
        cfg.n_scans, cfg.lidar_type,
    )
    pts = np.concatenate(
        [surf[:, :3], np.zeros((len(surf), 1))], axis=1
    ).astype(np.float32)
    t_rel = surf[:, 3] * 1e-3  # ms -> s
    order = np.argsort(t_rel, kind="stable")
    return pts[order], t_rel[order]
