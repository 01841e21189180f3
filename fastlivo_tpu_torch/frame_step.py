"""The per-scan device step of the steady-state lidar frame.

Port of the JAX package's frame_step.py: undistortion (imu.undistort)
-> voxel filter (ops.voxel_filter.voxel_downsample_device) -> iterated
EKF (lio.lio_update) -> map insertion (the map backend's insert). The
JAX package fuses these into one jit and donates the map buffers; here
they run eagerly and the map is updated in place. Each stage is a named
`record_function` range ("frame.*"), which torch.profiler reports.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from . import imu as imu_mod
from . import lio as lio_mod
from .ops import tiled_map as tm
from .ops import voxel_filter as vf
from .state import NavState, pack24


def stage_scan(w: torch.Tensor, R: int):
    """One packed (B+1, 4) f32 array -> ((R, 3) pts, (R,) t_rel, (R,)
    mask). Rows [0:B] carry [x y z t_rel]; row B carries the live count
    in column 0. B is the caller's pow2 bucket >= the scan size."""
    B = w.shape[0] - 1
    n = w[B, 0].to(torch.int32)
    pts = w[:B, 0:3]
    trel = w[:B, 3]
    if B < R:
        pts = torch.cat([pts, torch.zeros((R - B, 3), dtype=w.dtype, device=w.device)])
        trel = torch.cat([trel, torch.zeros(R - B, dtype=w.dtype, device=w.device)])
    mask = torch.arange(R, device=w.device) < n
    return pts.contiguous(), trel.contiguous(), mask


def lidar_frame_step(
    state: NavState,  # propagated prior at scan end
    m,  # any map backend, updated IN PLACE by the insert
    pose: imu_mod.PoseTable,  # merged per-scan table
    calib: imu_mod.ImuCalib,
    pts_raw: torch.Tensor,  # (R, 3) raw lidar-frame points
    t_rel: torch.Tensor,  # (R,)
    rmask: torch.Tensor,  # (R,)
    filter_size_surf: torch.Tensor,  # 0-d f32 on the device
    laser_point_cov: float,
    max_points: int,
    max_iter: int,
    knn_radius: int,
    max_probe: int = 12,
    dense_out: bool = True,
    cache_knn: bool = False,
    plane_fit: str = "tls",
):
    """Returns (posterior state, map, down (max_points, 3), dmask,
    n_active, iters, pts_world_dense (R, 3) | zeros, active (max_points,),
    stats (29,) f64).

    `stats` packs [n_down, n_active, iters, pack24(posterior),
    residual_rms, map_occupancy] so the host reads every scalar it needs
    in one transfer. residual_rms is the posterior point-to-plane RMS
    over the active rows (the online filter-health signal);
    map_occupancy is the tiled map's allocated tiles or the hash and
    dense maps' occupied entries. `max_probe` is the hash map's probe
    depth, for the search and the insert."""
    with record_function("frame.undistort"):
        und = imu_mod.undistort(state, pose, pts_raw, t_rel, rmask, calib)
    with record_function("frame.voxel_filter"):
        down, dmask = vf.voxel_downsample_device(und, rmask, filter_size_surf,
                                                 max_points)
    with record_function("frame.lio_update"):
        res = lio_mod.lio_update(
            state, m, down, dmask, calib.lid_rot, calib.lid_off,
            laser_point_cov=laser_point_cov, max_iter=max_iter,
            knn_radius=knn_radius, plane_fit=plane_fit, cache_knn=cache_knn,
            max_probe=max_probe,
        )
    # map insert at the posterior (map_incremental, laserMapping.cpp:692):
    # res.pts_world IS the downsampled batch at the posterior pose
    mod = lio_mod.map_module(m)
    with record_function("frame.map_insert"):
        m2 = mod.insert(m, res.pts_world, dmask, max_probe)
    occ = m2.n_alloc if mod is tm else m2.count
    dense_world, stats = frame_outputs(res.state, res.n_active, res.iters, res.active,
                                       res.res, dmask, und, rmask, calib, occ, dense_out)
    return (res.state, m2, down, dmask, res.n_active, res.iters,
            dense_world, res.active, stats)


def frame_outputs(post: NavState, n_active, iters, active, resid, dmask, und, rmask,
                  calib: imu_mod.ImuCalib, occ, dense_out: bool):
    """The frame's dense world cloud (R, 3) at the posterior (zeros (1, 3)
    without `dense_out`) and its stats row (see lidar_frame_step);
    `active` and `resid` cover the whole downsampled batch, `occ` is the
    map occupancy, `iters` a host int or a device int (the LIO cascade's,
    which reaches the host with the stats row, no read of its own)."""
    f64 = torch.float64
    dev = und.device
    if dense_out:
        rot32 = post.rot.to(und.dtype)
        pos32 = post.pos.to(und.dtype)
        dense_world = (und @ calib.lid_rot.T + calib.lid_off) @ rot32.T + pos32
        dense_world = torch.where(rmask[:, None], dense_world,
                                  torch.zeros_like(dense_world))
    else:
        dense_world = torch.zeros((1, 3), dtype=und.dtype, device=dev)
    n_act = n_active.to(f64)
    head = torch.stack([dmask.sum().to(f64), n_act,
                        torch.as_tensor(iters, device=dev).to(f64).reshape(())])
    act_res = torch.where(active, resid.to(f64), torch.zeros((), dtype=f64, device=dev))
    res_rms = torch.sqrt(torch.sum(act_res ** 2) / torch.clamp(n_act, min=1.0))
    stats = torch.cat([head, pack24(post), res_rms[None], occ.to(f64)[None]])
    return dense_world, stats
