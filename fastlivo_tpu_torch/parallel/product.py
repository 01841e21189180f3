"""The per-frame steps over a device mesh (`Pipeline(mesh=...)`, `--mesh N`
on the CLIs).

Port of the JAX package's parallel/product.py: `MeshRunner.lidar_frame_step`
has the call and the returns of `frame_step.lidar_frame_step`, and
`MeshRunner.vio_frame_step` those of `vio.vio_frame_step`. Every rank
runs them on the same replicated inputs (SPMD, see sharded.py).

The LiDAR frame:

  - the raw scan's rows are split over the ranks; each undistorts its
    rows and the mesh all-gathers the scan (rank order = row order);
  - the voxel filter runs replicated on the whole scan, so the
    downsampled batch is the single-device one bit for bit;
  - the EKF takes this rank's rows of the downsampled batch and reduces
    [HᵀH | Hᵀz] over the mesh (lio.lio_update(mesh=...)), so every rank
    runs the same 18x18 solve;
  - the map insert: with the replicated map, every rank inserts the whole
    batch at the posterior (the maps stay equal); with `sharded_map`,
    the EKF searches a per-scan halo snapshot gathered from the owners
    (sharded_map.exchange_snapshot) and each rank inserts the tiles it
    owns into its shard.

The camera frame (`vio.vio_frame_step(mesh=...)`): the candidate rows of
the tracked-point search, the grid cells of its gates and warps, the
new-point scoring rows and the photometric EKF's rows split over the
ranks, combined by min / max all-reduces and a rank-order sum of the
photometric partials; the tracked cells are gathered back for the map
updates. With `sharded_map` the image pool and the observation rings
are held in per-rank slabs (visual_map.py), read from their owners and
written by their owners; everything else stays replicated.

Numerical contract against one device: every per-row value is the same;
only the grouping of the f32 [HᵀH | Hᵀz] (and the photometric [HᵀH |
Hᵀz | Σperr]) row sums differs (rank partials summed in rank order). A
mesh of one is the single-device step bit for bit.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from .. import imu as imu_mod
from .. import lio as lio_mod
from .. import vio as vio_mod
from ..frame_step import frame_outputs
from ..ops import tiled_map as tm
from ..ops import voxel_filter as vf
from . import sharded_map as sm
from .sharded import Mesh

class MeshRunner:
    """The mesh frame steps for one rank. `check_capacity` refuses padded
    capacities that the mesh size does not divide (the shipped ones are
    powers of two)."""

    def __init__(self, mesh: Mesh, sharded_map: bool = False, halo_tiles: int = 256,
                 snap_dims: tuple = (128, 128, 64)):
        """`sharded_map`: the map passed to `lidar_frame_step` is this
        rank's shard of a block-sharded tiled map
        (sharded_backend.ShardedTiledBackend), and the EKF searches a
        per-scan halo snapshot of up to `halo_tiles` tiles from each rank,
        whose directory has the map's own dims `snap_dims` (so a wide scan
        box cannot wrap inside it)."""
        self.mesh = mesh
        self.n = mesh.size
        self.sharded_map = sharded_map
        self.halo_tiles = halo_tiles
        self.snap_dims = tuple(snap_dims)

    def check_capacity(self, cap) -> None:
        for name in ("max_raw_points", "max_points"):
            v = getattr(cap, name)
            if v % self.n:
                raise ValueError(
                    f"capacity.{name}={v} is not divisible by the mesh "
                    f"size {self.n}; pad it to a multiple")
        if self.sharded_map:
            for name in ("frame_ring", "vmap_points"):
                v = getattr(cap, name)
                if v % self.n:
                    raise ValueError(
                        f"capacity.{name}={v} is not divisible by the "
                        f"mesh size {self.n} (pool slots and obs-ring "
                        "rows shard in slabs under --sharded-map)")

    def lidar_frame_step(self, state, m, pose, calib, pts_raw, t_rel, rmask,
                         filter_size_surf, laser_point_cov, *, max_points, max_iter,
                         knn_radius, max_probe=12, dense_out=True, cache_knn=False,
                         plane_fit="tls"):
        """`frame_step.lidar_frame_step` over the mesh: the same returns,
        the same on every rank but for the map (this rank's shard under
        `sharded_map`)."""
        mesh = self.mesh
        if max_points % self.n:
            raise ValueError(f"max_points={max_points} not divisible by mesh size {self.n}")
        with record_function("frame.undistort"):
            rows = mesh.rows(pts_raw.shape[0])
            und = mesh.all_gather(imu_mod.undistort(
                state, pose, pts_raw[rows], t_rel[rows], rmask[rows], calib))
        with record_function("frame.voxel_filter"):
            down, dmask = vf.voxel_downsample_device(und, rmask, filter_size_surf,
                                                     max_points)
        target, halo_dropped = m, None
        if self.sharded_map:
            # the scan's box at the prior pose (down is the same on every
            # rank), padded by the search's reach and 0.5 m for the state's
            # motion across the EKF iterations
            with record_function("frame.halo_exchange"):
                w_prior = ((down @ calib.lid_rot.T + calib.lid_off)
                           @ state.rot.to(down.dtype).T + state.pos.to(down.dtype))
                lo, hi = sm.scan_box(w_prior, dmask)
                pad = (knn_radius + 1) * m.voxel_size + torch.tensor(
                    0.5, dtype=down.dtype, device=down.device)
                target, halo_dropped = sm.exchange_snapshot(
                    m, lo - pad, hi + pad, self.halo_tiles, mesh, dir_dims=self.snap_dims)
        with record_function("frame.lio_update"):
            drows = mesh.rows(max_points)
            res = lio_mod.lio_update(
                state, target, down[drows], dmask[drows], calib.lid_rot, calib.lid_off,
                laser_point_cov=laser_point_cov, max_iter=max_iter,
                knn_radius=knn_radius, plane_fit=plane_fit, cache_knn=cache_knn,
                max_probe=max_probe, mesh=mesh,
            )
        # insert at the replicated posterior (map_incremental,
        # laserMapping.cpp:692): the whole batch into the replicated map,
        # or each rank's owned tiles into its shard
        world = ((down @ calib.lid_rot.T + calib.lid_off) @ res.state.rot.to(down.dtype).T
                 + res.state.pos.to(down.dtype))
        with record_function("frame.map_insert"):
            if self.sharded_map:
                m2 = sm.shard_insert(m, world, dmask, mesh.rank, self.n)
                # halo overflow is data loss for this scan's search: count
                # it in the shard's n_dropped (size capacity.halo_tiles so
                # that it stays 0)
                m2 = m2._replace(n_dropped=m2.n_dropped + halo_dropped)
                # the fullest shard: the binding pool for the compaction trigger
                occ = mesh.all_reduce(m2.n_alloc, "max")
            else:
                m2 = lio_mod.map_module(m).insert(m, world, dmask, max_probe)
                occ = m2.n_alloc if isinstance(m2, tm.TiledMap) else m2.count
        active = mesh.all_gather(res.active)
        dense_world, stats = frame_outputs(
            res.state, res.n_active, res.iters, active, mesh.all_gather(res.res), dmask, und,
            rmask, calib, occ, dense_out)
        return (res.state, m2, down, dmask, res.n_active, res.iters,
                dense_world, active, stats)

    def vio_frame_step(self, vm, cam, state, prior, gray, meta, cloud, Rci, Pci,
                       Jdphi_dR, Jdp_dR, outlier_threshold, ncc_thre, img_point_cov, *,
                       grid_size, patch_size, gw, gh, ncc_en, max_iter, max_pg,
                       robust="none"):
        """`vio.vio_frame_step` over the mesh: the same returns, the same
        on every rank but for the visual map's slabs under `sharded_map`
        (`vm` is then this rank's slabs of the image pool and the
        observation rings)."""
        return vio_mod.vio_frame_step(
            vm, cam, state, prior, gray, meta, cloud, Rci, Pci, Jdphi_dR, Jdp_dR,
            outlier_threshold, ncc_thre, img_point_cov, grid_size=grid_size,
            patch_size=patch_size, gw=gw, gh=gh, ncc_en=ncc_en, max_iter=max_iter,
            max_pg=max_pg, robust=robust, mesh=self.mesh, pool_sharded=self.sharded_map)
