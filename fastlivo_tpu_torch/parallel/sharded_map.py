"""The block-sharded tiled map with a per-scan halo exchange.

Port of the JAX package's parallel/sharded_map.py. The replicated mesh
path (sharded.py) caps the map at one device's memory; here the tiled
map (ops/tiled_map.py) is block-partitioned over the mesh:

  OWNERSHIP: tiles are striped along x in slabs of `slab` tiles (4 tiles
  = 16 m at 0.5 m voxels): owner(tile) = floor(tile_x / slab) mod n.
  Each rank's pool holds only the tiles it owns.

  INSERT: every rank holds the whole world batch (replicated or
  all-gathered), masks it by ownership and inserts into its own shard.

  QUERY (the halo exchange): before the EKF each rank selects its owned
  tiles that meet the scan's box and the mesh all-gathers them into a
  per-scan SNAPSHOT map, the same on every rank. The EKF then runs
  against the snapshot exactly as on a replicated map. The exchange
  moves the scan's working set, not the map.

Where JAX stacks the shards on a leading device axis inside shard_map,
each rank here holds its own `TiledMap` shard; functions take this rank's
shard and its `Mesh`. Writes that JAX scatters with `mode="drop"` write
through a boolean-masked index (unique targets) or keep the last row
where targets repeat, as XLA on the CPU does.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import imu as imu_mod
from .. import lio as lio_mod
from ..ops import tiled_map as tm
from ..ops.voxel_map import EMPTY_CHECK, _last_wins
from ..state import NavState
from .sharded import Mesh

SLAB_TILES = 4  # ownership slab width (tiles) along x


def owner_of(tkey: torch.Tensor, n_dev: int, slab: int = SLAB_TILES) -> torch.Tensor:
    """Tile coords (..., 3) -> owning rank (floor division, right for
    negative coordinates)."""
    return torch.div(tkey[..., 0], slab, rounding_mode="floor").remainder(n_dev)


def make_shards(mesh: Mesh, dims=(128, 128, 64), pool_tiles=4096,
                voxel_size=0.5) -> tm.TiledMap:
    """This rank's empty shard, on its device."""
    return tm.empty_tiled_map(dims, pool_tiles, voxel_size, device=mesh.device)


def shard_insert(local: tm.TiledMap, world: torch.Tensor, wmask: torch.Tensor,
                 my_idx: int, n_dev: int) -> tm.TiledMap:
    """Ownership-masked insert of the whole world batch into this rank's
    shard, in place."""
    tkey, _ = tm._tile_of(tm.voxel_of(world, local.voxel_size))
    mine = wmask & (owner_of(tkey, n_dev) == my_idx)
    return tm.insert(local, world, mine)


def extract_blocks(local: tm.TiledMap, lo: torch.Tensor, hi: torch.Tensor, k_exch: int):
    """Up to k_exch owned tiles whose box meets [lo, hi] (world coords),
    in slot order. Returns (keys (k, 3), cell_check (k, 512),
    pts (k, 512, 3), valid (k,), n_dropped)."""
    T = local.slot_key.shape[0]
    dev = local.slot_key.device
    vs = local.voxel_size
    tile_m = vs * tm.TS
    t_lo = local.slot_key.to(vs.dtype) * tile_m
    t_hi = t_lo + tile_m
    slot = torch.arange(T, dtype=torch.int32, device=dev)
    hit = ((slot < local.n_alloc)
           & torch.all(t_hi >= lo[None, :], dim=-1)
           & torch.all(t_lo <= hi[None, :], dim=-1))
    rank = torch.cumsum(hit.to(torch.int32), 0, dtype=torch.int32) - 1
    sel = hit & (rank < k_exch)
    out = rank[sel].to(torch.int64)
    keys = torch.zeros((k_exch, 3), dtype=torch.int32, device=dev)
    keys[out] = local.slot_key[sel]
    valid = torch.zeros(k_exch, dtype=torch.bool, device=dev)
    valid[out] = True
    slot_of = torch.zeros(k_exch, dtype=torch.int64, device=dev)
    slot_of[out] = slot[sel].to(torch.int64)
    cc = local.cell_check.reshape(T, tm.TC)
    pp = local.pts.reshape(T, tm.TC, 3)
    cells_check = torch.where(valid[:, None], cc[slot_of],
                              torch.full((), EMPTY_CHECK, dtype=torch.int32, device=dev))
    cells_pts = torch.where(valid[:, None, None], pp[slot_of],
                            torch.zeros((), dtype=pp.dtype, device=dev))
    dropped = hit.sum(dtype=torch.int32) - sel.sum(dtype=torch.int32)
    return keys, cells_check, cells_pts, valid, dropped


def build_snapshot(keys, cells_check, cells_pts, valid, voxel_size,
                   dir_dims=(64, 64, 32)) -> tm.TiledMap:
    """A TiledMap from gathered blocks (contiguous, as the fused search
    takes it). Owned tiles are unique across ranks, so directory writes
    collide only where the directory wraps (two tiles dir_dims*8 voxels
    apart inside one scan box); the later row then wins, as in JAX."""
    K = keys.shape[0]
    dev = keys.device
    D = dir_dims[0] * dir_dims[1] * dir_dims[2]
    i32 = dict(dtype=torch.int32, device=dev)
    snap = tm.TiledMap(
        dir_check=torch.full((D,), EMPTY_CHECK, **i32),
        dir_slot=torch.zeros(D, **i32),
        cell_check=cells_check.reshape(K * tm.TC).contiguous(),
        pts=cells_pts.reshape(K * tm.TC, 3).contiguous(),
        slot_key=keys.contiguous(),
        n_alloc=valid.sum(dtype=torch.int32),
        n_dropped=torch.zeros((), **i32),
        voxel_size=voxel_size,
        log2_dims=torch.tensor([int(np.log2(d)) for d in dir_dims], **i32),
    )
    dir_idx, chk = tm._dir_of(snap, keys)
    win = _last_wins(dir_idx, valid, D)
    snap.dir_check[dir_idx[win]] = chk[win]
    snap.dir_slot[dir_idx[win]] = torch.arange(K, **i32)[win]
    return snap


def exchange_snapshot(local: tm.TiledMap, lo, hi, k_exch: int, mesh: Mesh,
                      dir_dims=(64, 64, 32)):
    """The halo exchange: every rank contributes its owned tiles in the
    box and the mesh all-gathers them into the same snapshot on every
    rank. Returns (snapshot, dropped): `dropped` sums, over the mesh, the
    owned tiles in the box that did not fit the k_exch budget; nonzero
    means the snapshot misses map content (raise capacity.halo_tiles)."""
    keys, cc, pp, valid, dropped = extract_blocks(local, lo, hi, k_exch)
    snap = build_snapshot(mesh.all_gather(keys), mesh.all_gather(cc), mesh.all_gather(pp),
                          mesh.all_gather(valid), local.voxel_size, dir_dims=dir_dims)
    return snap, mesh.all_reduce(dropped)


def scan_box(pts_world: torch.Tensor, mask: torch.Tensor):
    """(lo, hi) of the masked rows (f32)."""
    big = torch.tensor(3.0e37, dtype=pts_world.dtype, device=pts_world.device)
    lo = torch.min(torch.where(mask[:, None], pts_world, big), dim=0).values
    hi = torch.max(torch.where(mask[:, None], pts_world, -big), dim=0).values
    return lo, hi


def sharded_blockmap_scan_step(
    mesh: Mesh,
    state: NavState,
    local: tm.TiledMap,  # this rank's shard; updated IN PLACE
    acc_avg, gyr_avg, dt, offs, pair_valid, tail_dt, acc_s_last, angvel_last,
    calib: imu_mod.ImuCalib,
    pts_body, t_rel, pmask,  # replicated; each rank takes its rows
    laser_point_cov: float,
    max_iter: int = 4,
    knn_radius: int = 1,
    k_exch: int = 1024,
):
    """The per-scan step with the block-sharded map: IMU propagation
    (replicated) -> undistortion (this rank's rows) -> halo exchange into
    a scan snapshot -> iterated EKF against it (rows, rank-order
    reductions) -> ownership-masked insert into each rank's shard.
    Returns (state', shard', n_active, snapshot_tiles)."""
    st, pose, _, _ = imu_mod.propagate(
        state, acc_avg, gyr_avg, dt, offs, pair_valid, tail_dt,
        acc_s_last, angvel_last, calib,
    )
    rows = mesh.rows(pts_body.shape[0])
    und = imu_mod.undistort(st, pose, pts_body[rows], t_rel[rows], pmask[rows], calib)
    # the scan's box in world coords at the prior pose, padded by one voxel
    w_prior = ((und @ calib.lid_rot.T + calib.lid_off) @ st.rot.to(und.dtype).T
               + st.pos.to(und.dtype))
    w_lo, w_hi = scan_box(w_prior, pmask[rows])
    w_lo = mesh.all_reduce(w_lo, "min") - 2.0 * local.voxel_size
    w_hi = mesh.all_reduce(w_hi, "max") + 2.0 * local.voxel_size
    snap, _ = exchange_snapshot(local, w_lo, w_hi, k_exch, mesh)
    res = lio_mod.lio_update(
        st, snap, und, pmask[rows], calib.lid_rot, calib.lid_off,
        laser_point_cov=laser_point_cov, max_iter=max_iter,
        knn_radius=knn_radius, mesh=mesh,
    )
    world = mesh.all_gather(res.pts_world)
    wmask = mesh.all_gather(pmask[rows])
    local2 = shard_insert(local, world, wmask, mesh.rank, mesh.size)
    return res.state, local2, res.n_active, snap.n_alloc


def sharded_compact(local: tm.TiledMap) -> tm.TiledMap:
    """Pool compaction of this rank's shard (tiled_map.compact), JAX's
    `sharded_compact` on one shard. Ownership is untouched; no collective,
    so unlike JAX's it takes no mesh."""
    return tm.compact(local)
