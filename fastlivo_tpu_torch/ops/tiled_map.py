"""Tiled two-level point map: the default geometric map backend.

Port of the JAX package's ops/tiled_map.py, replacing the reference's
ikd-Tree (ikd_Tree.cpp:337-457):

  LEVEL 1 — tile directory: a dense rolling grid over 8x8x8-voxel tiles
  (wrap-around indexing plus a 31-bit verification hash of the tile
  coordinate). At 0.5 m voxels and (128, 128, 64) tiles it spans
  512 x 512 x 256 m.

  LEVEL 2 — tile pool: a fixed pool of T tiles of 512 cells, each cell
  holding one point (the on-insert nearest-to-voxel-centre downsample,
  ikd_Tree.cpp:391-411). Tiles are allocated on demand.

Each live cell stores its owning tile's hash, so reusing a pool slot for
another tile invalidates the old cells at no cost; `compact` reclaims
tiles with no live cell.

Unlike the JAX package, `insert` and `delete_boxes` update the map's
tensors IN PLACE (the JAX package donates the map buffers to its fused
step for the same effect); a caller that needs the old map clones it
first. `compact` returns a new map.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .voxel_map import (
    EMPTY_CHECK, _check31, _mix64_np, _neighbor_offsets,
    topk_from_candidates, voxel_of,
)

TS = 8  # tile side (voxels); tile = TS^3 = 512 cells
TC = TS * TS * TS


class TiledMap(NamedTuple):
    dir_check: torch.Tensor  # (D,) int32 tile verification hash; EMPTY_CHECK free
    dir_slot: torch.Tensor  # (D,) int32 pool slot of the tile
    cell_check: torch.Tensor  # (T*512,) int32 == owning tile hash when live
    pts: torch.Tensor  # (T*512, 3) f32 stored world point
    slot_key: torch.Tensor  # (T, 3) int32 tile coordinate per slot
    n_alloc: torch.Tensor  # () int32 allocated slots
    n_dropped: torch.Tensor  # () int32 points dropped on pool exhaustion
    voxel_size: torch.Tensor  # () f32
    log2_dims: torch.Tensor  # (3,) int32 log2 of directory dims (tiles)


def empty_tiled_map(dims=(128, 128, 64), pool_tiles: int = 16384,
                    voxel_size: float = 0.5, device=None,
                    dtype=torch.float32) -> TiledMap:
    """dims: directory extent in tiles (powers of two); span in metres =
    dims * 8 * voxel_size per axis. On `device`, CUDA unless given (see
    device.py)."""
    device = resolve_device(device)
    for d in dims:
        if d & (d - 1):
            raise ValueError(f"dims must be powers of two, got {dims}")
    D = dims[0] * dims[1] * dims[2]
    T = pool_tiles
    i32 = dict(dtype=torch.int32, device=device)
    return TiledMap(
        dir_check=torch.full((D,), EMPTY_CHECK, **i32),
        dir_slot=torch.zeros(D, **i32),
        cell_check=torch.full((T * TC,), EMPTY_CHECK, **i32),
        pts=torch.zeros((T * TC, 3), dtype=dtype, device=device),
        slot_key=torch.zeros((T, 3), **i32),
        n_alloc=torch.zeros((), **i32),
        n_dropped=torch.zeros((), **i32),
        voxel_size=torch.tensor(voxel_size, dtype=dtype, device=device),
        log2_dims=torch.tensor([int(np.log2(d)) for d in dims], **i32),
    )


def _tile_of(keys: torch.Tensor):
    """Voxel coords -> (tile coords, flat in-tile cell offset).
    The arithmetic shift floors negative coordinates correctly."""
    tkey = keys >> 3
    ofs = keys & (TS - 1)
    cofs = (ofs[..., 0] << 6) | (ofs[..., 1] << 3) | ofs[..., 2]
    return tkey, cofs


def _dir_of(m: TiledMap, tkey: torch.Tensor):
    """Tile coords -> (wrapped directory index, verification hash)."""
    l2 = m.log2_dims
    one = torch.ones((), dtype=torch.int32, device=l2.device)
    kx = tkey[..., 0] & ((one << l2[0]) - 1)
    ky = tkey[..., 1] & ((one << l2[1]) - 1)
    kz = tkey[..., 2] & ((one << l2[2]) - 1)
    flat = (kx << (l2[1] + l2[2])) | (ky << l2[2]) | kz
    return flat, _check31(tkey)


def _head(s: torch.Tensor) -> torch.Tensor:
    """True where a sorted array starts a new run of equal values."""
    h = torch.ones_like(s, dtype=torch.bool)
    h[1:] = s[1:] != s[:-1]
    return h


def _scatter_(dst: torch.Tensor, mask: torch.Tensor, idx: torch.Tensor,
              val: torch.Tensor) -> None:
    """dst[idx[mask]] = val[mask]: the masked-out rows write nothing
    (the JAX package's `mode="drop"` scatters). The written indices are
    unique at every call site, so the result is deterministic."""
    dst[idx[mask]] = val[mask]


def insert(m: TiledMap, pts: torch.Tensor, valid: torch.Tensor) -> TiledMap:
    """Insert-with-downsample (ikd_Tree.cpp:391-417 semantics), in place.

    One stable sort serves both winner selections: the key packs
    (dir_idx, in-tile cell, distance-to-centre bits), so the head of
    each dir_idx group is the tile winner and the first surviving row of
    each (dir_idx, cell) group is the nearest-to-centre cell winner."""
    T = m.slot_key.shape[0]
    D = m.dir_check.shape[0]
    if D > 1 << 22:
        raise ValueError("directory too large for the packed sort key")
    B = pts.shape[0]
    dev = pts.device
    vs = m.voxel_size
    keys = voxel_of(pts, vs)
    tkey, cofs = _tile_of(keys)
    dir_idx, chk = _dir_of(m, tkey)

    cur_chk = m.dir_check[dir_idx]
    cur_slot = m.dir_slot[dir_idx]

    center = (keys.to(pts.dtype) + 0.5) * vs
    e = pts - center
    d2c = e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1] + e[:, 2] * e[:, 2]
    # non-negative float: the bit pattern orders like the value
    d2c_bits = d2c.to(torch.float32).view(torch.int32).to(torch.int64)
    gkey = (dir_idx.to(torch.int64) << 40) | (cofs.to(torch.int64) << 31) | d2c_bits
    gkey = torch.where(valid, gkey, torch.full_like(gkey, D << 40))
    order = torch.argsort(gkey, stable=True)
    sg = gkey[order]
    sdir = sg >> 40  # == dir_idx for valid rows, D for invalid
    scell = sg >> 31  # == (dir_idx << 9) | cofs for valid rows
    tile_head = _head(sdir) & (sdir < D)
    cell_head = _head(scell) & (sdir < D)
    is_winner = torch.empty(B, dtype=torch.bool, device=dev)
    is_winner[order] = tile_head

    # aliased tiles reuse the evicted occupant's slot (its old cells
    # self-invalidate by hash mismatch); fresh tiles allocate. Heads of
    # already-live tiles rewrite their current directory values.
    live_dir = cur_chk != EMPTY_CHECK
    aliased = is_winner & live_dir
    fresh = is_winner & ~live_dir
    rank = torch.cumsum(fresh.to(torch.int32), 0, dtype=torch.int32) - 1
    new_slot = m.n_alloc + rank
    overflow = fresh & (new_slot >= T)
    slot_w = torch.where(aliased, cur_slot, new_slot)
    write_dir = is_winner & ~overflow
    _scatter_(m.dir_check, write_dir, dir_idx, chk)
    _scatter_(m.dir_slot, write_dir, dir_idx, slot_w)
    _scatter_(m.slot_key, write_dir, slot_w, tkey)
    n_alloc2 = torch.clamp(
        m.n_alloc + fresh.sum(dtype=torch.int32), max=T).to(torch.int32)

    # re-gather: every point now sees its tile's slot (or a stale entry
    # if its tile winner overflowed the pool -> point dropped)
    got_chk = m.dir_check[dir_idx]
    slot = m.dir_slot[dir_idx]
    ok = valid & (got_chk == chk)
    pool_idx = torch.clamp(slot, 0, T - 1) * TC + cofs

    # cell winner = the FIRST ok row of each (dir_idx, cofs) group in
    # distance order (the group head can be a row of a directory-
    # aliasing losing tile, or a dropped row)
    ok_s = ok[order].to(torch.int32)
    csum = torch.cumsum(ok_s, 0, dtype=torch.int32)
    excl = csum - ok_s
    base = torch.cummax(
        torch.where(cell_head, excl, torch.full_like(excl, -1)), 0).values
    first_ok_s = (ok_s > 0) & (csum - base == 1)
    cell_winner = torch.empty(B, dtype=torch.bool, device=dev)
    cell_winner[order] = first_ok_s

    stored = m.pts[pool_idx]
    stored_live = m.cell_check[pool_idx] == chk
    es = stored - center
    stored_d2c = es[:, 0] * es[:, 0] + es[:, 1] * es[:, 1] + es[:, 2] * es[:, 2]
    write = cell_winner & ok & (~stored_live | (d2c < stored_d2c))
    _scatter_(m.cell_check, write, pool_idx, chk)
    _scatter_(m.pts, write, pool_idx, pts)
    dropped = (valid & ~ok).sum(dtype=torch.int32)
    return m._replace(n_alloc=n_alloc2, n_dropped=m.n_dropped + dropped)


@functools.cache
def neighbor_offsets(radius: int, device: torch.device) -> torch.Tensor:
    """(M, 3) int32 neighbourhood offsets (`_neighbor_offsets` order) on
    `device`, uploaded once: a search then copies nothing from the host
    and never waits for the device."""
    return torch.as_tensor(_neighbor_offsets(radius), device=device)


def candidate_cells(m: TiledMap, queries: torch.Tensor, radius: int = 1):
    """The directory half of `knn_candidates`: for each query and each of
    its M = (2 * radius + 1)^3 neighbourhood voxels, (dir_idx (N, M) the
    directory entry, pool_idx (N, M) the pool cell, tile_ok (N, M) the
    entry holds the voxel's tile, chk (N, M) the tile hash)."""
    T = m.slot_key.shape[0]
    base = voxel_of(queries, m.voxel_size)
    offs = neighbor_offsets(radius, queries.device)
    cand = base[:, None, :] + offs[None, :, :]  # (N, M, 3)
    tkey, cofs = _tile_of(cand)
    dir_idx, chk = _dir_of(m, tkey)
    tile_ok = m.dir_check[dir_idx] == chk
    slot = m.dir_slot[dir_idx]
    pool_idx = torch.clamp(slot, 0, T - 1) * TC + cofs
    return dir_idx, pool_idx, tile_ok, chk


def knn_candidates(m: TiledMap, queries: torch.Tensor, radius: int = 1):
    """Two-gather neighbourhood candidate block: (cpts (N, M, 3),
    found (N, M)) with M = (2 * radius + 1)^3."""
    _, pool_idx, tile_ok, chk = candidate_cells(m, queries, radius)
    found = tile_ok & (m.cell_check[pool_idx] == chk)
    cpts = m.pts[pool_idx.reshape(-1)].reshape(*pool_idx.shape, 3)
    return cpts, found


def knn(m: TiledMap, queries: torch.Tensor, k: int = 5, radius: int = 1):
    """Bounded k-NN over the (2 * radius + 1)^3-voxel neighbourhood:
    (neigh (N, k, 3), d2 (N, k), nvalid (N, k))."""
    cpts, found = knn_candidates(m, queries, radius)
    return topk_from_candidates(cpts, found, queries, k)


def _cell_voxels(m: TiledMap) -> torch.Tensor:
    """(T*512, 3) voxel coordinate of every pool cell."""
    T = m.slot_key.shape[0]
    i = torch.arange(TC, dtype=torch.int32, device=m.slot_key.device)
    ofs = torch.stack([i >> 6, (i >> 3) & 7, i & 7], dim=-1)  # (512, 3)
    return (m.slot_key[:, None, :] * TS + ofs[None, :, :]).reshape(T * TC, 3)


def delete_boxes(m: TiledMap, boxes_lo: torch.Tensor,
                 boxes_hi: torch.Tensor) -> TiledMap:
    """Clear, in place, the cells whose voxel centre lies in any box
    (Delete_Point_Boxes role, ikd_Tree.cpp:501): one elementwise pass
    over the pool with the few boxes unrolled. boxes_lo/hi: (B, 3)."""
    centers = (_cell_voxels(m).to(m.pts.dtype) + 0.5) * m.voxel_size
    kill = torch.zeros(centers.shape[0], dtype=torch.bool,
                       device=centers.device)
    for b in range(boxes_lo.shape[0]):
        kill |= (torch.all(centers >= boxes_lo[b], dim=-1)
                 & torch.all(centers <= boxes_hi[b], dim=-1))
    m.cell_check.masked_fill_(kill, EMPTY_CHECK)
    return m


def compact(m: TiledMap) -> TiledMap:
    """Reclaim pool slots whose tiles have no live cell (the rebuild /
    Criterion_Check role, ikd_Tree.cpp:1018-1035): keeps live tiles in
    allocation order, remaps the directory, resets n_dropped."""
    T = m.slot_key.shape[0]
    dev = m.slot_key.device
    slot_chk = _check31(m.slot_key)
    live = m.cell_check.reshape(T, TC) == slot_chk[:, None]
    allocated = torch.arange(T, dtype=torch.int32, device=dev) < m.n_alloc
    keep = allocated & torch.any(live, dim=1)
    # stable partition: kept slots first, in their original order
    perm = torch.argsort((~keep).to(torch.int32), stable=True)
    inv = torch.empty(T, dtype=torch.int32, device=dev)
    inv[perm] = torch.arange(T, dtype=torch.int32, device=dev)
    remap = torch.where(keep, inv, torch.full_like(inv, -1))

    new_slot = remap[torch.clamp(m.dir_slot, 0, T - 1).to(torch.int64)]
    dir_ok = (m.dir_check != EMPTY_CHECK) & (new_slot >= 0)
    return TiledMap(
        dir_check=torch.where(dir_ok, m.dir_check,
                              torch.full_like(m.dir_check, EMPTY_CHECK)),
        dir_slot=torch.where(dir_ok, new_slot, torch.zeros_like(new_slot)),
        cell_check=m.cell_check.reshape(T, TC)[perm].reshape(T * TC),
        pts=m.pts.reshape(T, TC, 3)[perm].reshape(T * TC, 3),
        slot_key=m.slot_key[perm],
        n_alloc=keep.sum(dtype=torch.int32),
        n_dropped=torch.zeros_like(m.n_dropped),
        voxel_size=m.voxel_size,
        log2_dims=m.log2_dims,
    )


def extract_points(m: TiledMap):
    """(pts (L, 3), count) — all live map points, on the host."""
    T = m.slot_key.shape[0]
    slot_chk = _check31(m.slot_key).cpu().numpy()
    cc = m.cell_check.cpu().numpy().reshape(T, TC)
    alloc = np.arange(T) < int(m.n_alloc)
    live = (cc == slot_chk[:, None]) & alloc[:, None]
    pts = m.pts.cpu().numpy().reshape(T, TC, 3)[live]
    return pts, len(pts)


def build_host(pts: np.ndarray, dims=(128, 128, 64), pool_tiles=16384,
               voxel_size=0.5, device=None) -> TiledMap:
    """Bulk map construction on the host (numpy), matching a sequence of
    `insert` calls in final content: one point per voxel (nearest the
    voxel centre), tiles allocated in first-appearance order,
    directory-aliased tiles resolved last-writer-wins. The map is moved
    to `device`, CUDA unless given (see device.py)."""
    device = resolve_device(device)
    for d in dims:
        if d & (d - 1):
            raise ValueError(f"dims must be powers of two, got {dims}")
    pts = np.asarray(pts, np.float32)
    vs = np.float32(voxel_size)
    keys = np.floor(pts / vs).astype(np.int32)
    center = (keys.astype(np.float32) + 0.5) * vs
    d2c = np.sum((pts - center) ** 2, axis=1)

    tkey = keys >> 3
    cofs = ((keys[:, 0] & 7) << 6) | ((keys[:, 1] & 7) << 3) | (keys[:, 2] & 7)
    l2 = [int(np.log2(d)) for d in dims]
    kx = tkey[:, 0] & ((1 << l2[0]) - 1)
    ky = tkey[:, 1] & ((1 << l2[1]) - 1)
    kz = tkey[:, 2] & ((1 << l2[2]) - 1)
    dir_idx = ((kx.astype(np.int64) << (l2[1] + l2[2]))
               | (ky.astype(np.int64) << l2[2]) | kz.astype(np.int64))
    chk = (_mix64_np(tkey) & np.uint32(0x7FFFFFFF)).astype(np.int32)

    D = dims[0] * dims[1] * dims[2]
    T = pool_tiles

    # unique tiles in first-appearance order; the LAST tile to appear
    # owns an aliased directory cell
    tile_id = (dir_idx << 31) | chk.astype(np.int64)
    _, first_pos = np.unique(tile_id, return_index=True)
    first_pos.sort()
    tiles_di = dir_idx[first_pos]
    tiles_chk = chk[first_pos]
    tiles_key = tkey[first_pos]
    owner_of_di = {}
    for j in range(len(first_pos)):  # loop over unique tiles only (small)
        owner_of_di[int(tiles_di[j])] = j
    owner = np.array([owner_of_di[int(d_)] for d_ in tiles_di], np.int64)
    # only owners take a slot (evicted tiles hold no live cells)
    own_idx = np.nonzero(owner == np.arange(len(tiles_di)))[0][:T]
    n_alloc = len(own_idx)

    dir_check = np.full(D, EMPTY_CHECK, np.int32)
    dir_slot = np.zeros(D, np.int32)
    dir_check[tiles_di[own_idx]] = tiles_chk[own_idx]
    dir_slot[tiles_di[own_idx]] = np.arange(n_alloc, dtype=np.int32)
    slot_key = np.zeros((T, 3), np.int32)
    slot_key[:n_alloc] = tiles_key[own_idx]

    # cells: nearest-to-centre per voxel among owner-tile points; group
    # heads on the MASKED index so a dropped point sharing a raw pool
    # index with a survivor cannot suppress the survivor's write
    ok = dir_check[dir_idx] == chk
    pool_m = np.where(ok, dir_slot[dir_idx].astype(np.int64) * TC + cofs, -1)
    order = np.lexsort((d2c, pool_m))
    ps = pool_m[order]
    headm = np.ones(len(ps), bool)
    headm[1:] = ps[1:] != ps[:-1]
    win = headm & ok[order]
    widx = ps[win]
    cell_check = np.full(T * TC, EMPTY_CHECK, np.int32)
    pool_pts = np.zeros((T * TC, 3), np.float32)
    cell_check[widx] = chk[order][win]
    pool_pts[widx] = pts[order][win]

    def dev(a):
        return torch.as_tensor(a, device=device)

    return TiledMap(
        dir_check=dev(dir_check),
        dir_slot=dev(dir_slot),
        cell_check=dev(cell_check),
        pts=dev(pool_pts),
        slot_key=dev(slot_key),
        n_alloc=dev(np.int32(n_alloc)),
        n_dropped=dev(np.int32(np.sum(~ok))),
        voxel_size=dev(np.float32(voxel_size)),
        log2_dims=dev(np.asarray(l2, np.int32)),
    )
