"""The open-addressing voxel-hash point map (`map_backend: hash`) and the
parts every map backend shares: voxel keys, the voxel-coordinate hash,
the neighbourhood offsets and the k-nearest re-rank of a gathered
candidate block.

Port of the JAX package's ops/voxel_map.py, the ikd-Tree replacement
(ikd_Tree.cpp:337-457): a fixed-capacity table over voxel coordinates,
one world point per slot (the point nearest its voxel centre). A slot
holds a 31-bit verification hash of its voxel (`check`), not the
coordinate itself. An insert is a batched probe/claim loop of fixed
depth; a search probes the (2R+1)^3 neighbourhood at a fixed depth, with
no early exit, so hits behind holes left by deletions are still found.
A hole can make a later insert of a stored voxel claim an earlier slot:
a benign duplicate entry, which `rebuild` removes.

Unlike the JAX package, `insert` and `delete_boxes` update the map's
tensors IN PLACE (as tiled_map does); `rebuild` returns a new map.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device

EMPTY_CHECK = -2147483648  # sentinel in check arrays (int32 min)
BIG = 1e30
_U32 = 0xFFFFFFFF
I32, I64 = torch.int32, torch.int64


class VoxelMap(NamedTuple):
    check: torch.Tensor  # (T,) int32 voxel verification hash; EMPTY_CHECK free
    pts: torch.Tensor  # (T, 3) f32 stored world point
    count: torch.Tensor  # () int32 occupied slots
    voxel_size: torch.Tensor  # () f32


def empty_map(table_size: int, voxel_size: float, device=None,
              dtype=torch.float32) -> VoxelMap:
    """A table of `table_size` (a power of two) free slots on `device`,
    CUDA unless given (see device.py)."""
    device = resolve_device(device)
    if table_size & (table_size - 1):
        raise ValueError(f"table_size must be a power of two, got {table_size}")
    return VoxelMap(
        check=torch.full((table_size,), EMPTY_CHECK, dtype=I32, device=device),
        pts=torch.zeros((table_size, 3), dtype=dtype, device=device),
        count=torch.zeros((), dtype=I32, device=device),
        voxel_size=torch.tensor(voxel_size, dtype=dtype, device=device),
    )


def voxel_of(p: torch.Tensor, voxel_size: torch.Tensor) -> torch.Tensor:
    """World point -> int32 voxel coordinate (floor).

    `voxel_size` is a tensor on p's device: dividing by a Python scalar
    lets CUDA multiply by the reciprocal instead, which moves points on
    voxel boundaries into the neighbouring voxel."""
    return torch.floor(p / voxel_size).to(torch.int32)


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on uint32 values held in int64.

    The products of two 32-bit values wrap past 2^63; only their low 32
    bits matter, which the mask keeps."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _U32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _U32
    return h ^ (h >> 16)


def _mix64(keys: torch.Tensor) -> torch.Tensor:
    """Chained 32-bit murmur mixes over an int32 voxel coordinate
    (..., 3) -> (...,) int64 holding the uint32 hash. Bit-identical to
    `_mix64_np`, negative coordinates included (two's complement)."""
    u = keys.to(torch.int64) & _U32
    h = _fmix32((u[..., 0] * 0x9E3779B1) & _U32)
    h = _fmix32(h ^ ((u[..., 1] * 0x85EBCA77) & _U32))
    return _fmix32(h ^ ((u[..., 2] * 0xC2B2AE3D) & _U32))


def _check31(keys: torch.Tensor) -> torch.Tensor:
    """31-bit verification hash of a coordinate, as int32 (never the
    EMPTY_CHECK sentinel)."""
    return (_mix64(keys) & 0x7FFFFFFF).to(torch.int32)


def _slot_check(keys: torch.Tensor, mask: int):
    """One mix, two outputs: the probe slot (high bits, int32, `& mask`)
    and the 31-bit verification hash (low bits, int32, never the
    EMPTY_CHECK sentinel). Bit-identical to the JAX package's."""
    z = _mix64(keys)
    slot = (z >> 13).to(torch.int32) & mask
    check = (z & 0x7FFFFFFF).to(torch.int32)
    return slot, check


def _mix64_np(keys) -> np.ndarray:
    """Host-side numpy twin of `_mix64` (uint32 arithmetic that wraps)."""

    def fmix32(h):
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        return h ^ (h >> np.uint32(16))

    u = np.asarray(keys).astype(np.uint32)
    with np.errstate(over="ignore"):
        h = fmix32(u[..., 0] * np.uint32(0x9E3779B1))
        h = fmix32(h ^ (u[..., 1] * np.uint32(0x85EBCA77)))
        return fmix32(h ^ (u[..., 2] * np.uint32(0xC2B2AE3D)))


def _neighbor_offsets(radius: int) -> np.ndarray:
    """(M, 3) int32 neighbourhood offsets, near voxels first so that
    ties in the nearest-neighbour selection favour close cells."""
    r = np.arange(-radius, radius + 1, dtype=np.int32)
    g = np.stack(np.meshgrid(r, r, r, indexing="ij"), axis=-1).reshape(-1, 3)
    return g[np.argsort(np.sum(g * g, axis=-1), kind="stable")]


@functools.cache
def neighbor_offsets(radius: int, device: torch.device) -> torch.Tensor:
    """(M, 3) int32 neighbourhood offsets (`_neighbor_offsets` order) on
    `device`, uploaded once: a search then copies nothing from the host
    and never waits for the device."""
    return torch.as_tensor(_neighbor_offsets(radius), device=device)


def _sq3(e: torch.Tensor) -> torch.Tensor:
    """Squared norm over the last axis of (..., 3), summed x, y, z."""
    return e[..., 0] * e[..., 0] + e[..., 1] * e[..., 1] + e[..., 2] * e[..., 2]


def _last_wins(index: torch.Tensor, keep: torch.Tensor, size: int) -> torch.Tensor:
    """(B,) bool: the row that a duplicate-index `set` scatter keeps, as
    XLA on the CPU applies updates in row order (the last one stays).
    `index` in [0, size); rows with keep False take no part."""
    B = index.shape[0]
    row = torch.arange(B, dtype=I64, device=index.device)
    tgt = torch.where(keep, index.to(I64), torch.full_like(row, size))
    last = torch.full((size + 1,), -1, dtype=I64, device=index.device)
    last.scatter_reduce_(0, tgt, torch.where(keep, row, -1), "amax")
    return keep & (last[tgt] == row)


def _lexsort(last: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """jnp.lexsort((last, keys[:, 0], keys[:, 1], keys[:, 2])): keys[:, 2]
    primary, then keys[:, 1], keys[:, 0], `last`, then the row. Stable
    argsorts from the least significant key."""
    order = torch.argsort(last, stable=True)
    for j in (0, 1, 2):
        order = order[torch.argsort(keys[order, j], stable=True)]
    return order


def insert(m: VoxelMap, pts: torch.Tensor, valid: torch.Tensor,
           max_probe: int = 12) -> VoxelMap:
    """Insert a batch of world points with voxel downsampling, in place:
    per voxel the point nearest its centre survives, among the batch and
    the stored point (ikd_Tree.cpp:391-417).

    The batch is first reduced to one row per voxel (sorted by voxel and
    distance to the centre); the winners then probe `max_probe`
    consecutive slots. A free slot is claimed; when two voxels claim one
    slot in the same round, the later row in sorted order keeps it (the
    JAX package's duplicate-index scatter on the CPU), and a row learns
    that it won by reading the slot back. The writes go through copies
    of the table with one spare row, which takes the masked-out writes."""
    T = m.check.shape[0]
    mask = T - 1
    dev = pts.device
    vs = m.voxel_size
    keys = voxel_of(pts, vs)
    slot0, checks = _slot_check(keys, mask)
    center = (keys.to(pts.dtype) + 0.5) * vs
    d2c = torch.where(valid, _sq3(pts - center), torch.full((), BIG, dtype=pts.dtype,
                                                             device=dev))

    # in-batch dedup: the nearest-to-centre row heads each voxel's run
    order = _lexsort(d2c, keys)
    keys_s = keys[order]
    pts_s = pts[order]
    checks_s = checks[order]
    same = torch.all(keys_s == torch.roll(keys_s, 1, dims=0), dim=-1)
    same[:1] = False
    winner = valid[order] & ~same

    tc = torch.cat([m.check, m.check.new_full((1,), EMPTY_CHECK)])
    tp = torch.cat([m.pts, m.pts.new_zeros((1, 3))])
    cnt = m.count
    slot = slot0[order].to(I64)
    done = ~winner
    center_s = (keys_s.to(pts.dtype) + 0.5) * vs
    d2c_s = _sq3(pts_s - center_s)
    for _ in range(max_probe):
        cur = tc[slot]
        is_empty = cur == EMPTY_CHECK
        is_mine = (cur == checks_s) & ~done
        claim = is_empty & ~done
        tc[torch.where(_last_wins(slot, claim, T), slot, T)] = checks_s
        won = claim & (tc[slot] == checks_s)
        # nearest-to-centre replacement for voxels already stored
        write = won | (is_mine & (d2c_s < _sq3(tp[slot] - center_s)))
        tp[torch.where(_last_wins(slot, write, T), slot, T)] = pts_s
        cnt = cnt + won.sum(dtype=I32)
        done = done | is_mine | won
        slot = (slot + 1) & mask
    m.check.copy_(tc[:T])
    m.pts.copy_(tp[:T])
    return m._replace(count=cnt)


def knn_candidates(m: VoxelMap, queries: torch.Tensor, radius: int = 2,
                   max_probe: int = 12):
    """The (2 * radius + 1)^3-voxel candidate block around each query:
    (cpts (N, M, 3), found (N, M)). Each neighbourhood voxel probes
    `max_probe` slots (one int32 gather each); a row not found gathers
    the table's last point, as the JAX package does."""
    T = m.check.shape[0]
    mask = T - 1
    base = voxel_of(queries, m.voxel_size)
    cand = base[:, None, :] + neighbor_offsets(radius, queries.device)[None]
    slot, qcheck = _slot_check(cand, mask)
    slot = slot.to(I64)
    found = torch.zeros(slot.shape, dtype=torch.bool, device=queries.device)
    resolved = torch.full_like(slot, T)
    for _ in range(max_probe):
        hit = (m.check[slot] == qcheck) & ~found
        resolved = torch.where(hit, slot, resolved)
        found = found | hit
        slot = (slot + 1) & mask
    safe = torch.clamp(resolved, max=T - 1)
    cpts = m.pts[safe.reshape(-1)].reshape(*cand.shape[:2], 3)
    return cpts, found


def knn(m: VoxelMap, queries: torch.Tensor, k: int = 5, radius: int = 2,
        max_probe: int = 12):
    """Bounded k-NN (KD_TREE::Nearest_Search, ikd_Tree.cpp:350-380):
    (neigh (N, k, 3), d2 (N, k), nvalid (N, k))."""
    cpts, found = knn_candidates(m, queries, radius, max_probe)
    return topk_from_candidates(cpts, found, queries, k)


def in_boxes(pts: torch.Tensor, occupied: torch.Tensor, voxel_size: torch.Tensor,
             boxes_lo: torch.Tensor, boxes_hi: torch.Tensor) -> torch.Tensor:
    """(T,) bool: the occupied entries whose voxel centre, recomputed from
    the stored point, lies in any of the boxes (B, 3). A box with lo > hi
    holds nothing."""
    centers = (voxel_of(pts, voxel_size).to(pts.dtype) + 0.5) * voxel_size
    inside = torch.zeros_like(occupied)
    for b in range(boxes_lo.shape[0]):
        inside |= (torch.all(centers >= boxes_lo[b], dim=-1)
                   & torch.all(centers <= boxes_hi[b], dim=-1))
    return occupied & inside


def delete_boxes(m: VoxelMap, boxes_lo: torch.Tensor,
                 boxes_hi: torch.Tensor) -> VoxelMap:
    """Free, in place, the slots whose voxel centre lies in any box
    (Delete_Point_Boxes, ikd_Tree.cpp:501, driven by
    lasermap_fov_segment, laserMapping.cpp:363-421)."""
    kill = in_boxes(m.pts, m.check != EMPTY_CHECK, m.voxel_size, boxes_lo, boxes_hi)
    m.check.masked_fill_(kill, EMPTY_CHECK)
    return m._replace(count=m.count - kill.sum(dtype=I32))


def rebuild(m: VoxelMap) -> VoxelMap:
    """Full compaction into a new table: every occupied slot re-inserted,
    at a deeper probe (32) than the per-frame insert's, so that no entry
    is dropped at a high load. Removes duplicate entries and probe chains
    broken by deletions (the ikd-Tree's background rebuild,
    ikd_Tree.cpp:187-301)."""
    fresh = VoxelMap(
        check=torch.full_like(m.check, EMPTY_CHECK), pts=torch.zeros_like(m.pts),
        count=torch.zeros_like(m.count), voxel_size=m.voxel_size)
    return insert(fresh, m.pts, m.check != EMPTY_CHECK, max_probe=32)


def extract_points(m: VoxelMap):
    """(pts (L, 3), count): all live map points, on the host."""
    occ = m.check.cpu().numpy() != EMPTY_CHECK
    pts = m.pts.cpu().numpy()[occ]
    return pts, len(pts)


def topk_from_candidates(cpts: torch.Tensor, found: torch.Tensor,
                         queries: torch.Tensor, k: int):
    """Rank a gathered candidate block (N, M, 3) against the queries and
    return the k nearest: (neigh (N, k, 3), d2 (N, k), nvalid (N, k)).

    A stable ascending sort breaks ties toward the lower candidate row,
    as `lax.top_k` does; `torch.topk` promises no tie order on CUDA."""
    diff = cpts - queries[:, None, :]
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
          + diff[..., 2] * diff[..., 2])
    d2 = torch.where(found, d2, torch.full_like(d2, BIG))
    nd2, idx = torch.sort(d2, dim=1, stable=True)
    nd2, idx = nd2[:, :k], idx[:, :k]
    nvalid = nd2 < BIG * 0.5
    neigh = torch.take_along_dim(cpts, idx[..., None], dim=1)
    neigh = torch.where(nvalid[..., None], neigh, torch.zeros_like(neigh))
    return neigh, nd2, nvalid
