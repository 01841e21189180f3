"""Parts shared by the map backends: voxel keys, the voxel-coordinate
hash and the k-nearest re-rank of a gathered candidate block.

Port of the shared half of the JAX package's ops/voxel_map.py. The
open-addressing hash backend itself is not ported yet; the tiled map
(ops/tiled_map.py) is the default backend and the one the port runs.
"""
from __future__ import annotations

import numpy as np
import torch

EMPTY_CHECK = -2147483648  # sentinel in check arrays (int32 min)
BIG = 1e30
_U32 = 0xFFFFFFFF


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
