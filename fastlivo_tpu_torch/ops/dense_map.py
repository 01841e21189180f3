"""Dense rolling-grid point map (`map_backend: dense`).

Port of the JAX package's ops/dense_map.py, the direct-indexed
ikd-Tree replacement: a dense 3-D grid with wrap-around indexing (cell =
voxel coordinate mod the grid dims), one world point per cell. A lookup
is one computed index: no probe loop. A per-cell 31-bit verification
hash rejects aliased content (voxels a grid period apart), and an
aliased insert evicts the stale occupant, so memory stays dims^3 cells
whatever the trajectory's length.

Memory: dims (256, 256, 64) cost 16 B a cell, 67 MB; at 0.5 m voxels
they span 128 x 128 x 32 m.

As in the port's other maps, `insert` and `delete_boxes` update the
map's tensors IN PLACE.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .photometric import _require, _ticket
# delete_boxes: the hash map's (one layout), in place, count a new tensor:
# `flat_delete_boxes` on CUDA, `delete_boxes_plain` on the CPU
from .voxel_map import (  # noqa: F401
    BIG, EMPTY_CHECK, I32, I64, _check31, _check_flat, _mix64_np, _raise_on, _sq3, _stream,
    delete_boxes, delete_boxes_plain, neighbor_offsets, topk_from_candidates, voxel_of,
)


class DenseMap(NamedTuple):
    check: torch.Tensor  # (G,) int32 voxel verification hash; EMPTY_CHECK free
    pts: torch.Tensor  # (G, 3) f32 stored world point
    count: torch.Tensor  # () int32 occupied cells
    voxel_size: torch.Tensor  # () f32
    log2_dims: torch.Tensor  # (3,) int32 log2 of the grid dims


def _log2_dims(dims) -> list:
    for d in dims:
        if d & (d - 1):
            raise ValueError(f"dims must be powers of two, got {dims}")
    return [int(np.log2(d)) for d in dims]


def empty_dense_map(dims: tuple, voxel_size: float, device=None,
                    dtype=torch.float32) -> DenseMap:
    """dims (Nx, Ny, Nz), each a power of two; on `device`, CUDA unless
    given (see device.py)."""
    device = resolve_device(device)
    l2 = _log2_dims(dims)
    G = dims[0] * dims[1] * dims[2]
    return DenseMap(
        check=torch.full((G,), EMPTY_CHECK, dtype=I32, device=device),
        pts=torch.zeros((G, 3), dtype=dtype, device=device),
        count=torch.zeros((), dtype=I32, device=device),
        voxel_size=torch.tensor(voxel_size, dtype=dtype, device=device),
        log2_dims=torch.tensor(l2, dtype=I32, device=device),
    )


def _cell_check(m: DenseMap, keys: torch.Tensor):
    """int32 voxel coords (..., 3) -> (flat wrapped cell index, verify
    hash). The `&` of a negative coordinate wraps it as two's complement,
    as in the JAX package."""
    l2 = m.log2_dims
    one = torch.ones((), dtype=I32, device=l2.device)
    kx = keys[..., 0] & ((one << l2[0]) - 1)
    ky = keys[..., 1] & ((one << l2[1]) - 1)
    kz = keys[..., 2] & ((one << l2[2]) - 1)
    flat = (kx << (l2[1] + l2[2])) | (ky << l2[2]) | kz
    return flat, _check31(keys)


def insert_plain(m: DenseMap, pts: torch.Tensor, valid: torch.Tensor,
                 max_probe: int = 0) -> DenseMap:
    """`insert` in torch ops, on any device (the kernel dense_insert's
    oracle). The batch's winner per cell is one packed int64 scatter-min
    of (distance bits, row), so ties go to the lower row; its writes go
    through `torch.nonzero`, which sizes its result on the host."""
    _check_rows(pts.shape[0])
    G = m.check.shape[0]
    dev = pts.device
    vs = m.voxel_size
    keys = voxel_of(pts, vs)
    cell, check = _cell_check(m, keys)
    cell = cell.to(I64)
    center = (keys.to(pts.dtype) + 0.5) * vs
    d2c = torch.where(valid, _sq3(pts - center),
                      torch.full((), BIG, dtype=pts.dtype, device=dev))

    # a non-negative float's bit pattern orders like its value
    row = torch.arange(pts.shape[0], dtype=I64, device=dev)
    packed = (d2c.to(torch.float32).view(I32).to(I64) << 24) | row
    tgt = torch.where(valid, cell, torch.full_like(cell, G))  # G: dropped
    cell_min = torch.full((G + 1,), torch.iinfo(I64).max, dtype=I64, device=dev)
    cell_min.scatter_reduce_(0, tgt, packed, "amin")
    is_winner = valid & ((cell_min[cell] & 0xFFFFFF) == row)

    cur = m.check[cell]
    stored_d2c = _sq3(m.pts[cell] - center)
    is_empty = cur == EMPTY_CHECK
    is_mine = cur == check
    aliased = ~is_empty & ~is_mine  # stale occupant: evict
    write = is_winner & (is_empty | aliased | (is_mine & (d2c < stored_d2c)))
    rows = torch.nonzero(write).squeeze(1)  # one winner per cell: unique
    m.check[cell[rows]] = check[rows]
    m.pts[cell[rows]] = pts[rows]
    return m._replace(count=m.count + (write & is_empty).sum(dtype=I32))


def _check_rows(B: int) -> None:
    if B >= 1 << 24:
        raise ValueError(f"dense insert packs the batch row into 24 bits; split "
                         f"batches of {B} rows")


@functools.cache
def _insert_launcher():
    from . import _build

    fn = _build.load("dense_insert").dense_insert_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return _build.profiled("dense_insert", fn)


def dense_insert(m: DenseMap, pts: torch.Tensor, valid: torch.Tensor) -> DenseMap:
    """`insert_plain`'s result: on a CUDA map one cooperative launch of
    csrc/dense_insert.cu (counted in `dense_insert.launches`, also at B =
    0; its blocks in `dense_insert.grid`), the grid written in place and
    the count a new tensor, with no host read; its per-cell minimum lives
    in the stream's scratch (`photometric._ticket`, G int64), left at 0.
    On a CPU map the plain version."""
    if m.check.device.type == "cpu":
        return insert_plain(m, pts, valid)
    _check_rows(pts.shape[0])
    dev, B, G = _check_flat("dense_insert", m, pts, valid)
    _require("dense_insert: log2_dims", m.log2_dims, (3,), I32, dev)
    count = torch.empty((), dtype=I32, device=dev)
    stream = _stream(dev)
    scratch = _ticket(dev, stream, 2 * G)  # G int64 zeros, left at 0
    grid = ctypes.c_int(0)
    _raise_on("dense_insert", _insert_launcher()(
        pts.data_ptr(), valid.data_ptr(), m.voxel_size.data_ptr(), m.log2_dims.data_ptr(),
        m.check.data_ptr(), m.pts.data_ptr(), m.count.data_ptr(), count.data_ptr(),
        scratch.data_ptr(), B, EMPTY_CHECK, ctypes.byref(grid), stream))
    dense_insert.launches += 1
    dense_insert.grid = grid.value
    return m._replace(count=count)


dense_insert.launches = 0
dense_insert.grid = 0


def insert(m: DenseMap, pts: torch.Tensor, valid: torch.Tensor,
           max_probe: int = 0) -> DenseMap:
    """Insert-with-downsample, in place (ikd_Tree.cpp:391-417; count is a
    new tensor): per voxel the point nearest its centre among the batch
    and the stored point; an aliased occupant (another voxel in the same
    wrapped cell) is evicted. A map on CUDA runs the kernel
    `dense_insert`, a map on the CPU `insert_plain`. No other device is
    taken and nothing falls back. `max_probe` is ignored (the hash map's
    argument)."""
    dev = m.check.device
    if dev.type == "cpu":
        return insert_plain(m, pts, valid)
    if dev.type != "cuda":
        raise ValueError(f"insert: unsupported device {dev}")
    return dense_insert(m, pts.contiguous(), valid)


def knn_candidates(m: DenseMap, queries: torch.Tensor, radius: int = 1,
                   max_probe: int = 0):
    """Direct-indexed neighbourhood candidate block: (cpts (N, M, 3),
    found (N, M)), M = (2 * radius + 1)^3. `max_probe` is ignored."""
    base = voxel_of(queries, m.voxel_size)
    cand = base[:, None, :] + neighbor_offsets(radius, queries.device)[None]
    cell, qcheck = _cell_check(m, cand)
    cell = cell.to(I64)
    found = m.check[cell] == qcheck
    cpts = m.pts[cell.reshape(-1)].reshape(*cand.shape[:2], 3)
    return cpts, found


def knn(m: DenseMap, queries: torch.Tensor, k: int = 5, radius: int = 1,
        max_probe: int = 0):
    """Bounded k-NN over direct neighbourhood lookups: (neigh (N, k, 3),
    d2 (N, k), nvalid (N, k)). `max_probe` is ignored."""
    cpts, found = knn_candidates(m, queries, radius)
    return topk_from_candidates(cpts, found, queries, k)


def extract_points(m: DenseMap):
    """(pts (L, 3), count): all live map points, on the host."""
    occ = m.check.cpu().numpy() != EMPTY_CHECK
    pts = m.pts.cpu().numpy()[occ]
    return pts, len(pts)


def build_host(pts: np.ndarray, dims=(256, 256, 64), voxel_size=0.5,
               device=None) -> DenseMap:
    """Bulk map construction on the host (numpy), equal to one `insert`
    of the whole batch into an empty map: per wrapped cell the point
    nearest its own voxel centre wins, ties to the lower row. The map is
    moved to `device`, CUDA unless given (see device.py)."""
    device = resolve_device(device)
    l2 = _log2_dims(dims)
    pts = np.asarray(pts, np.float32)
    vs = np.float32(voxel_size)
    keys = np.floor(pts / vs).astype(np.int32)
    center = (keys.astype(np.float32) + 0.5) * vs
    d2c = np.sum((pts - center) ** 2, axis=1)
    kx = keys[:, 0] & ((1 << l2[0]) - 1)
    ky = keys[:, 1] & ((1 << l2[1]) - 1)
    kz = keys[:, 2] & ((1 << l2[2]) - 1)
    cell = ((kx.astype(np.int64) << (l2[1] + l2[2]))
            | (ky.astype(np.int64) << l2[2]) | kz.astype(np.int64))
    chk = (_mix64_np(keys) & np.uint32(0x7FFFFFFF)).astype(np.int32)
    order = np.lexsort((d2c, cell))
    cs = cell[order]
    head = np.ones(len(cs), bool)
    head[1:] = cs[1:] != cs[:-1]
    win = order[head]
    G = dims[0] * dims[1] * dims[2]
    check = np.full(G, EMPTY_CHECK, np.int32)
    pool = np.zeros((G, 3), np.float32)
    check[cell[win]] = chk[win]
    pool[cell[win]] = pts[win]

    def dev(a):
        return torch.as_tensor(a, device=device)

    return DenseMap(check=dev(check), pts=dev(pool), count=dev(np.int32(len(win))),
                    voxel_size=dev(np.float32(voxel_size)),
                    log2_dims=dev(np.asarray(l2, np.int32)))
