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

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .photometric import _require, _ticket
from .voxel_map import (
    EMPTY_CHECK, _check31, _mix64_np, _raise_on, _sm_count, _stream, neighbor_offsets,
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


def _drop_rows(mask: torch.Tensor, *idxs: torch.Tensor):
    """The fixed-shape form of a `mode="drop"` scatter's mask: (src (B,),
    some (1,), [at]), where src sends every masked-out row to the first
    written row (a written row to itself), `some` says whether any row is
    written, and each `at` is its idx[src], or row 0 everywhere where no
    row is written. Built once per mask and index, shared by the scatters
    that write through them; no host read sizes any of them."""
    B = mask.shape[0]
    rows = torch.arange(B, device=mask.device)
    if B == 0:
        return rows, torch.zeros(1, dtype=torch.bool, device=mask.device), list(idxs)
    first = torch.amin(torch.where(mask, rows, B)).reshape(1)
    some = first < B
    src = torch.where(mask, rows, torch.clamp(first, max=B - 1))
    return src, some, [torch.where(some, i[src], 0) for i in idxs]


def _scatter_(dst: torch.Tensor, src: torch.Tensor, some: torch.Tensor,
              at: torch.Tensor, val: torch.Tensor) -> None:
    """dst[idx[mask]] = val[mask] (the JAX package's `mode="drop"`
    scatters) for (src, some, [at]) = _drop_rows(mask, idx), with index
    and value tensors of fixed shapes: each masked-out row writes the
    first written row's value at that row's index or, where no row is
    written, dst[0]'s current value at row 0. The written indices are
    unique at every call site, so every duplicate of an index carries one
    value and the result is deterministic."""
    if src.shape[0] == 0:
        return
    dst[at] = torch.where(some.view((1,) * val.ndim), val[src], dst[0])


KEY_BIAS = 1 << 31  # the sort key: (dir_idx << 9 | cell) - 2^31


def insert_keys_plain(m: TiledMap, pts: torch.Tensor, valid: torch.Tensor):
    """The insert's first pass (the kernel tiled_insert_keys' oracle):
    (gkey (B,) int32, rows (5, B) int32). The key is (dir_idx << 9 |
    in-tile cell) - 2^31, negative for every valid row at any directory of
    up to 2^22 entries, and 0 for an invalid row, which sorts after them
    all; rows holds each row's [dir_idx, tile check, cell, distance to the
    voxel centre's bits, 0] (the last row: the tiles pass's winner
    flags)."""
    keys = voxel_of(pts, m.voxel_size)
    tkey, cofs = _tile_of(keys)
    dir_idx, chk = _dir_of(m, tkey)
    center = (keys.to(pts.dtype) + 0.5) * m.voxel_size
    e = pts - center
    d2c = e[:, 0] * e[:, 0] + e[:, 1] * e[:, 1] + e[:, 2] * e[:, 2]
    # non-negative float: the bit pattern orders like the value
    d2c_bits = d2c.to(torch.float32).view(torch.int32)
    cell = (dir_idx.to(torch.int64) << 9) | cofs
    gkey = torch.where(valid, cell - KEY_BIAS, 0).to(torch.int32)
    return gkey, torch.stack([dir_idx, chk, cofs, d2c_bits, torch.zeros_like(chk)])


def _runs(sg: torch.Tensor):
    """Each sorted position's run of equal keys: (the run's index, its
    first position)."""
    new = _head(sg)
    pos = torch.arange(sg.shape[0], device=sg.device)
    return torch.cumsum(new, 0) - 1, torch.cummax(torch.where(new, pos, 0), 0).values


def _least_in_runs(run: torch.Tensor, sbits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """True at the sorted position of each run's least (distance bits,
    position) among the positions in `mask`: the JAX package's first row
    of the run in its (distance, row) order."""
    pos = torch.arange(run.shape[0], device=run.device)
    big = torch.iinfo(torch.int64).max
    v = torch.where(mask, (sbits.to(torch.int64) << 32) | pos, big)
    least = torch.full_like(v, big).scatter_reduce_(0, run, v, "amin")
    return mask & (least[run] == v)


def insert_tiles_plain(m: TiledMap, pts: torch.Tensor, rows: torch.Tensor,
                       sg: torch.Tensor, order: torch.Tensor):
    """The insert's second pass (the tiles pass of the kernel
    tiled_insert_tiles), on the sorted keys `sg` and the stable sort's
    `order`: each dir_idx group's winner is the least (distance bits, row)
    of its first cell run. Writes the winners' directory entries and slot
    keys in place; returns (n_alloc', n_dropped copied)."""
    T = m.slot_key.shape[0]
    B = pts.shape[0]
    dir_idx, chk = rows[0], rows[1]
    tkey = voxel_of(pts, m.voxel_size) >> 3
    sval = sg < 0  # a valid row's key
    tile_head = _head((sg.to(torch.int64) + KEY_BIAS) >> 9) & sval
    run, start = _runs(sg)
    is_winner = torch.empty(B, dtype=torch.bool, device=pts.device)
    is_winner[order] = _least_in_runs(run, rows[3][order], sval) & tile_head[start]

    # aliased tiles reuse the evicted occupant's slot (its old cells
    # self-invalidate by hash mismatch); fresh tiles allocate. Winners of
    # already-live tiles rewrite their current directory values.
    cur_chk = m.dir_check[dir_idx]
    cur_slot = m.dir_slot[dir_idx]
    live_dir = cur_chk != EMPTY_CHECK
    aliased = is_winner & live_dir
    fresh = is_winner & ~live_dir
    rank = torch.cumsum(fresh.to(torch.int32), 0, dtype=torch.int32) - 1
    new_slot = m.n_alloc + rank
    overflow = fresh & (new_slot >= T)
    slot_w = torch.where(aliased, cur_slot, new_slot)
    src, some, (at_dir, at_slot) = _drop_rows(is_winner & ~overflow, dir_idx, slot_w)
    _scatter_(m.dir_check, src, some, at_dir, chk)
    _scatter_(m.dir_slot, src, some, at_dir, slot_w)
    _scatter_(m.slot_key, src, some, at_slot, tkey)
    n_alloc2 = torch.clamp(
        m.n_alloc + fresh.sum(dtype=torch.int32), max=T).to(torch.int32)
    return n_alloc2, m.n_dropped.clone()


def insert_cells_plain(m: TiledMap, pts: torch.Tensor, valid: torch.Tensor,
                       rows: torch.Tensor, sg: torch.Tensor, order: torch.Tensor,
                       n_dropped: torch.Tensor) -> None:
    """The insert's third pass (the cells pass of the kernel
    tiled_insert_tiles), after the directory writes: each (dir_idx, cell)
    run's least (distance bits, row) ok row replaces its stored cell where
    that is dead or farther. Writes the cells in place and adds the
    dropped rows to `n_dropped`."""
    T = m.slot_key.shape[0]
    B = pts.shape[0]
    dir_idx, chk, cofs = rows[0], rows[1], rows[2]
    d2c = rows[3].view(torch.float32)
    center = (voxel_of(pts, m.voxel_size).to(pts.dtype) + 0.5) * m.voxel_size
    # re-gather: every point now sees its tile's slot (or a stale entry
    # if its tile winner overflowed the pool -> point dropped)
    got_chk = m.dir_check[dir_idx]
    slot = m.dir_slot[dir_idx]
    ok = valid & (got_chk == chk)
    pool_idx = torch.clamp(slot, 0, T - 1) * TC + cofs

    # cell winner = the nearest ok row of each (dir_idx, cofs) run (the
    # run can hold rows of a directory-aliasing losing tile, or dropped
    # rows), the first in row order among equal distances
    cell_winner = torch.empty(B, dtype=torch.bool, device=pts.device)
    cell_winner[order] = _least_in_runs(_runs(sg)[0], rows[3][order], ok[order])

    stored = m.pts[pool_idx]
    stored_live = m.cell_check[pool_idx] == chk
    es = stored - center
    stored_d2c = es[:, 0] * es[:, 0] + es[:, 1] * es[:, 1] + es[:, 2] * es[:, 2]
    src, some, (at_cell,) = _drop_rows(
        cell_winner & (~stored_live | (d2c < stored_d2c)), pool_idx)
    _scatter_(m.cell_check, src, some, at_cell, chk)
    _scatter_(m.pts, src, some, at_cell, pts)
    n_dropped += (valid & ~ok).sum(dtype=torch.int32)


def insert_sort_plain(m: TiledMap, pts: torch.Tensor, valid: torch.Tensor):
    """The insert's keys and their stable sort (the kernel
    tiled_insert_sort's oracle): `insert_keys_plain`, then torch's stable
    sort of the keys. Returns (sg (B,) int32 the keys in sorted order,
    order (B,) int64 the sort's permutation, rows (5, B) int32)."""
    gkey, rows = insert_keys_plain(m, pts, valid)
    sg, order = torch.sort(gkey, stable=True)
    return sg, order, rows


DENSE_BITS = 8192  # a directory field of at most this many values ranks by occupancy


def insert_span_plain(m: TiledMap, gkey: torch.Tensor):
    """(bits, passes) of the insert sort's compact rank of the keys gkey
    (B,) int32: a valid key's rank is ((g_x R_y + g_y) R_z + g_z) 512 +
    cell over its directory index's three wrapped tile fields, g_q the
    count of the batch's occupied values of field q below the key's (f -
    min for a field of more than DENSE_BITS values) and R_q their count
    (max - min + 1); an invalid key's rank R_x R_y R_z 512. `bits` the
    bit length of the largest rank, `passes` the 8-bit digit passes it
    takes (0: every rank equal). What the launch of `insert_sort` decides
    on the card; here for the tests and the smoke run's report (a host
    read)."""
    vs = gkey < 0
    if not bool(vs.any()):
        return 0, 0
    d = ((gkey[vs].to(torch.int64) + KEY_BIAS) >> 9).cpu()
    l0, l1, l2 = (int(x) for x in m.log2_dims.cpu())
    span = 512
    for f, lq in ((d >> (l1 + l2), l0), ((d >> l2) & ((1 << l1) - 1), l1),
                  (d & ((1 << l2) - 1), l2)):
        span *= (int(torch.unique(f).numel()) if 1 << lq <= DENSE_BITS
                 else int(f.max() - f.min()) + 1)
    top = span - (0 if bool((~vs).any()) else 1)
    bits = top.bit_length()
    return bits, -(-bits // 8)


def _insert_passes(m: TiledMap, pts, valid, sort, sorted_pass) -> TiledMap:
    if m.dir_check.shape[0] > 1 << 22:
        raise ValueError("directory too large for the packed sort key")
    sg, order, rows = sort(m, pts, valid)
    n_alloc, n_dropped = sorted_pass(m, pts, valid, rows, sg, order)
    return m._replace(n_alloc=n_alloc, n_dropped=n_dropped)


def insert_sorted_plain(m: TiledMap, pts, valid, rows, sg, order):
    """The plain tiles and cells passes on the sorted keys: what
    `insert_tiles`' one launch computes, and its oracle."""
    n_alloc, n_dropped = insert_tiles_plain(m, pts, rows, sg, order)
    insert_cells_plain(m, pts, valid, rows, sg, order, n_dropped)
    return n_alloc, n_dropped


def insert_plain(m: TiledMap, pts: torch.Tensor, valid: torch.Tensor) -> TiledMap:
    """`insert` in torch ops, on any device: the keys and their stable
    sort, then the tiles and cells passes, their plain versions. The
    kernels' oracle."""
    return _insert_passes(m, pts, valid, insert_sort_plain, insert_sorted_plain)


def _sorted_keys(m: TiledMap, pts: torch.Tensor, valid: torch.Tensor):
    """The insert's sorted keys, `order` and rows: one `insert_sort`
    launch on a CUDA map."""
    return insert_sort(m, pts, valid)


def insert(m: TiledMap, pts: torch.Tensor, valid: torch.Tensor,
           max_probe: int = 0) -> TiledMap:
    """Insert-with-downsample (ikd_Tree.cpp:391-417 semantics), in place
    (n_alloc and n_dropped are new tensors). `max_probe` is accepted and
    ignored (the hash map's argument).

    One stable sort on the 32-bit key (dir_idx, in-tile cell) serves
    both winner selections: each dir_idx group's tile winner is the
    nearest-to-centre row of its first cell run, and each (dir_idx, cell)
    run's cell winner its nearest row that the directory entry holds after
    the tile writes, the first in row order among equal distances: the
    JAX package's heads of its (dir_idx, cell, distance) sort. A map on
    CUDA runs the two launches of csrc/tiled_insert.cu (`insert_sort`: the
    keys and their sort; then `insert_tiles`, whose one launch also runs
    the cells pass; each counted in its `.launches`), with no host read; a
    map on the CPU runs `insert_plain`. No other device is taken and
    nothing falls back."""
    dev = m.dir_check.device
    if dev.type == "cpu":
        return insert_plain(m, pts, valid)
    if dev.type != "cuda":
        raise ValueError(f"insert: unsupported device {dev}")
    return _insert_passes(m, pts.contiguous(), valid, _sorted_keys, insert_tiles)


@functools.cache
def _insert_launchers():
    from . import _build

    lib = _build.load("tiled_insert")
    P, I, IP = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    keys, tiles = lib.tiled_insert_keys_launch, lib.tiled_insert_tiles_launch
    size = lib.tiled_insert_tiles_scratch_ints
    sort, sort_size = lib.tiled_insert_sort_launch, lib.tiled_insert_sort_scratch_ints
    keys.argtypes = [P] * 6 + [I, P]
    tiles.argtypes = [P] * 15 + [I, I, I, IP, P]
    sort.argtypes = [P] * 10 + [I, IP, IP, P]
    size.argtypes = sort_size.argtypes = [I]
    for fn in (keys, tiles, size, sort, sort_size):
        fn.restype = ctypes.c_int
    return (_build.profiled("tiled_insert_keys", keys),
            _build.profiled("tiled_insert_tiles", tiles), size,
            _build.profiled("tiled_insert_sort", sort), sort_size)


def _check_insert(where: str, m: TiledMap, pts, valid=None, rows=None, sg=None, order=None):
    """The shapes, types, device and contiguity a pass's kernel takes."""
    dev = m.dir_check.device
    if dev.type != "cuda":
        raise ValueError(f"{where}: unsupported device {dev}")
    B, D, T = pts.shape[0], m.dir_check.shape[0], m.slot_key.shape[0]
    i32 = torch.int32
    for name, t, shape, dtype in (
            ("pts", pts, (B, 3), torch.float32), ("valid", valid, (B,), torch.bool),
            ("rows", rows, (5, B), i32), ("sorted keys", sg, (B,), i32),
            ("order", order, (B,), torch.int64),
            ("dir_check", m.dir_check, (D,), i32), ("dir_slot", m.dir_slot, (D,), i32),
            ("cell_check", m.cell_check, (T * TC,), i32),
            ("map pts", m.pts, (T * TC, 3), torch.float32),
            ("slot_key", m.slot_key, (T, 3), i32), ("n_alloc", m.n_alloc, (), i32),
            ("n_dropped", m.n_dropped, (), i32),
            ("voxel_size", m.voxel_size, (), torch.float32),
            ("log2_dims", m.log2_dims, (3,), i32)):
        if t is not None:
            _require(f"{where}: {name}", t, shape, dtype, dev)
    if D > 1 << 22 or T < 1 or B >= 1 << 31:
        raise ValueError(f"{where}: {B} rows, directory {D}, pool {T} tiles")
    return dev, B, T


def insert_keys(m: TiledMap, pts: torch.Tensor, valid: torch.Tensor):
    """`insert_keys_plain`'s signature and outputs: on a CUDA map one
    launch of tiled_insert_keys (counted in `insert_keys.launches`; none
    at B = 0), on a CPU map the plain version. On no path since
    `insert_sort`, whose launch computes the keys with the same device
    function."""
    if m.dir_check.device.type == "cpu":
        return insert_keys_plain(m, pts, valid)
    dev, B, _ = _check_insert("insert_keys", m, pts, valid)
    gkey = torch.empty(B, dtype=torch.int32, device=dev)
    rows = torch.empty((5, B), dtype=torch.int32, device=dev)
    if B:
        _raise_on("insert_keys", _insert_launchers()[0](
            pts.data_ptr(), valid.data_ptr(), m.voxel_size.data_ptr(), m.log2_dims.data_ptr(),
            gkey.data_ptr(), rows.data_ptr(), B, _stream(dev)))
        insert_keys.launches += 1
    return gkey, rows


def insert_sort(m: TiledMap, pts: torch.Tensor, valid: torch.Tensor):
    """`insert_sort_plain`'s signature and outputs, (sg, order, rows): on
    a CUDA map one cooperative launch of tiled_insert_sort (counted in
    `insert_sort.launches`, its blocks in `insert_sort.grid`, the tiles of
    512 rows a block in `insert_sort.tiles`; none at B = 0): the keys and
    rows as `insert_keys` writes them, then stable 8-bit LSD radix passes
    over a compact rank of the keys, the pass count decided on the card,
    with no host read and no device query after the first call; its
    header and histograms are the stream's scratch (`photometric._ticket`),
    left at 0. On a CPU map the plain version. 2^30 rows or more raise."""
    if m.dir_check.device.type == "cpu":
        return insert_sort_plain(m, pts, valid)
    dev, B, _ = _check_insert("insert_sort", m, pts, valid)
    *_, launch, size = _insert_launchers()
    k = size(B)
    if k < 0:
        raise ValueError(f"insert_sort: {B} rows (the kernel takes fewer than 2^30)")
    sg = torch.empty(B, dtype=torch.int32, device=dev)
    order = torch.empty(B, dtype=torch.int64, device=dev)
    rows = torch.empty((5, B), dtype=torch.int32, device=dev)
    if B:
        tmp = torch.empty(2 * B, dtype=torch.int32, device=dev)  # the passes' keys and rows
        stream = _stream(dev)
        ws = _ticket(dev, stream, k)  # left at 0 by every launch
        grid, tiles = ctypes.c_int(0), ctypes.c_int(0)
        _raise_on("insert_sort", launch(
            pts.data_ptr(), valid.data_ptr(), m.voxel_size.data_ptr(), m.log2_dims.data_ptr(),
            sg.data_ptr(), order.data_ptr(), tmp.data_ptr(), tmp[B:].data_ptr(),
            rows.data_ptr(), ws.data_ptr(), B, ctypes.byref(grid), ctypes.byref(tiles), stream))
        insert_sort.launches += 1
        insert_sort.grid = grid.value
        insert_sort.tiles = tiles.value
    return sg, order, rows


def insert_tiles(m: TiledMap, pts: torch.Tensor, valid: torch.Tensor, rows: torch.Tensor,
                 sg: torch.Tensor, order: torch.Tensor):
    """The tiles pass and the cells pass on the sorted keys: returns
    (n_alloc', n_dropped') and writes the map in place. On a CUDA map one
    ordinary launch of tiled_insert_tiles (3 ceil(B / 1024) blocks, 3 at
    B = 0, in `insert_tiles.grid`; counted in `insert_tiles.launches`,
    also at B = 0), which also writes the winner flags into rows[4], with
    no host read and no device query; its ticket, counts and status words
    are the stream's scratch (`photometric._ticket`), left at 0. The
    launch takes a row as valid where its sorted key is (sg < 0), so it
    reads no `valid`. On a CPU map `insert_sorted_plain`. 2^30 rows or
    more raise."""
    if m.dir_check.device.type == "cpu":
        return insert_sorted_plain(m, pts, valid, rows, sg, order)
    dev, B, T = _check_insert("insert_tiles", m, pts, valid, rows, sg, order)
    _, launch, size, *_ = _insert_launchers()
    k = size(B)
    if k < 0:
        raise ValueError(f"insert_tiles: {B} rows (the kernel takes fewer than 2^30)")
    out = torch.empty(2, dtype=torch.int32, device=dev)
    n_alloc, n_dropped = out[0], out[1]
    stream = _stream(dev)
    scratch = _ticket(dev, stream, k)  # left at 0 by every launch
    grid = ctypes.c_int(0)
    _raise_on("insert_tiles", launch(
        sg.data_ptr(), order.data_ptr(), rows.data_ptr(), pts.data_ptr(),
        m.voxel_size.data_ptr(), m.dir_check.data_ptr(), m.dir_slot.data_ptr(),
        m.slot_key.data_ptr(), m.cell_check.data_ptr(), m.pts.data_ptr(),
        m.n_alloc.data_ptr(), m.n_dropped.data_ptr(), n_alloc.data_ptr(), n_dropped.data_ptr(),
        scratch.data_ptr(), B, T, EMPTY_CHECK, ctypes.byref(grid), stream))
    insert_tiles.launches += 1
    insert_tiles.grid = grid.value
    return n_alloc, n_dropped


def insert_cells(m: TiledMap, pts: torch.Tensor, valid: torch.Tensor, rows: torch.Tensor,
                 sg: torch.Tensor, order: torch.Tensor, n_dropped: torch.Tensor) -> None:
    """The cells pass on a CPU map: `insert_cells_plain`. On a CUDA map
    the pass runs inside `insert_tiles`' launch (its third ticket range),
    so a call here raises."""
    if m.dir_check.device.type != "cpu":
        raise ValueError(f"insert_cells: on a {m.dir_check.device} map the cells pass runs "
                         f"inside insert_tiles' launch")
    insert_cells_plain(m, pts, valid, rows, sg, order, n_dropped)


insert_keys.launches = insert_tiles.launches = insert_sort.launches = 0
insert_tiles.grid = insert_sort.grid = insert_sort.tiles = 0


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


def knn_candidates(m: TiledMap, queries: torch.Tensor, radius: int = 1,
                   max_probe: int = 0):
    """Two-gather neighbourhood candidate block: (cpts (N, M, 3),
    found (N, M)) with M = (2 * radius + 1)^3. `max_probe` is accepted
    and ignored (the hash map's argument)."""
    _, pool_idx, tile_ok, chk = candidate_cells(m, queries, radius)
    found = tile_ok & (m.cell_check[pool_idx] == chk)
    cpts = m.pts[pool_idx.reshape(-1)].reshape(*pool_idx.shape, 3)
    return cpts, found


def knn(m: TiledMap, queries: torch.Tensor, k: int = 5, radius: int = 1,
        max_probe: int = 0):
    """Bounded k-NN over the (2 * radius + 1)^3-voxel neighbourhood:
    (neigh (N, k, 3), d2 (N, k), nvalid (N, k)). `max_probe` is ignored."""
    cpts, found = knn_candidates(m, queries, radius)
    return topk_from_candidates(cpts, found, queries, k)


def _cell_voxels(m: TiledMap) -> torch.Tensor:
    """(T*512, 3) voxel coordinate of every pool cell."""
    T = m.slot_key.shape[0]
    i = torch.arange(TC, dtype=torch.int32, device=m.slot_key.device)
    ofs = torch.stack([i >> 6, (i >> 3) & 7, i & 7], dim=-1)  # (512, 3)
    return (m.slot_key[:, None, :] * TS + ofs[None, :, :]).reshape(T * TC, 3)


def delete_boxes_plain(m: TiledMap, boxes_lo: torch.Tensor,
                       boxes_hi: torch.Tensor) -> TiledMap:
    """`delete_boxes` in torch ops, on any device: one elementwise pass
    over the pool's cell centres with the few boxes unrolled. The
    kernel's oracle."""
    centers = (_cell_voxels(m).to(m.pts.dtype) + 0.5) * m.voxel_size
    kill = torch.zeros(centers.shape[0], dtype=torch.bool,
                       device=centers.device)
    for b in range(boxes_lo.shape[0]):
        kill |= (torch.all(centers >= boxes_lo[b], dim=-1)
                 & torch.all(centers <= boxes_hi[b], dim=-1))
    m.cell_check.masked_fill_(kill, EMPTY_CHECK)
    return m


@functools.cache
def _delete_launcher():
    from . import _build

    fn = _build.load("tiled_delete_boxes").tiled_delete_boxes_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return _build.profiled("tiled_delete_boxes", fn)


def delete_boxes(m: TiledMap, boxes_lo: torch.Tensor,
                 boxes_hi: torch.Tensor) -> TiledMap:
    """Clear, in place, the cells whose voxel centre lies in any box
    (Delete_Point_Boxes role, ikd_Tree.cpp:501), in every pool slot.
    boxes_lo/hi: (B, 3) f32 on the map's device. A map on CUDA launches
    the kernel of csrc/tiled_delete_boxes.cu on the current stream
    (counted in `delete_boxes.launches`; its blocks, one wave at most, in
    `delete_boxes.grid`), which reads the slots' keys and the boxes (any
    number) and writes only the cleared cells, with no host read; a map
    on the CPU runs `delete_boxes_plain`. No other device is taken and
    nothing falls back."""
    dev = m.cell_check.device
    if dev.type == "cpu":
        return delete_boxes_plain(m, boxes_lo, boxes_hi)
    if dev.type != "cuda":
        raise ValueError(f"delete_boxes: unsupported device {dev}")
    T = m.slot_key.shape[0]
    B = boxes_lo.shape[0]
    for name, t, shape, dtype in (
            ("boxes_lo", boxes_lo, (B, 3), torch.float32),
            ("boxes_hi", boxes_hi, (B, 3), torch.float32),
            ("slot_key", m.slot_key, (T, 3), torch.int32),
            ("cell_check", m.cell_check, (T * TC,), torch.int32),
            ("voxel_size", m.voxel_size, (), torch.float32)):
        _require(f"delete_boxes: {name}", t, shape, dtype, dev)
    if B == 0 or T == 0:
        return m
    grid = ctypes.c_int(0)
    err = _delete_launcher()(
        m.slot_key.data_ptr(), m.voxel_size.data_ptr(), boxes_lo.data_ptr(),
        boxes_hi.data_ptr(), m.cell_check.data_ptr(), B, T, EMPTY_CHECK, _sm_count(dev),
        ctypes.byref(grid), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"delete_boxes: kernel launch failed (cudaError {err})")
    delete_boxes.launches += 1
    delete_boxes.grid = grid.value
    return m


delete_boxes.launches = 0
delete_boxes.grid = 0


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
