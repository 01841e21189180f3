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

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from .photometric import _require, _ticket

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


def insert_keys_plain(m: VoxelMap, pts: torch.Tensor, valid: torch.Tensor):
    """The insert's first pass (the kernel hash_insert_keys' oracle):
    (rows (6, B) int32, skeys (2, B) int64). rows holds each row's voxel
    [k0, k1, k2], its probe slot and 31-bit check (`_slot_check`) and the
    bits of its distance to the voxel centre (BIG where the row is
    invalid); skeys the two sort keys (k0 << 32) | bits(d2c) and (k2 << 32)
    | (k1 ^ 2^31), which `sort_order` sorts in turn. A non-negative f32's
    bits order like its value, and BIG's lie below 2^31."""
    mask = m.check.shape[0] - 1
    vs = m.voxel_size
    keys = voxel_of(pts, vs)
    slot0, checks = _slot_check(keys, mask)
    center = (keys.to(pts.dtype) + 0.5) * vs
    d2c = torch.where(valid, _sq3(pts - center),
                      torch.full((), BIG, dtype=pts.dtype, device=pts.device))
    bits = d2c.to(torch.float32).view(I32)
    k = keys.to(I64)
    hi = 1 << 32  # k * 2^32 stays inside int64 for any int32 k
    skeys = torch.stack([k[:, 0] * hi + (bits.to(I64) & _U32),
                         k[:, 2] * hi + ((k[:, 1] ^ 0x80000000) & _U32)])
    rows = torch.stack([keys[:, 0], keys[:, 1], keys[:, 2], slot0, checks, bits])
    return rows, skeys


def sort_order(skeys: torch.Tensor) -> torch.Tensor:
    """The rows in the JAX package's insert order,
    jnp.lexsort((d2c, k0, k1, k2)): k2 first, then k1, k0, the distance,
    then the row. Two stable sorts: by the first key (k0, distance), then
    by the second (k2, k1) gathered in that order."""
    o1 = torch.sort(skeys[0], stable=True)[1]
    return o1[torch.sort(skeys[1][o1], stable=True)[1]]


def _probe_rounds(m: VoxelMap, pts_s, keys_s, checks_s, slot, live, max_probe: int):
    """The probe rounds on rows in the JAX package's sorted order (pts_s,
    keys_s, checks_s, first probe slot `slot`), of which the `live` ones
    (each voxel's head) insert: writes the table in place and returns the
    new count. A free slot is claimed; when two voxels claim one slot in
    the same round, the later row in sorted order keeps it (the JAX
    package's duplicate-index scatter on the CPU), and a row learns that it
    won by reading the slot back. The writes go through copies of the
    table with one spare row, which takes the masked-out writes."""
    T = m.check.shape[0]
    mask = T - 1
    vs = m.voxel_size
    tc = torch.cat([m.check, m.check.new_full((1,), EMPTY_CHECK)])
    tp = torch.cat([m.pts, m.pts.new_zeros((1, 3))])
    cnt = m.count
    slot = slot.to(I64)
    done = ~live
    center_s = (keys_s.to(pts_s.dtype) + 0.5) * vs
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
    return cnt


def _sorted_heads(rows: torch.Tensor, order: torch.Tensor, valid: torch.Tensor):
    """The voxels in sorted order `order` (keys_s (B, 3)) and which rows
    head their run and are valid ((B,) bool)."""
    keys_s = rows[:3].T[order]
    same = torch.all(keys_s == torch.roll(keys_s, 1, dims=0), dim=-1)
    same[:1] = False
    return keys_s, valid[order] & ~same


def insert_probe_plain(m: VoxelMap, pts: torch.Tensor, valid: torch.Tensor,
                       rows: torch.Tensor, order: torch.Tensor, max_probe: int) -> torch.Tensor:
    """The insert's probe rounds on the sorted rows `order`: writes the
    table in place and returns the new count. Each voxel's run is headed
    by its row nearest the centre, a valid row; the heads probe
    `max_probe` consecutive slots (`_probe_rounds`)."""
    keys_s, live = _sorted_heads(rows, order, valid)
    return _probe_rounds(m, pts[order], keys_s, rows[4][order], rows[3][order], live,
                         max_probe)


def insert_plain(m: VoxelMap, pts: torch.Tensor, valid: torch.Tensor,
                 max_probe: int = 12) -> VoxelMap:
    """`insert` in torch ops, on any device: the keys pass, the two-pass
    sort and the probe rounds. The kernels' oracle."""
    rows, skeys = insert_keys_plain(m, pts, valid)
    order = sort_order(skeys)
    return m._replace(count=insert_probe_plain(m, pts, valid, rows, order, max_probe))


HEAD_ROWS = 7  # heads (7, B): row, k0, k1, k2, probe slot, check, d2c bits


def insert_heads_plain(m: VoxelMap, pts: torch.Tensor, valid: torch.Tensor):
    """The heads the kernel hash_insert_keys picks (its oracle): each
    voxel's row with the least (d2c bits, row) if that row is valid (the
    head of its run in jnp.lexsort((d2c, k0, k1, k2))'s order, as
    `insert_probe_plain` finds it), in row order. Returns (heads (7, B)
    int32: the first nh columns [row, k0, k1, k2, probe slot, 31-bit check,
    d2c bits] of each head, zeros after; nh () int32). Reads nh back to the
    host: for the CPU and the comparisons."""
    rows, skeys = insert_keys_plain(m, pts, valid)
    order = sort_order(skeys)
    head_rows = torch.sort(order[_sorted_heads(rows, order, valid)[1]]).values
    nh = head_rows.shape[0]
    heads = rows.new_zeros((HEAD_ROWS, pts.shape[0]))
    heads[0, :nh] = head_rows.to(I32)
    heads[1:, :nh] = rows[:, head_rows]
    return heads, torch.tensor(nh, dtype=I32, device=pts.device)


def insert_heads_probe_plain(m: VoxelMap, pts: torch.Tensor, heads: torch.Tensor,
                             nh: torch.Tensor, max_probe: int) -> torch.Tensor:
    """The probe rounds over the heads (hash_insert_probe's plain version):
    the heads put in (k2, k1, k0) order, the JAX package's sorted order of
    different voxels (three stable sorts, the least significant key
    first), then `_probe_rounds`. Writes the table in place and returns
    the new count. Reads nh back to the host."""
    h = heads[:, :int(nh)]
    o = torch.sort(h[1], stable=True)[1]
    o = o[torch.sort(h[2][o], stable=True)[1]]
    o = o[torch.sort(h[3][o], stable=True)[1]]
    h = h[:, o]
    return _probe_rounds(m, pts[h[0].to(I64)], h[1:4].T, h[5], h[4],
                         torch.ones(h.shape[1], dtype=torch.bool, device=h.device), max_probe)


def insert(m: VoxelMap, pts: torch.Tensor, valid: torch.Tensor,
           max_probe: int = 12) -> VoxelMap:
    """Insert a batch of world points with voxel downsampling, in place
    (count is a new tensor): per voxel the point nearest its centre
    survives, among the batch and the stored point (ikd_Tree.cpp:391-417).

    The batch's voxels are headed by their row nearest the centre; the
    heads then probe `max_probe` consecutive slots, a slot contested in a
    round kept by the head last in (k2, k1, k0) order
    (`insert_probe_plain`). A map on CUDA runs the two kernels of
    csrc/hash_insert.cu (`hash_insert_keys`, the heads without a sort,
    then `hash_insert_probe`, every round in one launch; each counted in
    its `.launches`), with no host read; a map on the CPU runs
    `insert_plain`. No other device is taken and nothing falls back."""
    dev = m.check.device
    if dev.type == "cpu":
        return insert_plain(m, pts, valid, max_probe)
    if dev.type != "cuda":
        raise ValueError(f"insert: unsupported device {dev}")
    pts = pts.contiguous()
    heads, nh = hash_insert_keys(m, pts, valid)
    return m._replace(count=hash_insert_probe(m, pts, heads, nh, max_probe))


@functools.cache
def _insert_launchers():
    from . import _build

    lib = _build.load("hash_insert")
    P, I = ctypes.c_void_p, ctypes.c_int
    keys, probe = lib.hash_insert_keys_launch, lib.hash_insert_probe_launch
    keys.argtypes = [P] * 7 + [I, I, I, ctypes.POINTER(I), P]
    probe.argtypes = [P] * 10 + [I, I, I, I, ctypes.POINTER(I), P]
    for fn in (keys, probe):
        fn.restype = ctypes.c_int
    return (_build.profiled("hash_insert_keys", keys),
            _build.profiled("hash_insert_probe", probe))


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(where: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{where}: kernel launch failed (cudaError {err})")


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_flat(where: str, m, pts=None, valid=None, heads=None, nh=None):
    """The shapes, types, device and contiguity the flat maps' kernels
    take (a VoxelMap or a DenseMap: check, pts, count, voxel_size)."""
    dev = m.check.device
    if dev.type != "cuda":
        raise ValueError(f"{where}: unsupported device {dev}")
    T = m.check.shape[0]
    B = 0 if pts is None else pts.shape[0]
    for name, t, shape, dtype in (
            ("pts", pts, (B, 3), torch.float32), ("valid", valid, (B,), torch.bool),
            ("heads", heads, (HEAD_ROWS, B), I32), ("nh", nh, (), I32),
            ("check", m.check, (T,), I32), ("map pts", m.pts, (T, 3), torch.float32),
            ("count", m.count, (), I32), ("voxel_size", m.voxel_size, (), torch.float32)):
        if t is not None:
            _require(f"{where}: {name}", t, shape, dtype, dev)
    return dev, B, T


def _check_hash(where: str, m: VoxelMap, pts, *rest):
    dev, B, T = _check_flat(where, m, pts, *rest)
    if T < 1 or T & (T - 1):
        raise ValueError(f"{where}: table of {T} slots (a power of two)")
    if B >= 1 << 28:
        raise ValueError(f"{where}: {B} rows (the kernels take fewer than 2^28)")
    return dev, B, T


def hash_insert_keys(m: VoxelMap, pts: torch.Tensor, valid: torch.Tensor):
    """`insert_heads_plain`'s signature and outputs (heads (7, B) int32,
    valid in their first nh columns; nh () int32): on a CUDA map one
    cooperative launch of hash_insert_keys, with no sort and no host read
    (counted in `hash_insert_keys.launches`; none at B = 0; its blocks in
    `hash_insert_keys.grid`), its table and look-back words in the
    stream's scratch (`photometric._ticket`), left at 0. On a CPU map the
    plain version."""
    if m.check.device.type == "cpu":
        return insert_heads_plain(m, pts, valid)
    dev, B, T = _check_hash("hash_insert_keys", m, pts, valid)
    heads = torch.empty((HEAD_ROWS, B), dtype=I32, device=dev)
    if B == 0:
        return heads, torch.zeros((), dtype=I32, device=dev)
    nh = torch.empty((), dtype=I32, device=dev)
    rk = torch.empty((4, B), dtype=I32, device=dev)
    S = max(64, 1 << (2 * B - 1).bit_length())  # a power of two >= 2 B
    stream = _stream(dev)
    scratch = _ticket(dev, stream, 3 * S + -(-B // 256))  # left at 0 by every launch
    grid = ctypes.c_int(0)
    _raise_on("hash_insert_keys", _insert_launchers()[0](
        pts.data_ptr(), valid.data_ptr(), m.voxel_size.data_ptr(), rk.data_ptr(),
        heads.data_ptr(), nh.data_ptr(), scratch.data_ptr(), B, S, T - 1, ctypes.byref(grid),
        stream))
    hash_insert_keys.launches += 1
    hash_insert_keys.grid = grid.value
    return heads, nh


def hash_insert_probe(m: VoxelMap, pts: torch.Tensor, heads: torch.Tensor, nh: torch.Tensor,
                      max_probe: int) -> torch.Tensor:
    """`insert_heads_probe_plain`'s signature and outputs: on a CUDA map
    one cooperative launch of hash_insert_probe that runs every round over
    the heads (counted in `hash_insert_probe.launches`, also at B = 0; its
    blocks in `hash_insert_probe.grid`), the table written in place, no
    host read; its tickets and round counts are the stream's scratch
    (`photometric._ticket`), left at 0. On a CPU map the plain version."""
    if m.check.device.type == "cpu":
        return insert_heads_probe_plain(m, pts, heads, nh, max_probe)
    dev, B, T = _check_hash("hash_insert_probe", m, pts, None, heads, nh)
    max_probe = int(max_probe)
    if max_probe < 0:
        raise ValueError(f"hash_insert_probe: max_probe {max_probe}")
    count = torch.empty((), dtype=I32, device=dev)
    state = torch.empty(B, dtype=I32, device=dev)
    stream = _stream(dev)
    scratch = _ticket(dev, stream, 4 * T + max_probe + 2)  # left at 0 by every launch
    grid = ctypes.c_int(0)
    _raise_on("hash_insert_probe", _insert_launchers()[1](
        pts.data_ptr(), heads.data_ptr(), nh.data_ptr(), m.voxel_size.data_ptr(),
        m.check.data_ptr(), m.pts.data_ptr(), m.count.data_ptr(), count.data_ptr(),
        state.data_ptr(), scratch.data_ptr(), B, T, max_probe, EMPTY_CHECK,
        ctypes.byref(grid), stream))
    hash_insert_probe.launches += 1
    hash_insert_probe.grid = grid.value
    return count


hash_insert_keys.launches = hash_insert_probe.launches = 0
hash_insert_keys.grid = hash_insert_probe.grid = 0


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


def delete_boxes_plain(m, boxes_lo: torch.Tensor, boxes_hi: torch.Tensor):
    """`delete_boxes` in torch ops, on any device, for the hash map and
    the dense grid alike: `in_boxes` over every slot and a masked fill.
    The kernel flat_delete_boxes' oracle."""
    kill = in_boxes(m.pts, m.check != EMPTY_CHECK, m.voxel_size, boxes_lo, boxes_hi)
    m.check.masked_fill_(kill, EMPTY_CHECK)
    return m._replace(count=m.count - kill.sum(dtype=I32))


@functools.cache
def _delete_launcher():
    from . import _build

    fn = _build.load("flat_delete_boxes").flat_delete_boxes_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return _build.profiled("flat_delete_boxes", fn)


def flat_delete_boxes(m, boxes_lo: torch.Tensor, boxes_hi: torch.Tensor):
    """`delete_boxes_plain`'s signature and result for a VoxelMap or a
    DenseMap (their layout is one): on a CUDA map one launch of
    csrc/flat_delete_boxes.cu on the current stream (counted in
    `flat_delete_boxes.launches`; its blocks, a thread per 16 slots, in
    `flat_delete_boxes.grid`), which reads every check once, the occupied
    slots' points and the boxes (any number), writes only the freed
    slots' checks and the new count, with no host read; none at no box.
    On a CPU map the plain version."""
    if m.check.device.type == "cpu":
        return delete_boxes_plain(m, boxes_lo, boxes_hi)
    dev, _, T = _check_flat("flat_delete_boxes", m)
    B = boxes_lo.shape[0]
    for name, t in (("boxes_lo", boxes_lo), ("boxes_hi", boxes_hi)):
        _require(f"flat_delete_boxes: {name}", t, (B, 3), torch.float32, dev)
    if B == 0 or T == 0:
        return m
    count = torch.empty((), dtype=I32, device=dev)
    stream = _stream(dev)
    grid = ctypes.c_int(0)
    _raise_on("flat_delete_boxes", _delete_launcher()(
        m.check.data_ptr(), m.pts.data_ptr(), m.voxel_size.data_ptr(), boxes_lo.data_ptr(),
        boxes_hi.data_ptr(), m.count.data_ptr(), count.data_ptr(),
        _ticket(dev, stream, 2).data_ptr(), B, T, EMPTY_CHECK, ctypes.byref(grid), stream))
    flat_delete_boxes.launches += 1
    flat_delete_boxes.grid = grid.value
    return m._replace(count=count)


flat_delete_boxes.launches = 0
flat_delete_boxes.grid = 0


def delete_boxes(m: VoxelMap, boxes_lo: torch.Tensor,
                 boxes_hi: torch.Tensor) -> VoxelMap:
    """Free, in place, the slots whose voxel centre (recomputed from the
    stored point) lies in any box (Delete_Point_Boxes, ikd_Tree.cpp:501,
    driven by lasermap_fov_segment, laserMapping.cpp:363-421); count is a
    new tensor. Also the dense grid's (dense_map.delete_boxes: one
    layout). A map on CUDA runs the kernel `flat_delete_boxes`, a map on
    the CPU `delete_boxes_plain`. No other device is taken and nothing
    falls back."""
    dev = m.check.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"delete_boxes: unsupported device {dev}")
    return flat_delete_boxes(m, boxes_lo, boxes_hi)


def _fresh(m: VoxelMap) -> VoxelMap:
    return VoxelMap(
        check=torch.full_like(m.check, EMPTY_CHECK), pts=torch.zeros_like(m.pts),
        count=torch.zeros_like(m.count), voxel_size=m.voxel_size)


def rebuild_plain(m: VoxelMap) -> VoxelMap:
    """`rebuild` through `insert_plain`, on any device."""
    return insert_plain(_fresh(m), m.pts, m.check != EMPTY_CHECK, max_probe=32)


def rebuild(m: VoxelMap) -> VoxelMap:
    """Full compaction into a new table: every occupied slot re-inserted,
    at a deeper probe (32) than the per-frame insert's, so that no entry
    is dropped at a high load. Removes duplicate entries and probe chains
    broken by deletions (the ikd-Tree's background rebuild,
    ikd_Tree.cpp:187-301). Through `insert`: the kernels on CUDA."""
    return insert(_fresh(m), m.pts, m.check != EMPTY_CHECK, max_probe=32)


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
