"""Scan voxel-grid downsampling: each occupied voxel becomes the centroid
of its points (the reference's `pcl::VoxelGrid` scan filter,
laserMapping.cpp:172-173 with leaf `filter_size_surf`).

Port of the JAX package's ops/voxel_filter.py: the device filter of the
fused frame step and the host (numpy) filter of the bootstrap frames. On
CUDA the device filter is two hand-written kernels (built at first use,
see _build.py): the keys and their stable sort, one cooperative launch of
csrc/voxel_keys.cu (`voxel_sort`: the packed keys, then stable LSD radix
passes over a compact rank of them), and the segmented centroid after it,
one launch of csrc/voxel_centroids.cu, which reads the sorted keys and
the permutation. Their plain versions `_sorted_keys_plain` (the key pass
`voxel_keys_plain` and torch's stable sort) and `voxel_centroids_plain`,
the torch code the CPU runs, are the kernels' oracles. Contract on the
card: bit-equal to the plain versions run on the CPU on the same inputs.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .photometric import _require, _ticket

INVALID = 1 << 62  # the packed key of a dropped row: sorts after every voxel


def voxel_keys_plain(pts: torch.Tensor, valid: torch.Tensor, leaf, inv_leaf):
    """The packed voxel keys (N,) int64 of the rows: 3 x 20-bit offset
    coordinates of floor(pts / leaf) (or floor(pts * inv_leaf)), the
    invalid marker 2^62 where the row is invalid or not finite. The torch
    code the CPU runs and the oracle of `voxel_keys`."""
    valid = valid & torch.all(torch.isfinite(pts[:, :3]), dim=-1)
    keys = torch.floor(pts[:, :3] / leaf if inv_leaf is None
                       else pts[:, :3] * inv_leaf)
    # zero the dropped rows before the cast: a NaN has no integer value
    keys = torch.where(valid[:, None], keys, torch.zeros_like(keys)).to(torch.int64)
    # 3 x 20-bit offset coordinates in one key; the invalid marker 2^62
    # sorts last
    packed = (
        ((keys[:, 0] + (1 << 19)) & 0xFFFFF) << 40
        | ((keys[:, 1] + (1 << 19)) & 0xFFFFF) << 20
        | ((keys[:, 2] + (1 << 19)) & 0xFFFFF)
    )
    return torch.where(valid, packed, torch.full_like(packed, INVALID))


@functools.cache
def _keys_library():
    from . import _build

    fn = _build.load("voxel_keys").voxel_keys_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 2 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return _build.profiled("voxel_keys", fn)


def voxel_keys(pts: torch.Tensor, valid: torch.Tensor, leaf, inv_leaf):
    """`voxel_keys_plain`'s signature and output: the key pass alone (on
    no path since `voxel_sort`, whose launch computes the keys with the
    same device function). CUDA tensors launch the
    kernel of csrc/voxel_keys.cu on the current stream (counted in
    `voxel_keys.launches`, its blocks in `voxel_keys.grid`), a thread a
    row, with no host read; CPU tensors run the plain version. The scale
    (`leaf`, or `inv_leaf` when given) must be a 0-d f32 tensor on pts'
    device: the plain version divides by a device tensor, where a Python
    float would have the card multiply by its reciprocal instead. No other
    device is taken and nothing falls back."""
    if pts.device.type == "cpu":
        return voxel_keys_plain(pts, valid, leaf, inv_leaf)
    if pts.device.type != "cuda":
        raise ValueError(f"voxel_keys: unsupported device {pts.device}")
    dev = pts.device
    if pts.ndim != 2 or pts.shape[1] < 3 or pts.shape[0] >= 1 << 31:
        raise ValueError(f"voxel_keys: pts {tuple(pts.shape)}, want (N < 2^31, C >= 3)")
    N, C = pts.shape
    scale = leaf if inv_leaf is None else inv_leaf
    if not isinstance(scale, torch.Tensor):
        raise TypeError("voxel_keys: the leaf must be a 0-d f32 tensor on the card")
    _require("voxel_keys: pts", pts, (N, C), torch.float32, dev)
    _require("voxel_keys: valid", valid, (N,), torch.bool, dev)
    _require("voxel_keys: scale", scale, (), torch.float32, dev)
    out = torch.empty(N, dtype=torch.int64, device=dev)
    grid = ctypes.c_int(0)
    err = _keys_library()(pts.data_ptr(), valid.data_ptr(), scale.data_ptr(),
                          int(inv_leaf is None), out.data_ptr(), N, C, ctypes.byref(grid),
                          torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"voxel_keys: kernel launch failed (cudaError {err})")
    if N > 0:
        voxel_keys.launches += 1
    voxel_keys.grid = grid.value
    return out


voxel_keys.launches = 0
voxel_keys.grid = 0


def sort_span_plain(keys: torch.Tensor):
    """(bits, passes) of the sort's compact rank of the packed keys (N,)
    int64: the rank of a valid key is ((fx - min_x) R_y + (fy - min_y)) R_z
    + (fz - min_z) over its three 20-bit fields (min and max over the valid
    keys, R = max - min + 1), of the invalid marker R_x R_y R_z; `bits` the
    bit length of the largest rank, `passes` the 8-bit digit passes it
    takes (0: every rank equal). What the launch of `voxel_sort` decides on
    the card; here for the tests and the smoke run's report (a host read)."""
    vs = keys != INVALID
    if not bool(vs.any()):
        return 0, 0
    k = keys[vs]
    f = torch.stack([(k >> 40) & 0xFFFFF, (k >> 20) & 0xFFFFF, k & 0xFFFFF])
    span = [int(x) for x in (f.max(1).values - f.min(1).values + 1)]
    top = span[0] * span[1] * span[2] - (0 if bool((~vs).any()) else 1)
    bits = top.bit_length()
    return bits, -(-bits // 8)


@functools.cache
def _sort_library():
    from . import _build

    lib = _build.load("voxel_keys")
    fn, size = lib.voxel_sort_launch, lib.voxel_sort_scratch_ints
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size.argtypes = [ctypes.c_int]
    size.restype = ctypes.c_int
    return _build.profiled("voxel_sort", fn), size


def voxel_sort(pts: torch.Tensor, valid: torch.Tensor, leaf, inv_leaf):
    """`_sorted_keys_plain`'s signature and outputs: the packed voxel keys
    in sorted order and the stable sort's permutation `order` (sorted row
    r is row order[r]), both (N,) int64. CUDA tensors launch the
    cooperative kernel of csrc/voxel_keys.cu on the current stream
    (counted in `voxel_sort.launches`, its blocks in `voxel_sort.grid`,
    the tiles of 1024 rows a block in `voxel_sort.tiles`): the keys, then
    stable 8-bit LSD radix passes over their compact rank
    (`sort_span_plain`), the number of passes decided on the device, with
    no host read; CPU tensors run the plain version. The scale takes `voxel_keys`' rules (a
    0-d f32 tensor on pts' device). No other device is taken and nothing
    falls back: 2^31 rows or more raise."""
    if pts.device.type == "cpu":
        return _sorted_keys_plain(pts, valid, leaf, inv_leaf)
    if pts.device.type != "cuda":
        raise ValueError(f"voxel_sort: unsupported device {pts.device}")
    dev = pts.device
    if pts.ndim != 2 or pts.shape[1] < 3:
        raise ValueError(f"voxel_sort: pts {tuple(pts.shape)}, want (N, C >= 3)")
    N, C = pts.shape
    scale = leaf if inv_leaf is None else inv_leaf
    if not isinstance(scale, torch.Tensor):
        raise TypeError("voxel_sort: the leaf must be a 0-d f32 tensor on the card")
    _require("voxel_sort: pts", pts, (N, C), torch.float32, dev)
    _require("voxel_sort: valid", valid, (N,), torch.bool, dev)
    _require("voxel_sort: scale", scale, (), torch.float32, dev)
    launch, size = _sort_library()
    k = size(N) if N < 1 << 31 else -1
    if k < 0:
        raise ValueError(f"voxel_sort: {N} rows (the kernel takes fewer than 2^31)")
    keys = torch.empty(N, dtype=torch.int64, device=dev)
    order = torch.empty(N, dtype=torch.int64, device=dev)
    if N == 0:
        return keys, order
    tmp = torch.empty(3 * N, dtype=torch.int32, device=dev)  # int64 keys, int32 rows
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = _ticket(dev, stream, k)  # left at 0 by every launch
    grid, tiles = ctypes.c_int(0), ctypes.c_int(0)
    err = launch(pts.data_ptr(), valid.data_ptr(), scale.data_ptr(), int(inv_leaf is None),
                 keys.data_ptr(), order.data_ptr(), tmp.data_ptr(), tmp[2 * N:].data_ptr(),
                 ws.data_ptr(), N, C, ctypes.byref(grid), ctypes.byref(tiles), stream)
    if err != 0:
        raise RuntimeError(f"voxel_sort: kernel launch failed (cudaError {err})")
    voxel_sort.launches += 1
    voxel_sort.grid = grid.value
    voxel_sort.tiles = tiles.value
    return keys, order


voxel_sort.launches = 0
voxel_sort.grid = 0
voxel_sort.tiles = 0


def _sorted_keys(pts: torch.Tensor, valid: torch.Tensor, leaf, inv_leaf):
    """The packed voxel keys in sorted order, and the stable sort's
    permutation `order` (sorted row r is row order[r]): one `voxel_sort`
    launch on CUDA, the plain version on the CPU."""
    return voxel_sort(pts, valid, leaf, inv_leaf)


def _sorted_keys_plain(pts: torch.Tensor, valid: torch.Tensor, leaf, inv_leaf):
    """`_sorted_keys` in torch code on any device: the key pass's
    (`voxel_keys_plain`) and torch's stable sort. The CPU's filter and the
    oracle of `voxel_sort`."""
    return torch.sort(voxel_keys_plain(pts, valid, leaf, inv_leaf), stable=True)


def voxel_downsample_device(pts: torch.Tensor, valid: torch.Tensor,
                            leaf: torch.Tensor | None, max_out: int,
                            inv_leaf: torch.Tensor | None = None):
    """Centroid voxel filter with a fixed output capacity, on pts' device.

    The packed keys and their stable sort (`voxel_sort`), then the
    segmented centroid of `voxel_centroids` into `max_out` rows (each one
    kernel launch on CUDA);
    rows past the capacity and invalid rows are dropped. Output order is
    sorted-voxel-key order. Non-finite points are dropped
    (pcl::VoxelGrid's is-finite skip). Each segment is summed in row
    order, on CUDA as on the CPU.

    Args:   pts (N, C>=3) f32; valid (N,) bool; leaf: 0-d f32 tensor on
            pts' device (see voxel_map.voxel_of for why not a float);
            or, instead of `leaf`, `inv_leaf`: the keys are then
            floor(pts * inv_leaf). The JAX package's fused camera step
            passes its 0.2 m leaf as a constant, which XLA turns into a
            multiply by the f32 reciprocal; `inv_leaf` computes that form.
    Returns (out (max_out, C), mask (max_out,)).
    """
    pts = pts.contiguous()
    keys, order = _sorted_keys(pts, valid, leaf, inv_leaf)
    return voxel_centroids(keys, order, pts, max_out)


def voxel_centroids_plain(keys: torch.Tensor, order: torch.Tensor, pts: torch.Tensor,
                          max_out: int):
    """The segmented centroid after the sort: `keys` the packed keys in
    sorted order (INVALID for a dropped row, sorted last), sorted row r
    the row pts[order[r]]; segments the runs of equal valid keys, segment
    g < max_out summed in row order from +0.0 (`segment_reduce`) and
    divided by its length. Returns (out (max_out, C), mask (max_out,))."""
    ps = pts[order]
    vs = keys != INVALID
    start = torch.ones_like(vs)
    start[1:] = keys[1:] != keys[:-1]
    start &= vs
    seg = torch.cumsum(start.to(torch.int64), 0) - 1
    seg = torch.where(vs, seg, torch.full_like(seg, max_out))
    seg = torch.clamp(seg, max=max_out)  # overflow -> sentinel row
    # seg never decreases along the sorted rows, so the segments are the
    # row runs of these lengths (integer counts: exact in any order)
    lengths = torch.zeros(max_out + 1, dtype=torch.int64, device=pts.device)
    lengths.index_add_(0, seg, torch.ones_like(seg))
    sums = torch.segment_reduce(
        torch.where(vs[:, None], ps, torch.zeros_like(ps)), "sum",
        lengths=lengths, axis=0, unsafe=True, initial=0.0)
    sums, cnt = sums[:max_out], lengths[:max_out].to(pts.dtype)
    mask = cnt > 0
    out = sums / torch.clamp(cnt, min=1.0)[:, None]
    return torch.where(mask[:, None], out, torch.zeros_like(out)), mask


@functools.cache
def _library():
    from . import _build

    lib = _build.load("voxel_centroids")
    fn = lib.voxel_centroids_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size = lib.voxel_centroids_scratch_ints
    size.argtypes = [ctypes.c_int, ctypes.c_int]
    size.restype = ctypes.c_int
    return _build.profiled("voxel_centroids", fn), size


def voxel_centroids(keys: torch.Tensor, order: torch.Tensor, pts: torch.Tensor,
                    max_out: int):
    """`voxel_centroids_plain`'s signature and outputs. CUDA tensors launch
    the kernel of csrc/voxel_centroids.cu on the current stream (counted
    in `voxel_centroids.launches`; its blocks in `voxel_centroids.grid`)
    with no host read and no device query; CPU tensors run the plain
    version. No other device is taken and nothing falls back: 2^30 rows
    or more, or more than 160 columns, raise."""
    if pts.device.type == "cpu":
        return voxel_centroids_plain(keys, order, pts, max_out)
    if pts.device.type != "cuda":
        raise ValueError(f"voxel_centroids: unsupported device {pts.device}")
    dev = pts.device
    if pts.ndim != 2 or pts.shape[1] < 1 or max_out < 0:
        raise ValueError(f"voxel_centroids: pts {tuple(pts.shape)}, max_out {max_out}")
    N, C = pts.shape
    for name, t, shape, dtype in (("keys", keys, (N,), torch.int64),
                                  ("order", order, (N,), torch.int64),
                                  ("pts", pts, (N, C), torch.float32)):
        _require(f"voxel_centroids: {name}", t, shape, dtype, dev)
    launch, size = _library()
    k = size(N, C)
    if k < 0:
        raise ValueError(f"voxel_centroids: {N} rows of {C} columns (the kernel takes "
                         f"fewer than 2^30 rows of at most 160 columns)")
    out = torch.empty((max_out, C), dtype=torch.float32, device=dev)
    mask = torch.empty(max_out, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = _ticket(dev, stream, k)  # left at 0 by every launch
    grid = ctypes.c_int(0)
    err = launch(keys.data_ptr(), order.data_ptr(), pts.data_ptr(), out.data_ptr(),
                 mask.data_ptr(), scratch.data_ptr(), N, C, max_out, ctypes.byref(grid),
                 stream)
    if err != 0:
        raise RuntimeError(f"voxel_centroids: kernel launch failed (cudaError {err})")
    if max_out > 0:
        voxel_centroids.launches += 1
    voxel_centroids.grid = grid.value
    return out, mask


voxel_centroids.launches = 0
voxel_centroids.grid = 0


def voxel_downsample(pts: np.ndarray, leaf: float,
                     max_out: int | None = None):
    """Host centroid-per-voxel downsample, in scan order.

    Args:
      pts: (N, 3+C) float array; extra columns are averaged alongside xyz.
      leaf: voxel edge length.
      max_out: if given, output is padded/truncated to this many rows and
        a validity mask is returned (truncation keeps the first voxels
        in scan order).

    Returns:
      (out, mask): out (M, 3+C) f32, mask (M,) bool. Without max_out,
      M is the number of occupied voxels and mask is all-true.
    """
    pts = np.asarray(pts, dtype=np.float64)
    if pts.ndim == 2 and len(pts):
        pts = pts[np.all(np.isfinite(pts[:, :3]), axis=1)]
    if pts.size == 0:
        M = max_out or 0
        return (np.zeros((M, pts.shape[1] if pts.ndim == 2 else 3), np.float32),
                np.zeros(M, bool))
    keys = np.floor(pts[:, :3] / leaf).astype(np.int64)
    # pack 3 x 21-bit signed coords into one int64 key
    packed = (
        ((keys[:, 0] + (1 << 20)) & 0x1FFFFF)
        | (((keys[:, 1] + (1 << 20)) & 0x1FFFFF) << 21)
        | (((keys[:, 2] + (1 << 20)) & 0x1FFFFF) << 42)
    )
    order = np.argsort(packed, kind="stable")
    sp = packed[order]
    first = np.ones(len(sp), bool)
    first[1:] = sp[1:] != sp[:-1]
    group = np.cumsum(first) - 1
    nv = group[-1] + 1
    sums = np.zeros((nv, pts.shape[1]), np.float64)
    np.add.at(sums, group, pts[order])
    counts = np.bincount(group, minlength=nv).astype(np.float64)
    cent = sums / counts[:, None]
    # restore scan order: voxel labeled by first occurrence
    first_idx = np.full(nv, len(pts), np.int64)
    np.minimum.at(first_idx, group, order)
    out = cent[np.argsort(first_idx, kind="stable")].astype(np.float32)
    if max_out is None:
        return out, np.ones(len(out), bool)
    mask = np.zeros(max_out, bool)
    n = min(len(out), max_out)
    buf = np.zeros((max_out, pts.shape[1]), np.float32)
    buf[:n] = out[:n]
    mask[:n] = True
    return buf, mask
