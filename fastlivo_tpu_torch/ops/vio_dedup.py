"""The camera frame's voxel dedup of its filtered scan cloud in one launch.

`vio_dedup` is the port of the jitted XLA code of the JAX package's
`fastlivo_tpu/vio.py::_dedup_voxels` (the sub_feat_map key set,
addFromSparseMap :361-380); not a Pallas kernel. On CUDA tensors it
launches the hand-written kernel in csrc/vio_dedup.cu (built at first
use, see _build.py): one block that runs the probe rounds of the
linear-probed hash on a table set once (each round's entries tagged above
the older ones) and compacts the kept keys in row order by one scan, with
no host read. On CPU tensors it runs the plain version,
`vio._dedup_voxels_plain` (the torch code), which is also the kernel's
oracle.

Contract on the card: vox and vmask bit-equal to the plain version's at
any number of rows: the kernel keeps its arrays in shared memory while
they fit (M = 8192 shipped) and in the stream's scratch
(`photometric._ticket`) past that, which every launch leaves at 0.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .photometric import _require, _ticket

I32 = torch.int32


@functools.cache
def _library():
    from . import _build

    lib = _build.load("vio_dedup")
    fn, size = lib.vio_dedup_launch, lib.vio_dedup_scratch_ints
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size.argtypes = [ctypes.c_int]
    size.restype = ctypes.c_int
    return _build.profiled("vio_dedup", fn), size


def vio_dedup(pg: torch.Tensor, pg_mask: torch.Tensor, max_vox: int):
    """`vio._dedup_voxels_plain`'s signature and outputs: (vox (max_vox, 3)
    int32, vmask (max_vox,) bool). CUDA tensors launch the
    kernel of csrc/vio_dedup.cu on the current stream (counted in
    `vio_dedup.launches`; its scratch route in `vio_dedup.scratch`) with
    no host read; CPU tensors run the plain version. No other device is
    taken and nothing falls back: 2^28 rows or more raise."""
    if pg.device.type == "cpu":
        from .. import vio

        return vio._dedup_voxels_plain(pg, pg_mask, max_vox)
    if pg.device.type != "cuda":
        raise ValueError(f"vio_dedup: unsupported device {pg.device}")
    dev = pg.device
    if pg.ndim != 2 or pg.shape[1] != 3 or max_vox < 0:
        raise ValueError(f"vio_dedup: pg {tuple(pg.shape)}, max_vox {max_vox}")
    M = pg.shape[0]
    _require("vio_dedup: pg", pg, (M, 3), torch.float32, dev)
    _require("vio_dedup: pg_mask", pg_mask, (M,), torch.bool, dev)
    launch, size = _library()
    k = size(M)
    if k < 0:
        raise ValueError(f"vio_dedup: {M} rows (the kernel takes fewer than 2^28)")
    vox = torch.empty((max_vox, 3), dtype=I32, device=dev)
    vmask = torch.empty(max_vox, dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = _ticket(dev, stream, k) if k > 0 else None  # left at 0 by every launch
    grid = ctypes.c_int(0)
    err = launch(pg.data_ptr(), pg_mask.data_ptr(), vox.data_ptr(), vmask.data_ptr(),
                 None if ws is None else ws.data_ptr(), M, max_vox, ctypes.byref(grid),
                 stream)
    if err != 0:
        raise RuntimeError(f"vio_dedup: kernel launch failed (cudaError {err})")
    if max_vox > 0:
        vio_dedup.launches += 1
        vio_dedup.scratch += k > 0
    vio_dedup.grid = grid.value
    return vox, vmask


vio_dedup.launches = 0
vio_dedup.scratch = 0
vio_dedup.grid = 0
