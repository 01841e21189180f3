"""The camera frame's image-pool push in one launch, in place.

`vio_push` is the port of the jitted XLA code of the JAX package's
`fastlivo_tpu/visual_map.py::push_image` with `push_slot` and
`_live_slot_refs`; not a Pallas kernel. On CUDA tensors it launches the
hand-written cooperative kernel in csrc/vio_push.cu (built at first use,
see _build.py): the live observations' count of each pool slot, the
slot's age rank and eviction key, the argmin, and the image copied into
the chosen slot with its frame id, written into the map's `imgs` and
`img_fid` in place with no host read (the point count and the frame id
stay on the device). On CPU tensors it runs the plain version,
`visual_map.push_image_plain` (the torch code), which is also the
kernel's oracle.

Contract on the card: `imgs` and `img_fid` after the call bit-equal to
the plain version's, on a u8 pool (round(clamp(img, 0, 255)), half to
even) and on an f32 pool, at any pool size: up to 12288 slots a block
counts in shared memory, past that in the stream's scratch
(`photometric._ticket`), which every launch leaves at 0.
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

    lib = _build.load("vio_push")
    fn, size = lib.vio_push_launch, lib.vio_push_scratch_ints
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size.argtypes = [ctypes.c_int]
    size.restype = ctypes.c_int
    return _build.profiled("vio_push", fn), size


def vio_push(m, img: torch.Tensor, fid):
    """`visual_map.push_image_plain(m, img, fid)` on the whole map (no
    slab layout): the map with `imgs` and `img_fid` written in place.
    `fid`: a 0-d int32 tensor on the map's device, or a Python int, which
    is uploaded as the plain version uploads it. A CUDA map launches the
    kernel of csrc/vio_push.cu on the current stream (counted in
    `vio_push.launches`, its blocks in `vio_push.grid`); a CPU map runs
    the plain version. No other device is taken and nothing falls back."""
    dev = m.img_fid.device
    if dev.type == "cpu":
        from .. import visual_map

        return visual_map.push_image_plain(m, img, fid)
    if dev.type != "cuda":
        raise ValueError(f"vio_push: unsupported device {dev}")
    fid = torch.as_tensor(fid, dtype=I32, device=dev)
    R = m.img_fid.shape[0]
    if m.imgs.ndim != 3 or m.imgs.shape[0] != R:
        raise ValueError(f"vio_push: imgs {tuple(m.imgs.shape)} is not a whole pool of {R} "
                         f"slots (the slab layout takes the plain version)")
    _, H, W = m.imgs.shape
    NP, KO = m.obs_fid.shape
    if m.imgs.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"vio_push: imgs dtype {m.imgs.dtype}, want uint8 or float32")
    for name, t, shape, dtype in (("obs_slot", m.obs_slot, (NP, KO), I32),
                                  ("obs_fid", m.obs_fid, (NP, KO), I32),
                                  ("n_pts", m.n_pts, (), I32),
                                  ("img_fid", m.img_fid, (R,), I32),
                                  ("imgs", m.imgs, (R, H, W), m.imgs.dtype),
                                  ("img", img, (H, W), torch.float32),
                                  ("fid", fid, (), I32)):
        _require(f"vio_push: {name}", t, shape, dtype, dev)
    launch, size = _library()
    k = size(R)
    if k < 0:
        raise ValueError(f"vio_push: a pool of {R} slots (the kernel takes 1 to 2^28)")
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = _ticket(dev, stream, k)  # left at 0 by every launch
    grid = ctypes.c_int(0)
    err = launch(m.obs_slot.data_ptr(), m.obs_fid.data_ptr(), m.n_pts.data_ptr(),
                 m.img_fid.data_ptr(), m.imgs.data_ptr(), img.data_ptr(), fid.data_ptr(),
                 scratch.data_ptr(), NP, KO, R, H, W, int(m.imgs.dtype == torch.uint8),
                 ctypes.byref(grid), stream)
    if err != 0:
        raise RuntimeError(f"vio_push: kernel launch failed (cudaError {err})")
    vio_push.launches += 1
    vio_push.grid = grid.value
    return m


vio_push.launches = 0
vio_push.grid = 0
