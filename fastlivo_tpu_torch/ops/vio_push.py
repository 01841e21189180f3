"""The camera frame's image-pool push in one launch, in place.

`vio_push` is the port of the jitted XLA code of the JAX package's
`fastlivo_tpu/visual_map.py::push_image` with `push_slot` and
`_live_slot_refs`; not a Pallas kernel. On CUDA tensors it launches the
hand-written cooperative kernel in csrc/vio_push.cu (built at first use,
see _build.py): the live observations' count of each pool slot, the
slot's age rank and eviction key, the argmin, and the image copied into
the chosen slot with its frame id, written into the map's `imgs` and
`img_fid` in place with no host read (the point count and the frame id
stay on the device). Up to `ONE_BARRIER_MAX_R` slots (the shipped pool of
256) the launch has one grid barrier: before it each block counts its
share of the rows, forms the age ranks of its share of the slots (each
stored beside the slot's count in the scratch) and reads its share of
the image; after it every block reads the (count, rank) pairs and takes
the argmin of all the slots' keys itself; past that the two-barrier form
(the keys a warp a slot, one 64-bit word for the slot, a second barrier).
The launcher chooses; `form` forces one for the comparisons. On CPU
tensors it runs the plain version, `visual_map.push_image_plain` (the
torch code), which is also the kernel's oracle.

Contract on the card: `imgs` and `img_fid` after the call bit-equal to
the plain version's, in either form, on a u8 pool (round(clamp(img, 0,
255)), half to even) and on an f32 pool, at any pool size: up to 12288
slots a block counts in shared memory, past that (the two-barrier form)
in the stream's scratch (`photometric._ticket`), which every launch
leaves at 0.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .photometric import _require, _ticket

I32 = torch.int32
ONE_BARRIER_MAX_R = 2048  # the largest pool the launcher gives one grid barrier (ONE_R)
FORMS = {0: "the launcher's choice", 1: "one grid barrier", 2: "two grid barriers"}


@functools.cache
def _library():
    from . import _build

    lib = _build.load("vio_push")
    fn, size = lib.vio_push_launch, lib.vio_push_scratch_ints
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [
        ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size.argtypes = [ctypes.c_int]
    size.restype = ctypes.c_int
    return _build.profiled("vio_push", fn), size


def vio_push(m, img: torch.Tensor, fid, form: int = 0):
    """`visual_map.push_image_plain(m, img, fid)` on the whole map (no
    slab layout): the map with `imgs` and `img_fid` written in place.
    `fid`: a 0-d int32 tensor on the map's device, or a Python int, which
    is uploaded as the plain version uploads it. A CUDA map launches the
    kernel of csrc/vio_push.cu on the current stream (counted in
    `vio_push.launches`, its blocks in `vio_push.grid`, its form (FORMS)
    in `vio_push.form`); `form` 1 or 2 forces one (the comparisons'; the
    one-barrier form takes up to 12288 slots). A CPU map runs the plain
    version.
    No other device is taken and nothing falls back."""
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
    if form not in FORMS or (form == 1 and R > 12288):
        raise ValueError(f"vio_push: form {form} at a pool of {R} slots")
    launch, size = _library()
    k = size(R)
    if k < 0:
        raise ValueError(f"vio_push: a pool of {R} slots (the kernel takes 1 to 2^28)")
    stream = torch.cuda.current_stream(dev).cuda_stream
    scratch = _ticket(dev, stream, k)  # left at 0 by every launch
    grid, launched = ctypes.c_int(0), ctypes.c_int(0)
    err = launch(m.obs_slot.data_ptr(), m.obs_fid.data_ptr(), m.n_pts.data_ptr(),
                 m.img_fid.data_ptr(), m.imgs.data_ptr(), img.data_ptr(), fid.data_ptr(),
                 scratch.data_ptr(), NP, KO, R, H, W, int(m.imgs.dtype == torch.uint8), form,
                 0, ctypes.byref(grid), ctypes.byref(launched), stream)
    if err != 0:
        raise RuntimeError(f"vio_push: kernel launch failed (cudaError {err})")
    vio_push.launches += 1
    vio_push.grid = grid.value
    vio_push.form = launched.value
    return m


vio_push.launches = 0
vio_push.grid = 0
vio_push.form = 0
