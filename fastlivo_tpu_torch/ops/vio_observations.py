"""The camera frame's visual-map upkeep in one launch, in place.

`vio_observations` is the port of the jitted XLA code of the JAX
package's `fastlivo_tpu/vio.py::prep_observations` and
`fastlivo_tpu/visual_map.py::add_observations` and `add_points` (with its
voxel-index insert); not a Pallas kernel. On CUDA tensors it launches the
hand-written cooperative kernel in csrc/vio_observations.cu (built at
first use, see _build.py): the posterior camera pose, the observation
gates at that pose, the ring appends and evictions, the new points and
their creation observation, the voxel hash's claims and appends, written
into the map's tensors in place, with no host read (the map's point count
stays on the device). On CPU tensors it runs the plain version,
`vio._cam_pose`, `vio.prep_observations`, `visual_map.add_observations`
and `visual_map.add_points` (each reads its count of kept rows back to
the host), which is also the kernel's oracle on the card.

Contract on the card: every field of the map after the call, and the
returned pixels, scores and pose, bit-equal to the plain version's, at
any number of rows (grid cells): up to 2048 the kernel's insert block
keeps its arrays in shared memory, past that in the stream's scratch
(`photometric._ticket`), which every launch leaves at 0.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .photometric import _require, _ticket
from .vio_select import MAX_PROBE, check_cam, check_map

I32, F32, F64 = torch.int32, torch.float32, torch.float64


def vio_observations_plain(vm, cam, img, rot, pos, Rci, Pci, t_idx, t_valid, t_slevel, rcw,
                           pcw, npos, npx, nscore, nadd, fid):
    """The posterior camera pose (rcw2, pcw2) of the state (rot, pos) with
    the extrinsics (Rci, Pci), prep_observations at that pose, then
    add_observations of the tracked rows it keeps and add_points of the
    new points with the prior pose's observation (rcw, pcw). Returns (the
    map, opc (B, 2), oscore (B,), (rcw2, pcw2))."""
    from .. import vio
    from .. import visual_map as vmap_mod

    rcw2, pcw2 = vio._cam_pose(Rci, Pci, rot, pos)
    opc, oscore, oadd = vio.prep_observations(vm, cam, rcw2, pcw2, img, t_idx, t_valid)
    vm = vmap_mod.add_observations(vm, t_idx, opc, rcw2, pcw2, oscore, fid, t_slevel, oadd)
    vm = vmap_mod.add_points(vm, npos, npx, rcw, pcw, nscore, fid, nadd, MAX_PROBE)
    return vm, opc, oscore, (rcw2, pcw2)


@functools.cache
def _launcher():
    from . import _build

    lib = _build.load("vio_observations")
    fn, size = lib.vio_observations_launch, lib.vio_observations_scratch_ints
    fn.argtypes = ([ctypes.c_void_p] * 41 + [ctypes.c_int] * 9
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    size.argtypes = [ctypes.c_int]
    fn.restype = size.restype = ctypes.c_int
    return _build.profiled("vio_observations", fn), size


def vio_observations(vm, cam, img, rot, pos, Rci, Pci, t_idx, t_valid, t_slevel, rcw, pcw,
                     npos, npx, nscore, nadd, fid):
    """`vio_observations_plain`'s signature and outputs. A CUDA frame
    launches the kernel on the current stream (counted in
    `vio_observations.launches`; the blocks launched in
    `vio_observations.grid`), which writes the map's tensors in place and
    returns the map with a new n_pts tensor; a CPU frame runs the plain
    version. No other device is taken and nothing falls back."""
    if img.device.type == "cpu":
        return vio_observations_plain(vm, cam, img, rot, pos, Rci, Pci, t_idx, t_valid,
                                      t_slevel, rcw, pcw, npos, npx, nscore, nadd, fid)
    if img.device.type != "cuda":
        raise ValueError(f"vio_observations: unsupported device {img.device}")
    dev = img.device
    NP, KO, T, VC, R = check_map("vio_observations", vm, dev)
    check_cam("vio_observations", cam, dev)
    B = t_idx.shape[0]
    launch, size = _launcher()
    k = size(B) if B < 1 << 31 else -1
    if img.ndim != 2 or k < 0:
        raise ValueError(f"vio_observations: frame {tuple(img.shape)}, {B} rows (at least 1, "
                         "and (28 + 1) B below 2^31)")
    H, W = img.shape
    fid = torch.as_tensor(fid, dtype=I32, device=dev)
    for name, t, shape, dtype in (
            ("img", img, (H, W), F32), ("rot", rot, (3, 3), F64), ("pos", pos, (3,), F64),
            ("Rci", Rci, (3, 3), F32), ("Pci", Pci, (3,), F32), ("rcw", rcw, (3, 3), F32),
            ("pcw", pcw, (3,), F32), ("fid", fid, (), I32),
            ("t_idx", t_idx, (B,), I32), ("t_valid", t_valid, (B,), torch.bool),
            ("t_slevel", t_slevel, (B,), I32), ("npos", npos, (B, 3), F32),
            ("npx", npx, (B, 2), F32), ("nscore", nscore, (B,), F32),
            ("nadd", nadd, (B,), torch.bool)):
        _require(f"vio_observations: {name}", t, shape, dtype, dev)
    opc, oscore = torch.empty((B, 2), dtype=F32, device=dev), torch.empty(B, dtype=F32,
                                                                          device=dev)
    n_pts = torch.empty((), dtype=I32, device=dev)
    rcw2, pcw2 = torch.empty((3, 3), dtype=F32, device=dev), torch.empty(3, dtype=F32,
                                                                         device=dev)
    nrow = torch.empty(B, dtype=I32, device=dev)  # scratch: the new points' rows
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = _ticket(dev, stream, k) if k else None  # past 2048 rows; left at 0
    ptrs = [t.data_ptr() for t in (
        vm.pos, vm.value, vm.n_obs, vm.n_pts, vm.obs_px, vm.obs_rcw, vm.obs_pcw, vm.obs_slot,
        vm.obs_fid, vm.obs_level, vm.vox_keys, vm.vox_count, vm.vox_idx, vm.img_fid, cam.fx,
        cam.fy, cam.cx, cam.cy, cam.d, img, rot, pos, Rci, Pci, rcw, pcw, fid, t_idx, t_valid,
        t_slevel, npos, npx, nscore, nadd, opc, oscore, n_pts, rcw2, pcw2, nrow)]
    grid = ctypes.c_int(0)
    err = launch(*ptrs, None if ws is None else ws.data_ptr(), NP, KO, T, VC, R, H, W, B,
                 MAX_PROBE, ctypes.byref(grid), stream)
    if err != 0:
        raise RuntimeError(f"vio_observations: kernel launch failed (cudaError {err})")
    vio_observations.launches += 1
    vio_observations.grid = grid.value
    return vm._replace(n_pts=n_pts), opc, oscore, (rcw2, pcw2)


vio_observations.launches = 0
vio_observations.grid = 0
