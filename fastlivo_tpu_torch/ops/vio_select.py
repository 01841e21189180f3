"""The camera frame's selection in one launch: the tracked map points with
their warped reference patches, and the new points.

`vio_select` is the port of the jitted XLA code of the JAX package's
`fastlivo_tpu/vio.py::select_tracked` (:130-401) and `select_new_points`
(:408-484); not a Pallas kernel. On CUDA tensors it launches the
hand-written cooperative kernel in csrc/vio_select.cu (built at first use,
see _build.py): the camera pose of the prior state, the sparse depth
image, the candidate gather from the visual map's voxel hash, the
per-cell winners, the depth-continuity and best-view gates, the warped
patches at three pyramid levels, the outlier and NCC gates, and the new
points' Shi-Tomasi winners, with no host read. On CPU tensors it runs the
plain version, `vio._cam_pose`, `vio.select_tracked` and
`vio.select_new_points` (torch ops in the kernel's order of operations),
which is also the kernel's oracle on the card.

Contract on the card: every output bit-equal to the plain version's
(the TrackedSet's idx, pos, patch, search_level, valid, cell_value and
errors, the new points' pos, px, score and add, and the pose), at every
patch size from 2 to 16 (the photometric kernels' limit) and any pool.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .photometric import _require

I32, I64, F32, F64 = torch.int32, torch.int64, torch.float32, torch.float64
MAX_PATCH = 16  # P * P <= 256: eight pixels a lane of the cell's warp
MAX_PROBE = 12  # the voxel hash's probe depth (visual_map's default)


def vio_select_plain(vm, cam, rot, pos, Rci, Pci, img, pg, pg_mask, vox, vox_mask,
                     outlier_threshold, ncc_thre, grid_size: int, patch_size: int, gw: int,
                     gh: int, ncc_en: bool = False):
    """The camera pose of the state (rot, pos) with the extrinsics (Rci,
    Pci), select_tracked, then select_new_points against its cell values.
    Returns (TrackedSet, (pos, px, score, add), (rcw, pcw))."""
    from .. import vio

    kw = dict(grid_size=grid_size, patch_size=patch_size, gw=gw, gh=gh)
    rcw, pcw = vio._cam_pose(Rci, Pci, rot, pos)
    tracked = vio.select_tracked(vm, cam, rcw, pcw, img, pg, pg_mask, vox, vox_mask,
                                 outlier_threshold, ncc_thre, ncc_en=ncc_en, **kw)
    new = vio.select_new_points(cam, rcw, pcw, img, pg, pg_mask, tracked.cell_value, **kw)
    return tracked, new, (rcw, pcw)


def check_map(where, vm, dev):
    """Raise unless the visual map's arrays are what the camera-frame
    kernels take: f32 points and rings, int32 indices, a u8 or f32 pool,
    a power-of-two voxel table, all contiguous on `dev`."""
    NP = vm.pos.shape[0]
    KO = vm.obs_fid.shape[1] if vm.obs_fid.ndim == 2 else -1
    T = vm.vox_keys.shape[0]
    VC = vm.vox_idx.shape[1] if vm.vox_idx.ndim == 2 else -1
    R = vm.img_fid.shape[0]
    if NP < 1 or KO < 1 or VC < 1 or T & (T - 1) or vm.imgs.ndim != 3:
        raise ValueError(f"{where}: a visual map of {NP} points, {KO} observations, "
                         f"{T} slots x {VC}, pool {tuple(vm.imgs.shape)}")
    if vm.imgs.dtype not in (torch.uint8, F32) or vm.imgs.shape[0] != R:
        raise ValueError(f"{where}: pool {tuple(vm.imgs.shape)} {vm.imgs.dtype} for {R} "
                         "slots (the whole pool, u8 or f32)")
    for name, shape, dtype in (
            ("pos", (NP, 3), F32), ("value", (NP,), F32), ("n_obs", (NP,), I32),
            ("n_pts", (), I32), ("obs_px", (NP, KO, 2), F32), ("obs_rcw", (NP, KO, 3, 3), F32),
            ("obs_pcw", (NP, KO, 3), F32), ("obs_slot", (NP, KO), I32),
            ("obs_fid", (NP, KO), I32), ("obs_level", (NP, KO), I32), ("vox_keys", (T,), I32),
            ("vox_count", (T,), I32), ("vox_idx", (T, VC), I32),
            ("imgs", tuple(vm.imgs.shape), vm.imgs.dtype), ("img_fid", (R,), I32)):
        _require(f"{where}: map.{name}", getattr(vm, name), shape, dtype, dev)
    return NP, KO, T, VC, R


def check_cam(where, cam, dev):
    for name in ("fx", "fy", "cx", "cy", "d"):
        _require(f"{where}: camera.{name}", getattr(cam, name), (4,) if name == "d" else (),
                 F32, dev)


@functools.cache
def _launcher():
    from . import _build

    fn = _build.load("vio_select").vio_select_launch
    fn.argtypes = ([ctypes.c_void_p] * 48 + [ctypes.c_int] * 16
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return _build.profiled("vio_select", fn)


def vio_select(vm, cam, rot, pos, Rci, Pci, img, pg, pg_mask, vox, vox_mask,
               outlier_threshold, ncc_thre, grid_size: int, patch_size: int, gw: int, gh: int,
               ncc_en: bool = False):
    """`vio_select_plain`'s signature and outputs: (TrackedSet, (pos (G, 3),
    px (G, 2), score (G,), add (G,)), (rcw (3, 3), pcw (3,))). A CUDA frame
    launches the kernel on the current stream (counted in
    `vio_select.launches`; the blocks launched in `vio_select.grid`); a
    CPU frame runs the plain version. No other device is taken and nothing
    falls back."""
    if img.device.type == "cpu":
        return vio_select_plain(vm, cam, rot, pos, Rci, Pci, img, pg, pg_mask, vox, vox_mask,
                                outlier_threshold, ncc_thre, grid_size, patch_size, gw, gh,
                                ncc_en)
    if img.device.type != "cuda":
        raise ValueError(f"vio_select: unsupported device {img.device}")
    from .. import vio

    dev = img.device
    NP, KO, T, VC, R = check_map("vio_select", vm, dev)
    check_cam("vio_select", cam, dev)
    P, G = int(patch_size), int(gw) * int(gh)
    if img.ndim != 2 or tuple(vm.imgs.shape[1:]) != tuple(img.shape):
        raise ValueError(f"vio_select: frame {tuple(img.shape)}, pool "
                         f"{tuple(vm.imgs.shape)}")
    H, W = img.shape
    if not 2 <= P <= MAX_PATCH or G < 1 or int(grid_size) < 1:
        raise ValueError(f"vio_select: patch_size {P} (2..{MAX_PATCH}), {gw}x{gh} cells, "
                         f"grid {grid_size}")
    M, Nv = pg.shape[0], vox.shape[0]
    if M < 1 or Nv < 1 or M >= 1 << 20 or Nv * VC >= 1 << 20:
        raise ValueError(f"vio_select: {M} scan rows and {Nv} x {VC} candidates (each "
                         "1 .. 2^20 - 1, the packed keys' row field)")
    thr = torch.as_tensor(outlier_threshold, dtype=F32, device=dev)
    ncc = torch.as_tensor(ncc_thre, dtype=F32, device=dev)
    for name, t, shape, dtype in (
            ("img", img, (H, W), F32), ("rot", rot, (3, 3), F64), ("pos", pos, (3,), F64),
            ("Rci", Rci, (3, 3), F32), ("Pci", Pci, (3,), F32), ("pg", pg, (M, 3), F32),
            ("pg_mask", pg_mask, (M,), torch.bool),
            ("vox", vox, (Nv, 3), I32), ("vox_mask", vox_mask, (Nv,), torch.bool),
            ("outlier_threshold", thr, (), F32), ("ncc_thre", ncc, (), F32)):
        _require(f"vio_select: {name}", t, shape, dtype, dev)
    f32 = dict(dtype=F32, device=dev)
    i32 = dict(dtype=I32, device=dev)
    # scratch: the candidates (index and position, 16-byte rows first), the
    # per-cell keys (int64), the owner image, the scan rows' depth, pixels
    # and scores
    NC = Nv * VC
    ws = torch.empty(4 * NC + 4 * G + H * W + 4 * M, **i32)
    cand = ws[:4 * NC].view(NC, 4)
    o = 4 * NC
    tkey, nkey = ws[o:o + 2 * G].view(I64), ws[o + 2 * G:o + 4 * G].view(I64)
    o += 4 * G
    owner = ws[o:o + H * W]
    o += H * W
    zrow, pcn, score = (ws[o:o + M].view(F32), ws[o + M:o + 3 * M].view(F32),
                        ws[o + 3 * M:o + 4 * M].view(F32))
    idx, slevel = torch.empty(G, **i32), torch.empty(G, **i32)
    wpos, patch = torch.empty((G, 3), **f32), torch.empty((G, 3, P, P), **f32)
    valid, nadd = (torch.empty(G, dtype=torch.bool, device=dev) for _ in range(2))
    cell_value, errors, nscore = (torch.empty(G, **f32) for _ in range(3))
    npos, npx = torch.empty((G, 3), **f32), torch.empty((G, 2), **f32)
    rcw, pcw = torch.empty((3, 3), **f32), torch.empty(3, **f32)
    ptrs = [t.data_ptr() for t in (
        vm.pos, vm.value, vm.obs_px, vm.obs_rcw, vm.obs_pcw, vm.obs_slot, vm.obs_fid,
        vm.vox_keys, vm.vox_count, vm.vox_idx, vm.imgs, vm.img_fid, cam.fx, cam.fy, cam.cx,
        cam.cy, cam.d, rot, pos, Rci, Pci, img, pg, pg_mask, vox, vox_mask, thr, ncc, tkey,
        nkey, owner, cand, zrow, pcn, score, idx, wpos, patch, slevel, valid, cell_value,
        errors, npos, npx, nscore, nadd, rcw, pcw)]
    grid = ctypes.c_int(0)
    err = _launcher()(*ptrs, NP, KO, T, VC, R, H, W, M, Nv, int(grid_size), int(gh), G, P,
                      int(bool(ncc_en)), MAX_PROBE, int(vm.imgs.dtype == torch.uint8),
                      ctypes.byref(grid), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vio_select: kernel launch failed (cudaError {err})")
    vio_select.launches += 1
    vio_select.grid = grid.value
    tracked = vio.TrackedSet(idx=idx, pos=wpos, patch=patch, search_level=slevel, valid=valid,
                             cell_value=cell_value, errors=errors)
    return tracked, (npos, npx, nscore, nadd), (rcw, pcw)


vio_select.launches = 0
vio_select.grid = 0
