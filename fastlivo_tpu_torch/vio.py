"""VIO: the sparse-direct photometric iterated-EKF update (camera frame).

Port of the JAX package's vio.py (the reference's `LidarSelector`,
src/lidar_selection.cpp). Per camera frame (`detect`, :1027-1075):

  1. `select_tracked` = addFromSparseMap (:346-587): sparse depth image
     of the last LiDAR cloud, visual-map points gathered from the scan's
     0.5 m voxels, the closest point per 40-px grid cell, the depth-
     continuity and best-view gates, the affine-warped reference patch at
     3 pyramid levels, the photometric outlier gate.
  2. `select_new_points` = addSparseMap (:142-202): per cell, the
     Shi-Tomasi-max scan point that beats the cell's map point.
  3. `photometric_update_levels` = ComputeJ/UpdateState (:743-983):
     coarse-to-fine iterated EKF on patch residuals with the
     error-monotonicity rollback. Each iteration's measurement (the
     projection, the patch and gradient sampling, the Jacobians and the
     [HᵀWH | HᵀWz] reduction) is one CUDA kernel, ops/photometric.py.
  4. `prep_observations` + visual_map.add_observations = addObservation
     (:913-965) at the posterior pose.

`vio_frame_step` runs the whole frame; `Vio` holds the map and feeds it.

Differences from the JAX package, none of which changes a result:
  - the photometric loop (a `lax.while_loop` there) is a host loop with
    one read of two flags per iteration; `iters` is the JAX package's;
  - the gain is the exact f64 `kalman_gain6_f64` (the JAX package uses
    its mixed-precision `kalman_gain6`);
  - where the JAX package divides by a constant under jit (the 40-px
    grid cell, the 0.2 m voxel filter, the robust scales), XLA multiplies
    by the f32 reciprocal; the port computes that form explicitly, with
    device tensors on both devices;
  - duplicate-index `set` scatters (the depth image) keep the last row,
    as XLA on the CPU does, by an explicit rule that holds on the card;
  - the visual map is updated in place (see visual_map.py).
The frame's stats row is read at once, or deferred (`async_read`, read
`async_depth` camera frames later) or handed to a block collector
(`read_collector`, replay.BlockReadCollector), as the pipeline sets;
under `cfg.debug` it is always read at once, and the frame's tracked
points are drawn on it (`render_overlay`, `Vio.last_overlay`).
`Vio.update_staged` runs the same frame one stage at a time (the JAX
package's unfused reference path), and `Vio.colorize` paints world points
from the last camera image (the RGB map cloud).

Over a device mesh (`mesh`, parallel.sharded.Mesh; the JAX package's
`axis_name`), every input replicated, the row-heavy stages split their
rows over the ranks and combine with min / max all-reduces (exact) and a
rank-order sum of the photometric partials (`Mesh.psum`), so every rank
holds the same bits; `pool_sharded` (the JAX package's `vmap_axis` /
`obs_axis`) keeps the image pool and the observation rings in per-rank
slabs (visual_map.py). `Vio(mesh_runner=)` runs the frame that way.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from . import camera as cam_mod
from . import visual_map as vmap_mod
from .config import Config
from .device import resolve_device
from .ops import image as img_ops
from .ops import linalg as linalg_ops
from .ops import so3
from .ops.photometric import _recip32, _rows_times, photometric_err_H
from .ops.voxel_filter import voxel_downsample_device
from .readback import DeferredRead
from .state import DIM_STATE, NavState

CONV_ROT_DEG = 0.001  # lidar_selection.cpp:885
CONV_POS_CM = 0.001
DEPTH_CONT_GATE = 1.5  # :504
VIO_LEAF = 0.2  # voxel filter of the camera frame's cloud (:352-353)
INT64_MAX = 0x7FFFFFFFFFFFFFFF
I32, I64, F64 = torch.int32, torch.int64, torch.float64


class TrackedSet(NamedTuple):
    """The SubSparseMap equivalent (common_lib.h:263-293): one slot per
    image grid cell."""

    idx: torch.Tensor  # (G,) visual-map point index
    pos: torch.Tensor  # (G, 3) world position
    patch: torch.Tensor  # (G, 3, P, P) warped reference patch pyramid
    search_level: torch.Tensor  # (G,) int32
    valid: torch.Tensor  # (G,) bool
    cell_value: torch.Tensor  # (G,) f32 best map-point score per cell
    errors: torch.Tensor  # (G,) f32 photometric error


def _const(v, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """A 0-d tensor on `like`'s device, so that an operation with it runs
    in one form on both devices (CUDA multiplies by the reciprocal of a
    CPU-scalar divisor instead of dividing)."""
    return torch.tensor(v, dtype=dtype or like.dtype, device=like.device)


def _pack_min(value_bits: torch.Tensor, row: torch.Tensor,
              cap: int | None = None) -> torch.Tensor:
    """Pack (non-negative f32 bits, row) into int64 for a scatter-min
    argmin; the row takes the low 20 bits. `cap`: the row ids' range when
    `row` holds global ids of a batch split over a mesh (its local length
    understates them); else the row count."""
    cap = row.shape[-1] if cap is None else cap
    if cap >= (1 << 20):
        raise ValueError(f"_pack_min: {cap} rows exceed the 20-bit row field")
    return (value_bits.to(I64) << 20) | row.to(I64)


def _f32_bits(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving int32 bits of non-negative f32."""
    return x.contiguous().view(I32)


def _to_gray_dev(img: torch.Tensor) -> torch.Tensor:
    """BGR -> gray on the device with the numpy path's semantics: integer
    frames promote to f64, float frames keep their dtype, the same
    association order, then the f32 cast (detect :1037)."""
    wt = img.dtype if img.dtype.is_floating_point else F64
    b, g, r = (img[..., c].to(wt) for c in range(3))
    return (0.114 * b + 0.587 * g + 0.299 * r).to(torch.float32)


def _bilinear_resize(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """Host bilinear resample to (H, W), half-pixel-centred (cv::resize
    INTER_LINEAR), for frames not at the camera model's size."""
    h, w = img.shape
    ys = np.clip((np.arange(H) + 0.5) * h / H - 0.5, 0, h - 1)
    xs = np.clip((np.arange(W) + 0.5) * w / W - 0.5, 0, w - 1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    fy = (ys - y0)[:, None].astype(np.float32)
    fx = (xs - x0)[None, :].astype(np.float32)
    top = img[y0][:, x0] * (1 - fx) + img[y0][:, x1] * fx
    bot = img[y1][:, x0] * (1 - fx) + img[y1][:, x1] * fx
    return (top * (1 - fy) + bot * fy).astype(np.float32)


def _cells(pc: torch.Tensor, grid_size: int, gh: int, G: int) -> torch.Tensor:
    """Grid cell of each pixel: int(u/grid)*gh + int(v/grid), clipped.
    The division is the JAX package's multiply by the f32 reciprocal."""
    inv = _const(_recip32(grid_size), pc)
    cell = (pc[:, 0] * inv).to(I32) * gh + (pc[:, 1] * inv).to(I32)
    return torch.clamp(cell, 0, G - 1)


def _scatter_min(G: int, cell: torch.Tensor, ok: torch.Tensor,
                 key: torch.Tensor) -> torch.Tensor:
    """(G,) int64 per-cell minimum of `key` over the ok rows (INT64_MAX
    for an empty cell); min is order-free, so the card agrees."""
    tgt = torch.where(ok, cell, G).long()
    out = torch.full((G + 1,), INT64_MAX, dtype=I64, device=key.device)
    return out.scatter_reduce_(0, tgt, key, "amin")[:G]


def _winner_rows(cell_min: torch.Tensor) -> torch.Tensor:
    return (cell_min & 0xFFFFF).to(I32)


def select_tracked(
    vm: vmap_mod.VisualMap,
    cam: cam_mod.Camera,
    rcw: torch.Tensor,  # (3, 3) world->cam f32
    pcw: torch.Tensor,  # (3,)
    img: torch.Tensor,  # (H, W) f32 current grayscale
    pg: torch.Tensor,  # (M, 3) downsampled world cloud (0.2 m)
    pg_mask: torch.Tensor,  # (M,)
    vox: torch.Tensor,  # (Nv, 3) int32 unique scan voxels
    vox_mask: torch.Tensor,  # (Nv,)
    outlier_threshold,  # 0-d f32 tensor or float
    ncc_thre,
    grid_size: int,
    patch_size: int,
    gw: int,
    gh: int,
    ncc_en: bool = False,
    mesh=None,
    pool_sharded: bool = False,
) -> TrackedSet:
    """addFromSparseMap (lidar_selection.cpp:346-587), see the module doc.

    `mesh` (parallel.sharded.Mesh; every input replicated): each rank
    scores its rows of the NC candidate rows (zero-padded to a multiple
    of the mesh size), keyed by their global row, and the per-cell
    winners combine with an all-reduce min (packed keys) and max
    (`cell_value`); the winners' geometry is derived again from the
    replicated map with the same per-row operations, so it equals the
    single-device rows bit for bit. Phases 3-5 then run on this rank's
    slab of ceil(G/n) cells, which is what the returned TrackedSet holds
    (`cell_value` stays whole). `pool_sharded`: the image pool and the
    observation rings are this rank's slabs (visual_map's slab layout);
    phases 3-5 run on all G cells, the reference observations are
    gathered from their owners, each rank warps the patches of the
    images it holds and the mesh sums them (one owner per patch), and
    the slab is cut at the end: the same output."""
    if pool_sharded and mesh is None:
        raise ValueError("pool_sharded (the sharded visual map) requires a mesh")
    H, W = img.shape
    dev = img.device
    G = gw * gh
    P = patch_size
    half = P // 2
    border = (half + 1) * 8  # isInFrame margin (:399, :446)
    campos = -pcw @ rcw

    # --- phase 1: sparse depth image (:378-411, plain pinhole) ----------
    pt_c = pg @ rcw.T + pcw
    z = pt_c[:, 2]
    u = cam.fx * pt_c[:, 0] / z + cam.cx
    v = cam.fy * pt_c[:, 1] / z + cam.cy
    ok_d = (pg_mask & (z > 0) & (u >= border) & (u < W - border)
            & (v >= border) & (v < H - border))
    flat = torch.where(ok_d, v.to(I32).long() * W + u.to(I32).long(), H * W)
    win = vmap_mod._last_wins(flat, ok_d, H * W)  # many points, one pixel
    depth = torch.zeros(H * W + 1, dtype=img.dtype, device=dev)
    depth[torch.where(win, flat, H * W)] = torch.where(ok_d, z, 0.0)
    depth = depth[:H * W].reshape(H, W)

    # --- phase 2: candidate gather + per-cell closest winner (:423-467) --
    cidx, cmask = vmap_mod.gather_voxel_points(vm, vox, vox_mask)
    cidx = cidx.reshape(-1)
    cmask = cmask.reshape(-1)
    NC = cidx.shape[0]
    rows = torch.arange(NC, device=dev)
    if mesh is None:
        cidx_l, cmask_l, rows_l, NCp = cidx, cmask, rows, NC
    else:  # this rank's rows of the padded batch, keyed by global row
        cidx_l, cmask_l, rows_l = mesh.slab(cidx), mesh.slab(cmask), mesh.slab(rows)
        NCp = cidx_l.shape[0] * mesh.size
    NP = vm.pos.shape[0]
    safe = torch.clamp(cidx_l, 0, NP - 1).long()
    cpos = vm.pos[safe]
    cvalue = vm.value[safe]
    c_cam = _rows_times(cpos, rcw) + pcw
    front = c_cam[:, 2] > 0
    pc = cam_mod.world2cam(cam, c_cam)
    ok = cmask_l & front & cam_mod.is_in_frame(cam, pc, border)
    cell = _cells(pc, grid_size, gh, G)
    dist = torch.linalg.norm(campos[None, :] - cpos, dim=-1)
    key = _pack_min(_f32_bits(dist), rows_l, cap=NCp)
    key = torch.where(ok, key, INT64_MAX)
    cell_min = _scatter_min(G, cell, ok, key)
    # best map-point value per cell (map_value, :460-463)
    cell_value = torch.zeros(G + 1, dtype=img.dtype, device=dev).scatter_reduce_(
        0, torch.where(ok, cell, G).long(), torch.where(ok, cvalue, 0.0),
        "amax")[:G]
    if mesh is not None:
        cell_min = mesh.all_reduce(cell_min, "min")
        cell_value = mesh.all_reduce(cell_value, "max")
    has_map = cell_min < INT64_MAX
    wsafe = torch.clamp(_winner_rows(cell_min), 0, NC - 1).long()
    widx = cidx[wsafe]
    if mesh is None:
        wpos = cpos[wsafe]
        wcam = c_cam[wsafe]
        wpc = pc[wsafe]
    else:
        # the winner's row is global: its geometry again from the map,
        # with phase 2's per-row operations
        wpos = vm.pos[torch.clamp(widx, 0, NP - 1).long()]
        wcam = _rows_times(wpos, rcw) + pcw
        wpc = cam_mod.world2cam(cam, wcam)
        if not pool_sharded:  # phases 3-5 on this rank's cell slab
            has_map, widx, wpos, wcam, wpc = (
                mesh.slab(a) for a in (has_map, widx, wpos, wcam, wpc))
    K = widx.shape[0]

    # --- phase 3: depth-continuity gate (:489-510) ------------------------
    offs = torch.arange(-half, half + 1, dtype=I32, device=dev)
    r0 = wpc[:, 1].to(I32)
    c0 = wpc[:, 0].to(I32)
    rr = torch.clamp(r0[:, None, None] + offs[None, :, None], 0, H - 1).long()
    cc = torch.clamp(c0[:, None, None] + offs[None, None, :], 0, W - 1).long()
    dwin = depth[rr, cc]  # (K, 2h+1, 2h+1)
    center = torch.zeros((2 * half + 1, 2 * half + 1), dtype=torch.bool, device=dev)
    center[half, half] = True
    broke = ((dwin != 0.0) & ~center[None]
             & (torch.abs(wcam[:, 2:3, None] - dwin) > DEPTH_CONT_GATE))
    depth_ok = ~torch.any(broke.reshape(K, -1), dim=1)

    # --- phase 4: reference observation + warp (:518-555) ----------------
    ref = vmap_mod.close_view_obs(vm, widx, campos, mesh if pool_sharded else None)
    t_ok = has_map & depth_ok & ref["ok"]
    depth_ref = torch.linalg.norm(ref["campos"] - wpos, dim=-1)
    # bearing from the stored pixel (Feature::f = cam2world(px))
    f_ref = cam_mod.cam2world(cam, ref["px"])
    xyz_ref = f_ref * depth_ref[:, None]
    # pixel offsets on the ref image (level_ref = 0, pyramid_level = 0)
    du_px = ref["px"] + torch.tensor([half, 0.0], dtype=img.dtype, device=dev)
    dv_px = ref["px"] + torch.tensor([0.0, half], dtype=img.dtype, device=dev)
    f_du = cam_mod.cam2world(cam, du_px)
    f_dv = cam_mod.cam2world(cam, dv_px)
    xyz_du = f_du * (xyz_ref[:, 2] / f_du[:, 2])[:, None]
    xyz_dv = f_dv * (xyz_ref[:, 2] / f_dv[:, 2])[:, None]
    # T_cur_ref
    R_cr = torch.einsum("ij,kmj->kim", rcw, ref["rcw"])  # rcw @ ref_rcw^T
    t_cr = pcw[None, :] - torch.einsum("kim,km->ki", R_cr, ref["pcw"])

    def proj(x):
        return cam_mod.world2cam(cam, torch.einsum("kim,km->ki", R_cr, x) + t_cr)

    px_cur = proj(xyz_ref)
    px_du = proj(xyz_du)
    px_dv = proj(xyz_dv)
    A = torch.stack([(px_du - px_cur) / half, (px_dv - px_cur) / half],
                    dim=-1)  # (K, 2, 2) columns
    detA = A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
    search_level = (detA > 3.0).to(I32) + (detA > 12.0).to(I32)
    inv_det = 1.0 / torch.where(torch.abs(detA) < 1e-12,
                                torch.full_like(detA, 1e-12), detA)
    A_inv = torch.stack([
        torch.stack([A[:, 1, 1], -A[:, 0, 1]], -1),
        torch.stack([-A[:, 1, 0], A[:, 0, 0]], -1),
    ], dim=-2) * inv_det[:, None, None]
    slot = ref["slot"]
    if pool_sharded:  # this rank's images only; the others zero
        Rl = vm.imgs.shape[0]
        loc = slot - mesh.rank * Rl
        mine = (loc >= 0) & (loc < Rl)
        slot = torch.clamp(loc, 0, Rl - 1)
    patches = torch.stack([
        img_ops.affine_warp_patches(vm.imgs, slot, A_inv, ref["px"],
                                    P, search_level, lvl)
        for lvl in range(3)], dim=1)  # (K, 3, P, P)
    if pool_sharded:  # one owner per patch: the sum is exact
        keep = mine[:, None, None, None]
        patches = mesh.all_reduce(torch.where(keep, patches, torch.zeros_like(patches)))

    # --- phase 5: photometric outlier gate (:557-570) ---------------------
    cur_patch = img_ops.extract_patches(img, wpc, P, 1)
    err0 = torch.sum((patches[:, 0] - cur_patch) ** 2, dim=(-2, -1))
    thr = torch.as_tensor(outlier_threshold, dtype=img.dtype, device=dev)
    t_ok = t_ok & (err0 <= thr * P * P)
    if ncc_en:
        a = patches[:, 0].reshape(K, -1)
        b = cur_patch.reshape(K, -1)
        am = a - a.mean(-1, keepdim=True)
        bm = b - b.mean(-1, keepdim=True)
        ncc = torch.sum(am * bm, -1) / torch.sqrt(
            torch.sum(am * am, -1) * torch.sum(bm * bm, -1) + 1e-10)
        t_ok = t_ok & (ncc >= torch.as_tensor(ncc_thre, dtype=img.dtype, device=dev))
    if pool_sharded:
        widx, wpos, patches, search_level, t_ok, err0 = (
            mesh.slab(a) for a in (widx, wpos, patches, search_level, t_ok, err0))
    return TrackedSet(idx=widx, pos=wpos, patch=patches,
                      search_level=search_level, valid=t_ok,
                      cell_value=cell_value, errors=err0)


def select_new_points(cam: cam_mod.Camera, rcw: torch.Tensor, pcw: torch.Tensor,
                      img: torch.Tensor, pg: torch.Tensor, pg_mask: torch.Tensor,
                      cell_value: torch.Tensor, grid_size: int,
                      patch_size: int, gw: int, gh: int, mesh=None):
    """addSparseMap winner selection (:150-167 + :173-195): per cell the
    max-Shi-Tomasi scan point, added iff it beats the cell's map score.
    Returns (pos (G,3), px (G,2), score (G,), add_mask (G,)).

    `mesh` (inputs replicated): each rank scores its rows of the M
    candidates (zero-padded to a multiple of the mesh size), the per-cell
    winners combine with an all-reduce min of packed keys, and the G
    winners are projected and scored again from the replicated inputs
    with the same per-row operations: every output is whole and equals
    the single-device one bit for bit."""
    G = gw * gh
    border = (patch_size // 2 + 1) * 8
    M = pg.shape[0]
    rows = torch.arange(M, device=pg.device)
    if mesh is None:
        pg_l, mask_l, rows_l, Mp = pg, pg_mask, rows, M
    else:
        pg_l, mask_l, rows_l = mesh.slab(pg), mesh.slab(pg_mask), mesh.slab(rows)
        Mp = pg_l.shape[0] * mesh.size
    p_cam = _rows_times(pg_l, rcw) + pcw
    pc = cam_mod.world2cam(cam, p_cam)
    ok = mask_l & (p_cam[:, 2] > 0) & cam_mod.is_in_frame(cam, pc, border)
    score = img_ops.shi_tomasi(img, pc)
    cell = _cells(pc, grid_size, gh, G)
    # argmax by a packed scatter-min of (inverted score bits, row)
    inv_bits = 0x7FFFFFFF - _f32_bits(torch.clamp(score, min=0.0))
    key = _pack_min(inv_bits, rows_l, cap=Mp)
    key = torch.where(ok, key, INT64_MAX)
    cell_min = _scatter_min(G, cell, ok, key)
    if mesh is not None:
        cell_min = mesh.all_reduce(cell_min, "min")
    found = cell_min < INT64_MAX
    row = torch.clamp(_winner_rows(cell_min), 0, M - 1).long()
    if mesh is None:
        wscore, wpc = score[row], pc[row]
    else:  # global winner rows: project and score them again
        wpc = cam_mod.world2cam(cam, _rows_times(pg[row], rcw) + pcw)
        wscore = img_ops.shi_tomasi(img, wpc)
    add = found & (wscore > cell_value)  # beats the map (:160)
    return pg[row], wpc, wscore, add


def photometric_update_levels(
    state: NavState,
    prior: NavState,
    cam: cam_mod.Camera,
    img: torch.Tensor,
    tr_pos: torch.Tensor,  # (G, 3)
    tr_patch: torch.Tensor,  # (G, 3, P, P)
    tr_slevel: torch.Tensor,  # (G,)
    tr_valid: torch.Tensor,  # (G,)
    Rci: torch.Tensor,  # (3, 3) f32
    Pci: torch.Tensor,  # (3,)
    Jdphi_dR: torch.Tensor,  # (3, 3)
    Jdp_dR: torch.Tensor,  # (3, 3)
    img_point_cov,
    patch_size: int,
    levels: tuple = (2, 1, 0),
    max_iter: int = 10,
    robust: str = "none",
    robust_scale: float = 10.0,
    mesh=None,
):
    """The coarse-to-fine UpdateState cascade (lidar_selection.cpp:
    743-902, levels 2 -> 0 as :1052-1066 calls it), one host loop.

    Each iteration's measurement [HᵀH | Hᵀz], mean error and per-point
    errors is one call of ops/photometric.photometric_err_H (one kernel
    launch on the card); the prior-anchored f64 step stays in torch. An
    iteration whose mean patch error grew rolls the state back and ends
    its level, as do convergence and the iteration budget; the next
    level starts afresh. One host read of two flags per iteration.
    `robust`: IRLS weights "huber" (k=1.345) or "tukey" (b=4.6851) on
    |res|/robust_scale, on the HᵀWH/HᵀWz rows only.

    `mesh` (parallel.sharded.Mesh): the tracked set is this rank's cell
    slab, the image and the state replicated. Each iteration the ranks
    sum [HᵀH | Hᵀz | Σperr | n_meas] in rank order (`Mesh.psum`, one
    collective of 44 floats; each rank's n_meas clamped to at least 1,
    as the JAX package's psums are), and form the mean error from the
    sum: every rank runs the same f64 step on the same bits and reads
    the same flags.

    Returns (state, G (18,6) f64, per-point errors, mean_error (f64),
    iterations), the G and errors of the last level (under a mesh the
    errors are this rank's slab)."""
    G_, P = tr_pos.shape[0], patch_size
    dtype = img.dtype
    dev = img.device
    n_lv = len(levels)
    if max_iter <= 0:
        return (state, torch.zeros((DIM_STATE, 6), dtype=F64, device=dev),
                torch.full((G_,), 1e10, dtype=dtype, device=dev),
                torch.tensor(1e10, dtype=F64, device=dev), 0)

    # loop-invariant f64 prior terms
    P_ = prior.cov.to(F64) / torch.as_tensor(img_point_cov, dtype=F64, device=dev)
    prior_x = torch.cat([prior.pos, prior.vel, prior.bg, prior.ba, prior.grav])
    gain = linalg_ops.kalman_gain6_f64
    big = lambda: torch.tensor(1e10, dtype=F64, device=dev)  # noqa: E731

    rot = state.rot.contiguous()
    x = torch.cat([state.pos, state.vel, state.bg, state.ba, state.grav])
    o_rot, o_x = rot, x
    last_err = big()
    HTH6b = torch.zeros((6, 6), dtype=F64, device=dev)
    perr_out = torch.full((G_,), 1e10, dtype=dtype, device=dev)
    it_l = its = li = 0
    done = False
    while not done:
        lv = levels[li]
        meas = (img, tr_pos, tr_patch[:, lv], tr_slevel, tr_valid, rot, x[0:3], Rci, Pci,
                Jdphi_dR, Jdp_dR, cam, lv, P, robust, robust_scale)
        if mesh is None:
            err, HTH6, HTz, perr = photometric_err_H(*meas)
        else:
            parts, perr = photometric_err_H(*meas, partials=True)
            tot = mesh.psum(parts)
            HT = tot[:42].view(6, 7)
            HTH6, HTz = HT[:, 0:6], HT[:, 6]
            err = tot[42] / torch.clamp(tot[43], min=1.0)
        HTH6 = HTH6.to(F64)
        K16 = gain(P_, HTH6)
        vec = torch.cat([so3.log(rot.T @ prior.rot), prior_x - x])
        sol = vec - K16 @ (HTz.to(F64) + HTH6 @ vec[0:6])
        n_rot = rot @ so3.exp(sol[0:3])
        n_x = x + sol[3:18]
        conv = ((torch.linalg.norm(sol[0:3]) * 57.3 < CONV_ROT_DEG)
                & (torch.linalg.norm(sol[3:6]) * 100.0 < CONV_POS_CM))
        improved, conv = torch.stack([err <= last_err, conv]).tolist()
        if improved:  # keep the current state as the rollback point
            o_rot, o_x = rot, x
            rot, x = n_rot, n_x
            last_err, HTH6b, perr_out = err.to(F64), HTH6, perr
        else:  # roll back and stop the level (:889-892)
            rot, x = o_rot, o_x
        level_done = (not improved) or conv or it_l + 1 >= max_iter
        done = level_done and li == n_lv - 1
        it_l = 0 if level_done else it_l + 1
        its += 1
        if level_done and not done:  # next level: a fresh UpdateState
            li += 1
            o_rot, o_x = rot, x
            last_err = big()
            HTH6b = torch.zeros((6, 6), dtype=F64, device=dev)
            perr_out = torch.full((G_,), 1e10, dtype=dtype, device=dev)
    # G = K·HᵀH of the last accepted iteration (zero when nothing tracked)
    Gmat = gain(P_, HTH6b) @ HTH6b
    new_state = NavState(rot, x[0:3], x[3:6], x[6:9], x[9:12], x[12:15], state.cov)
    return new_state, Gmat, perr_out, last_err, its


def photometric_update(state, prior, cam, img, tr_pos, tr_patch, tr_slevel,
                       tr_valid, Rci, Pci, Jdphi_dR, Jdp_dR, img_point_cov,
                       patch_size: int, level: int, max_iter: int,
                       robust: str = "none", robust_scale: float = 10.0, mesh=None):
    """UpdateState for one pyramid level (lidar_selection.cpp:743-902);
    `mesh` as for photometric_update_levels."""
    return photometric_update_levels(
        state, prior, cam, img, tr_pos, tr_patch, tr_slevel, tr_valid,
        Rci, Pci, Jdphi_dR, Jdp_dR, img_point_cov, patch_size,
        levels=(level,), max_iter=max_iter, robust=robust,
        robust_scale=robust_scale, mesh=mesh)


def _dedup_voxels(pg: torch.Tensor, pg_mask: torch.Tensor, max_vox: int):
    """Sort-free dedup + compaction of the scan cloud's 0.5 m voxel keys
    (the sub_feat_map key set, addFromSparseMap :361-380): four rounds of
    a linear-probed hash where rows scatter-min their row id; a row whose
    slot winner has the same key is resolved. Leftovers after four rounds
    are kept (possible duplicates, which select_tracked tolerates)."""
    keys = vmap_mod.voxel_of(pg)  # (M, 3) int32
    M = keys.shape[0]
    dev = pg.device
    TB = 1 << int(M).bit_length()
    # int32 products wrap, as in the JAX package
    h = ((keys[:, 0] * 73856093) ^ (keys[:, 1] * 19349663)
         ^ (keys[:, 2] * 83492791)) & (TB - 1)
    rid = torch.arange(M, dtype=I32, device=dev)
    rid_m = torch.where(pg_mask, rid, M)
    resolved = ~pg_mask
    is_winner = torch.zeros(M, dtype=torch.bool, device=dev)
    for p in range(4):
        slot_p = ((h + p) & (TB - 1)).long()
        contend = torch.where(resolved, M, rid_m)
        win = torch.full((TB,), M, dtype=I32, device=dev).scatter_reduce_(
            0, slot_p, contend, "amin")
        w = win[slot_p]
        same_key = torch.all(keys == keys[torch.clamp(w, 0, M - 1).long()], dim=-1)
        is_winner = is_winner | (~resolved & (w == rid))
        resolved = resolved | (~resolved & (w < M) & same_key)
    keep = pg_mask & (is_winner | ~resolved)
    rank = torch.cumsum(keep.to(I32), 0) - 1
    out_idx = torch.where(keep & (rank < max_vox), rank, max_vox).long()
    # unique destinations; the sentinel row max_vox takes the dropped
    vox = torch.zeros((max_vox + 1, 3), dtype=I32, device=dev)
    vox[out_idx] = keys
    vmask = torch.zeros(max_vox + 1, dtype=torch.bool, device=dev)
    vmask[out_idx] = True
    return vox[:max_vox], vmask[:max_vox]


def prep_observations(vm: vmap_mod.VisualMap, cam: cam_mod.Camera,
                      rcw: torch.Tensor, pcw: torch.Tensor, img: torch.Tensor,
                      idx: torch.Tensor, valid: torch.Tensor, mesh=None):
    """addObservation conditions against the most recent observation
    (lidar_selection.cpp:928-950): add when Δp > 0.5 m, Δθ > 10 (radians
    compared with 10, as the reference does) or the pixel distance > 40.
    Returns (px, score, add_mask). `mesh`: the rings are in slabs
    (visual_map's slab layout), their fields gathered from the owners."""
    NP = vm.pos.shape[0]
    safe = torch.clamp(idx, 0, NP - 1)
    pf = vm.pos[safe.long()] @ rcw.T + pcw
    pc = cam_mod.world2cam(cam, pf)
    o_px, o_rcw, o_pcw, _, o_fid, _ = vmap_mod._gather_obs(vm, safe, mesh)
    last = torch.argmax(o_fid, dim=-1)  # most recent observation
    K = safe.shape[0]

    def take(a):
        b = last.reshape(K, *([1] * (a.ndim - 1))).expand(K, 1, *a.shape[2:])
        return torch.gather(a, 1, b)[:, 0]

    ref_rcw, ref_pcw, ref_px = take(o_rcw), take(o_pcw), take(o_px)
    # the JAX package's einsum("kij,mj->kim", ref_rcw, rcw.T), which is
    # ref_rcw @ rcw (its comment says ref_rcw @ rcw^T)
    Rd = torch.einsum("kij,mj->kim", ref_rcw, rcw.T)
    td = ref_pcw - torch.einsum("kim,m->ki", Rd, pcw)
    delta_p = torch.linalg.norm(td, dim=-1)
    tr = Rd[:, 0, 0] + Rd[:, 1, 1] + Rd[:, 2, 2]
    delta_theta = torch.where(
        tr > 3.0 - 1e-6, torch.zeros_like(tr),
        torch.arccos(torch.clamp(0.5 * (tr - 1.0), -1.0, 1.0)))
    pix_dist = torch.linalg.norm(pc - ref_px, dim=-1)
    add = valid & ((delta_p > 0.5) | (delta_theta > 10.0) | (pix_dist > 40.0))
    return pc, img_ops.shi_tomasi(img, pc), add


def vio_frame_step(
    vm: vmap_mod.VisualMap,  # updated IN PLACE
    cam: cam_mod.Camera,
    state: NavState,
    prior: NavState,
    gray: torch.Tensor,  # (H, W) f32
    meta: torch.Tensor,  # (2,) int32 [n_cloud_points, frame_id]
    cloud: torch.Tensor,  # (R, 3) world cloud of the last scan
    Rci: torch.Tensor,
    Pci: torch.Tensor,
    Jdphi_dR: torch.Tensor,
    Jdp_dR: torch.Tensor,
    outlier_threshold,
    ncc_thre,
    img_point_cov,
    *,
    grid_size: int,
    patch_size: int,
    gw: int,
    gh: int,
    ncc_en: bool,
    max_iter: int,
    max_pg: int,
    robust: str = "none",
    mesh=None,
    pool_sharded: bool = False,
):
    """The whole camera frame (`detect`, lidar_selection.cpp:1027-1075):
    image pool push, voxel filter of the scan cloud, visible-voxel set,
    tracked-point selection + warp, new-point selection, the 3-level
    photometric EKF, covariance contraction, observation maintenance and
    new-point insertion. Each stage is a named `record_function` range
    ("vio.*"). With zero tracked points the photometric stages are exact
    no-ops (HᵀH = Hᵀz = 0, the step pulls the state to the prior, which
    it equals at entry, and G = 0 leaves the covariance).

    `mesh` (parallel.sharded.Mesh, every input replicated): the candidate
    and new-point scoring and the photometric EKF split their rows over
    the ranks (select_tracked, select_new_points,
    photometric_update_levels); the tracked cell slabs are gathered back
    to all G cells (one collective) for the map updates, which every rank
    applies alike. `pool_sharded`: `vm` holds this rank's slabs of the
    image pool and the observation rings; the push, the ring reads and
    the ring writes go through their owners (visual_map's slab layout).

    Returns (state', vmap, tracked_idx, tracked_valid, obs_px, per-point
    errors, mean_err, n_tracked, n_added, iters, stats); `stats` (29,)
    f64 packs [n_tracked, n_added, mean_err, iters, rcw'(9), pcw'(3),
    0 (12), n_pts] for one device-to-host read."""
    if pool_sharded and mesh is None:
        raise ValueError("pool_sharded (the sharded visual map) requires a mesh")
    f32 = gray.dtype
    fid = meta[1]
    slab_mesh = mesh if pool_sharded else None
    cloud_mask = torch.arange(cloud.shape[0], device=cloud.device) < meta[0]
    with record_function("vio.push"):
        vm = vmap_mod.push_image(vm, gray, fid, slab_mesh)
    with record_function("vio.voxel_filter"):
        pg, pg_mask = voxel_downsample_device(
            cloud, cloud_mask, None, max_pg,
            inv_leaf=_const(_recip32(VIO_LEAF), cloud))
        vox, vox_mask = _dedup_voxels(pg, pg_mask, max_pg // 2)

    rcw = Rci @ state.rot.to(f32).T
    pcw = -rcw @ state.pos.to(f32) + Pci
    with record_function("vio.select_tracked"):
        tracked = select_tracked(
            vm, cam, rcw, pcw, gray, pg, pg_mask, vox, vox_mask,
            outlier_threshold, ncc_thre, grid_size=grid_size,
            patch_size=patch_size, gw=gw, gh=gh, ncc_en=ncc_en, mesh=mesh,
            pool_sharded=pool_sharded)
    with record_function("vio.select_new"):
        npos, npx, nscore, nadd = select_new_points(
            cam, rcw, pcw, gray, pg, pg_mask, tracked.cell_value,
            grid_size=grid_size, patch_size=patch_size, gw=gw, gh=gh, mesh=mesh)
    with record_function("vio.photometric"):
        st, Gmat, perr, err, its = photometric_update_levels(
            state, prior, cam, gray, tracked.pos, tracked.patch,
            tracked.search_level, tracked.valid, Rci, Pci, Jdphi_dR, Jdp_dR,
            img_point_cov=img_point_cov, patch_size=patch_size,
            levels=(2, 1, 0), max_iter=max_iter, robust=robust, mesh=mesh)
        # cov <- cov - G cov (:980); G = 0 when nothing was tracked
        st = st._replace(cov=st.cov - Gmat @ st.cov[0:6, :])

    with record_function("vio.observations"):
        t_idx, t_valid, t_slevel = tracked.idx, tracked.valid, tracked.search_level
        if mesh is not None:
            # the cell slabs back to all G cells, in one int32 gather
            # (perr travels as its bits)
            cols = mesh.all_gather(torch.stack(
                [t_idx, t_valid.to(I32), t_slevel, perr.view(I32)], 1))[:gw * gh]
            t_idx, t_valid, t_slevel = cols[:, 0], cols[:, 1].bool(), cols[:, 2]
            perr = cols[:, 3].contiguous().view(f32)
        rcw2 = Rci @ st.rot.to(f32).T
        pcw2 = -rcw2 @ st.pos.to(f32) + Pci
        opc, oscore, oadd = prep_observations(vm, cam, rcw2, pcw2, gray,
                                              t_idx, t_valid, slab_mesh)
        vm = vmap_mod.add_observations(vm, t_idx, opc, rcw2, pcw2, oscore,
                                       fid, t_slevel, oadd, slab_mesh)
        vm = vmap_mod.add_points(vm, npos, npx, rcw, pcw, nscore, fid, nadd,
                                 mesh=slab_mesh)
    n_tracked = t_valid.sum(dtype=I32)
    n_added = nadd.sum(dtype=I32)
    dev = gray.device
    stats = torch.cat([
        torch.stack([n_tracked.to(F64), n_added.to(F64), err.to(F64),
                     torch.tensor(float(its), dtype=F64, device=dev)]),
        rcw2.reshape(9).to(F64), pcw2.to(F64),
        torch.zeros(12, dtype=F64, device=dev),
        vm.n_pts.to(F64)[None],
    ])
    return (st, vm, t_idx, t_valid, opc, perr, err, n_tracked, n_added,
            its, stats)


def render_overlay(gray: np.ndarray, px: np.ndarray, errors: np.ndarray,
                   valid: np.ndarray, radius: int = 6) -> np.ndarray:
    """display_keypatch parity (lidar_selection.cpp:985-1005): RGB image
    with filled circles at tracked points — green where the photometric
    error < 8000, blue otherwise. Host numpy, as in the JAX package."""
    H, W = gray.shape
    rgb = np.stack([gray] * 3, -1).astype(np.uint8)
    yy, xx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    disk = (yy * yy + xx * xx) <= radius * radius
    for (u, v), e, ok in zip(px, errors, valid):
        if not ok:
            continue
        r0, c0 = int(v) - radius, int(u) - radius
        r1, c1 = r0 + disk.shape[0], c0 + disk.shape[1]
        rr0, cc0 = max(r0, 0), max(c0, 0)
        rr1, cc1 = min(r1, H), min(c1, W)
        if rr1 <= rr0 or cc1 <= cc0:
            continue
        sub = disk[rr0 - r0:rr1 - r0, cc0 - c0:cc1 - c0]
        color = (0, 255, 0) if e < 8000 else (0, 0, 255)
        for ch in range(3):
            rgb[rr0:rr1, cc0:cc1, ch][sub] = color[ch]
    return rgb


class Vio:
    """Host-side orchestration of the per-image VIO step (the
    LidarSelector object, lidar_selection.h:37-171), on `device` (CUDA
    unless given).

    `mesh_runner` (parallel.product.MeshRunner, set up by
    `Pipeline(cfg, mesh=...)`): the camera frame runs over its mesh, on
    the mesh's device, with the same outputs on every rank. With the
    runner's `sharded_map` the image pool and the observation rings are
    held in slabs, one per rank (`pool_sharded`, visual_map's slab
    layout)."""

    def __init__(self, cfg: Config, device=None, mesh_runner=None):
        cap = cfg.capacity
        self.cfg = cfg
        self.mesh_runner = mesh_runner
        self.mesh = None if mesh_runner is None else mesh_runner.mesh
        if self.mesh is not None:
            if device is not None and resolve_device(device) != self.mesh.device:
                raise ValueError(f"device {device} is not the mesh's {self.mesh.device}")
            device = self.mesh.device
        self.pool_sharded = bool(mesh_runner is not None and mesh_runner.sharded_map)
        # the mesh of visual_map's slab layout, or None with the whole map here
        self.slab_mesh = self.mesh if self.pool_sharded else None
        # under a mesh, rank 0 alone draws the debug overlay
        self.lead = self.mesh is None or self.mesh.rank == 0
        self.device = resolve_device(device)
        dev = self.device
        self.cam = cam_mod.from_config(cfg.camera, dev)
        self.grid_size = cfg.grid_size
        self.patch_size = cfg.patch_size
        self.gw = cfg.camera.width // cfg.grid_size
        self.gh = cfg.camera.height // cfg.grid_size
        # extrinsics (lidar_selection.cpp:35-52): Rli/Pli are IMU->lidar
        R_li = cfg.extrinsic_R  # lidar -> IMU
        t_li = cfg.extrinsic_T
        Rli = R_li.T
        Pli = -R_li.T @ t_li
        Rci = cfg.Rcl_mat @ Rli
        Pci = cfg.Rcl_mat @ Pli + cfg.Pcl_vec
        Pic = -Rci.T @ Pci
        f32 = dict(dtype=torch.float32, device=dev)
        self.Rci = torch.as_tensor(Rci, **f32)
        self.Pci = torch.as_tensor(Pci, **f32)
        self.Jdphi_dR = torch.as_tensor(Rci, **f32)
        skew_pic = np.array([[0, -Pic[2], Pic[1]], [Pic[2], 0, -Pic[0]],
                             [-Pic[1], Pic[0], 0]])
        self.Jdp_dR = torch.as_tensor(-Rci @ skew_pic, **f32)
        self.vmap = self._fresh_vmap()
        self.fid = 0  # camera frames seen
        self.steps = 0  # camera frames that ran vio_frame_step
        self.last_cloud: Optional[np.ndarray] = None
        self._last_cloud_dev = None  # (device (rows, 3) cloud, host n)
        self.max_pg = cap.max_cands
        self.cloud_cap = cap.max_raw_points
        self.last_stats = {}
        # thresholds as device scalars of the JAX package's dtypes
        self._out_thre_dev = torch.tensor(cfg.outlier_threshold, **f32)
        self._ncc_thre_dev = torch.tensor(cfg.ncc_thre, **f32)
        self._ipc_dev = torch.tensor(float(cfg.img_point_cov), dtype=F64, device=dev)
        # host copy of the point-pool occupancy (stats[28]); None until a
        # frame's stats resolve or after a compaction
        self._n_pts_host: Optional[int] = None
        self.last_rcw: Optional[np.ndarray] = None  # frame T_f_w_ rotation
        self.last_pcw: Optional[np.ndarray] = None
        self.last_overlay: Optional[np.ndarray] = None  # /rgb_img under cfg.debug
        # img_rgb (detect :1035), resized lazily from a snapshot of the raw
        # frame: only colorize and visualization read it
        self._last_bgr_cache: Optional[np.ndarray] = None
        self._last_bgr_src: Optional[np.ndarray] = None
        # deferred stats reads (set through Pipeline.async_read) and the
        # block collector (replay.BlockReadCollector)
        self.async_read = False
        self.async_depth = 1
        self._pending: list = []
        self.read_collector = None

    def _fresh_vmap(self) -> vmap_mod.VisualMap:
        """A new empty visual map at the configured capacities; with
        `pool_sharded` only this rank's slabs of it."""
        cap, cfg = self.cfg.capacity, self.cfg
        return vmap_mod.empty_visual_map(
            n_points=cap.vmap_points, n_obs=cap.vmap_obs,
            table_size=cap.vmap_table_size, voxel_cap=cap.vmap_voxel_cap,
            ring=cap.frame_ring, height=cfg.camera.height,
            width=cfg.camera.width,
            img_dtype=torch.uint8 if cap.frame_ring_u8 else None,
            device=self.device, slabs=self.mesh.size if self.pool_sharded else 1)

    def whole_vmap(self) -> vmap_mod.VisualMap:
        """The whole visual map: with `pool_sharded` gathered from the
        slabs (a collective: every rank calls it at the same point)."""
        if self.pool_sharded:
            return vmap_mod.gather_slabs(self.vmap, self.mesh)
        return self.vmap

    def reset_map(self):
        """Discard the visual map (divergence-watchdog restart). The
        frame-id counter is kept, so fids stay monotone."""
        self.vmap = self._fresh_vmap()
        self._n_pts_host = None
        self.last_stats = {}

    @property
    def last_bgr(self) -> Optional[np.ndarray]:
        if self._last_bgr_cache is None and self._last_bgr_src is not None:
            self._last_bgr_cache = self._resize_color(self._last_bgr_src)
        return self._last_bgr_cache

    @last_bgr.setter
    def last_bgr(self, v: Optional[np.ndarray]):
        self._last_bgr_cache = v
        self._last_bgr_src = None

    def set_last_cloud(self, pts_world: Optional[np.ndarray]):
        if pts_world is not None:
            self.last_cloud = pts_world
            self._last_cloud_dev = None

    def set_last_cloud_device(self, dense_dev: torch.Tensor, n: int):
        """The lidar frame's dense world cloud stays on the device; only
        the valid-row count is host-side. Rows >= n are masked in the
        frame step."""
        assert dense_dev.shape[0] <= self.cloud_cap, (dense_dev.shape, self.cloud_cap)
        self._last_cloud_dev = (dense_dev, int(n))
        self.last_cloud = None

    def _to_gray(self, img: np.ndarray) -> np.ndarray:
        if img.ndim == 3:  # BGR -> gray (detect :1037)
            img = 0.114 * img[..., 0] + 0.587 * img[..., 1] + 0.299 * img[..., 2]
        img = np.asarray(img, np.float32)
        H, W = self.cam.height, self.cam.width
        if img.shape != (H, W):  # resize (detect :1029-1034)
            if img.shape == (2 * H, 2 * W):
                # cv::resize INTER_LINEAR at 0.5: the 2x2 block average
                img = img.reshape(H, 2, W, 2).mean(axis=(1, 3))
            else:
                img = _bilinear_resize(img, H, W)
        return img

    def _gray_device(self, img: np.ndarray) -> torch.Tensor:
        """Device-resident f32 gray frame. Integer frames at the camera
        model's size upload as they are and convert on the device, with
        the numpy path's operation order; float or resized frames take
        the host path."""
        H, W = self.cam.height, self.cam.width
        dev = self.device
        if (img.ndim == 3 and img.shape[:2] == (H, W)
                and np.issubdtype(img.dtype, np.integer)):
            return _to_gray_dev(torch.as_tensor(img, device=dev))
        if (img.ndim == 2 and img.shape == (H, W)
                and np.issubdtype(img.dtype, np.integer)
                and img.dtype.itemsize <= 2):
            # u8/u16 -> f32 is exact
            return torch.as_tensor(img, device=dev).to(torch.float32)
        return torch.as_tensor(self._to_gray(img), device=dev)

    def _resize_color(self, img: np.ndarray) -> np.ndarray:
        """img_rgb: the color frame at the camera model's size (the
        reference resizes before cloning it, detect :1029-1035), f32."""
        img = np.asarray(img, np.float32)
        H, W = self.cam.height, self.cam.width
        if img.shape[:2] == (H, W):
            return img
        if img.shape[:2] == (2 * H, 2 * W):
            if img.ndim == 3:
                return img.reshape(H, 2, W, 2, -1).mean(axis=(1, 3))
            return img.reshape(H, 2, W, 2).mean(axis=(1, 3))
        if img.ndim == 3:
            return np.stack([_bilinear_resize(img[..., c], H, W)
                             for c in range(img.shape[2])], axis=-1)
        return _bilinear_resize(img, H, W)

    def update(self, state: NavState, prior: NavState, img: np.ndarray) -> NavState:
        """The `detect` entry (lidar_selection.cpp:1027-1075): one
        `vio_frame_step` and one read of its stats row."""
        cfg = self.cfg
        # the caller may reuse its frame buffer before colorize reads it
        self._last_bgr_src = np.array(img, copy=True)
        self._last_bgr_cache = None
        gray = self._gray_device(img)
        R = self.cloud_cap
        if self._last_cloud_dev is not None:
            cloud_dev, n = self._last_cloud_dev
            n = min(n, R)
        else:
            cloud_dev = None
            n = 0 if self.last_cloud is None else min(len(self.last_cloud), R)
        if n < 10:
            self.vmap = vmap_mod.push_image(self.vmap, gray, self.fid, self.slab_mesh)
            self.fid += 1
            return state
        if cloud_dev is None:
            cloud = np.zeros((R, 3), np.float32)
            cloud[:n] = self.last_cloud[:n, :3]
            cloud_dev = torch.as_tensor(cloud, device=self.device)
        meta = torch.tensor([n, self.fid], dtype=I32, device=self.device)
        step = vio_frame_step if self.mesh_runner is None else self.mesh_runner.vio_frame_step
        (st, vm2, _tidx, tvalid, opc, perr, _err, _n_tracked, _n_added,
         _its, stats_j) = step(
            self.vmap, self.cam, state, prior, gray, meta, cloud_dev,
            self.Rci, self.Pci, self.Jdphi_dR, self.Jdp_dR,
            self._out_thre_dev, self._ncc_thre_dev, self._ipc_dev,
            grid_size=self.grid_size, patch_size=self.patch_size,
            gw=self.gw, gh=self.gh, ncc_en=cfg.ncc_en,
            max_iter=cfg.max_iteration, max_pg=self.max_pg,
            robust=cfg.capacity.vio_robust)
        self.vmap = vm2
        self.fid += 1
        self.steps += 1
        # debug keeps the read synchronous: the overlay needs this frame's stats
        if self.read_collector is not None and not cfg.debug:
            self.read_collector.add_cam(stats_j)
            return st
        if self.async_read and not cfg.debug:
            self._pending.append(DeferredRead(stats_j))
            while len(self._pending) > self.async_depth:
                self._apply_stats(self._pending.pop(0).result())
            return st
        with record_function("vio.stats_read"):
            stats = stats_j.cpu().numpy()
        self._apply_stats(stats)
        if cfg.debug and stats[0] > 0 and self.lead:
            self.last_overlay = render_overlay(
                gray.cpu().numpy(), opc.cpu().numpy(), perr.cpu().numpy(),
                tvalid.cpu().numpy())
        return st

    def resolve_pending(self):
        """Apply every deferred camera-frame stats row."""
        while self._pending:
            self._apply_stats(self._pending.pop(0).result())

    def _apply_stats(self, stats: np.ndarray):
        self.last_stats = {"tracked": int(stats[0]), "added": int(stats[1]),
                           "err": float(stats[2])}
        self.last_rcw = stats[4:13].reshape(3, 3).astype(np.float32)
        self.last_pcw = stats[13:16].astype(np.float32)
        self._n_pts_host = int(stats[28])

    def update_staged(self, state: NavState, prior: NavState, img: np.ndarray) -> NavState:
        """The camera frame one stage at a time, as the JAX package's
        unfused reference path: for the fused-vs-staged equivalence test
        and for debugging. It reads the host cloud (`set_last_cloud`), and
        its 0.2 m voxel filter divides by the leaf (a device tensor), as
        the JAX package's call from outside jit does; its photometric
        iterations go through `photometric_update` level by level (2, 1,
        0), with the default robust mode. The stats are read at once.

        Under a mesh every rank runs the single-device stages on its
        replicated inputs; with `pool_sharded` the slabs are gathered into
        the whole map first and cut again after (collectives)."""
        if not self.pool_sharded:
            return self._update_staged(state, prior, img)
        self.vmap = self.whole_vmap()
        try:
            return self._update_staged(state, prior, img)
        finally:
            self.vmap = vmap_mod.shard_slabs(self.vmap, self.mesh.rank, self.mesh.size)

    def _update_staged(self, state: NavState, prior: NavState, img: np.ndarray) -> NavState:
        cfg = self.cfg
        dev = self.device
        self._last_bgr_src = np.array(img, copy=True)
        self._last_bgr_cache = None
        gray = torch.as_tensor(self._to_gray(img), device=dev)
        fid = self.fid
        self.vmap = vmap_mod.push_image(self.vmap, gray, fid)

        Rci, Pci = self.Rci.cpu().numpy(), self.Pci.cpu().numpy()

        def cam_pose(st):  # world -> camera of a state, f32 on the host
            rcw = Rci @ st.rot.cpu().numpy().astype(np.float32).T
            return rcw, -rcw @ st.pos.cpu().numpy().astype(np.float32) + Pci

        rcw_j, pcw_j = (torch.as_tensor(a, device=dev) for a in cam_pose(state))

        if self.last_cloud is None or len(self.last_cloud) < 10:
            self.fid += 1
            return state

        R = self.cloud_cap
        n = min(len(self.last_cloud), R)
        cloud = np.zeros((R, 3), np.float32)
        cloud[:n] = self.last_cloud[:n, :3]
        cloud_j = torch.as_tensor(cloud, device=dev)
        pg, pg_mask = voxel_downsample_device(
            cloud_j, torch.arange(R, device=dev) < n, _const(VIO_LEAF, cloud_j),
            self.max_pg)
        vox, vox_mask = _dedup_voxels(pg, pg_mask, self.max_pg // 2)

        stats = {"tracked": 0, "added": 0, "err": 0.0}
        tracked = None
        if int(self.vmap.n_pts) > 0:
            tracked = select_tracked(
                self.vmap, self.cam, rcw_j, pcw_j, gray, pg, pg_mask, vox, vox_mask,
                cfg.outlier_threshold, cfg.ncc_thre, grid_size=self.grid_size,
                patch_size=self.patch_size, gw=self.gw, gh=self.gh, ncc_en=cfg.ncc_en)
            stats["tracked"] = int(tracked.valid.sum())
            cell_value = tracked.cell_value
        else:
            cell_value = torch.zeros(self.gw * self.gh, dtype=torch.float32, device=dev)

        # addSparseMap with the prior pose (:1054 runs before ComputeJ)
        npos, npx, nscore, nadd = select_new_points(
            self.cam, rcw_j, pcw_j, gray, pg, pg_mask, cell_value,
            grid_size=self.grid_size, patch_size=self.patch_size, gw=self.gw, gh=self.gh)

        if tracked is not None and stats["tracked"] > 0:
            # the iterated photometric EKF, coarse to fine (:967-983)
            for level in (2, 1, 0):
                state, Gmat, perr, err, _its = photometric_update(
                    state, prior, self.cam, gray, tracked.pos, tracked.patch,
                    tracked.search_level, tracked.valid, self.Rci, self.Pci,
                    self.Jdphi_dR, self.Jdp_dR, cfg.img_point_cov, self.patch_size,
                    level=level, max_iter=cfg.max_iteration)
            stats["err"] = float(err)
            state = state._replace(cov=state.cov - Gmat @ state.cov[0:6, :])  # :980

            # addObservation with the posterior pose (:1064)
            rcw2_j, pcw2_j = (torch.as_tensor(a, device=dev) for a in cam_pose(state))
            opc, oscore, oadd = prep_observations(self.vmap, self.cam, rcw2_j, pcw2_j,
                                                  gray, tracked.idx, tracked.valid)
            self.vmap = vmap_mod.add_observations(
                self.vmap, tracked.idx, opc, rcw2_j, pcw2_j, oscore, fid,
                tracked.search_level, oadd)
            if cfg.debug and self.lead:
                self.last_overlay = render_overlay(
                    gray.cpu().numpy(), opc.cpu().numpy(), perr.cpu().numpy(),
                    tracked.valid.cpu().numpy())

        # new points carry the prior-pose first observation (:178-190)
        self.vmap = vmap_mod.add_points(self.vmap, npos, npx, rcw_j, pcw_j, nscore,
                                        fid, nadd)
        stats["added"] = int(nadd.sum())
        self.last_stats = stats
        self.last_rcw, self.last_pcw = cam_pose(state)  # updateFrameState, :982
        self.fid += 1
        return state

    def colorize(self, pts_world: np.ndarray):
        """Paint world points from the most recent camera image
        (publish_frame_world's RGB path, laserMapping.cpp:726-746): project
        with the last applied frame pose (f32, host), world2cam on this
        Vio's device, bilinear sample of the color image (f64, host).
        Returns (mask, rgb) with rgb rows in [0, 255], r, g, b order."""
        if self.last_bgr is None or self.last_rcw is None:
            return np.zeros(len(pts_world), bool), np.zeros((len(pts_world), 3))
        pc_cam = pts_world.astype(np.float32) @ self.last_rcw.T + self.last_pcw
        mask = pc_cam[:, 2] > 0
        px = cam_mod.world2cam(self.cam, torch.as_tensor(pc_cam, device=self.device))
        px = px.cpu().numpy().astype(np.float64)
        H, W = self.last_bgr.shape[:2]
        mask &= (px[:, 0] >= 0) & (px[:, 0] < W - 1)
        mask &= (px[:, 1] >= 0) & (px[:, 1] < H - 1)
        x = np.clip(px[:, 0], 0, W - 2)
        y = np.clip(px[:, 1], 0, H - 2)
        x0, y0 = x.astype(np.int64), y.astype(np.int64)
        fx, fy = (x - x0)[:, None], (y - y0)[:, None]
        img = self.last_bgr.astype(np.float32)
        if img.ndim == 2:
            img = img[..., None].repeat(3, axis=2)
        bgr = (img[y0, x0] * (1 - fx) * (1 - fy)
               + img[y0, x0 + 1] * fx * (1 - fy)
               + img[y0 + 1, x0] * (1 - fx) * fy
               + img[y0 + 1, x0 + 1] * fx * fy)
        return mask, bgr[:, ::-1]  # BGR -> RGB (getpixel rows, :741-743)
