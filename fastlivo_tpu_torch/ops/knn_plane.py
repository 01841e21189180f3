"""Fused 5-NN selection + TLS plane fit for the LIO search leg.

`knn5_plane` is the port of the TPU kernel `knn5_plane`
(fastlivo_tpu/ops/pallas_lio.py, `pl.pallas_call` at line 219), with its
signature: a candidate block in, planes out. On a CUDA tensor it
launches the hand-written kernel in csrc/knn5_plane.cu (built at first
use, see _build.py); on a CPU tensor it runs `knn5_plane_plain`, the same
arithmetic in torch ops, which is also the kernel's oracle on the card.

`knn5_plane_tiled` is the LIO search itself in one launch
(csrc/knn5_plane_tiled.cu): the tiled map's neighbourhood gather
(tiled_map.knn_candidates) fused into the selection and fit, so the
candidate block is never written. Its plain version is the composition
`knn5_plane_tiled_plain`; the kernel is bit-exact against it on the card.
`lio.lio_update` calls it on every search.

Contract of `knn5_plane` against the Pallas kernel (the JAX package's
tests/test_pallas_lio.py): identical selection for distinct distances
(ties to the lowest candidate row), nd2 at rtol 1e-5, planes at rtol
5e-3 / atol 5e-4 up to sign where both gates pass, gate mismatches under
1%.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import tiled_map as tm

BIG = 3.0e37  # masked squared distance (float32-representable)


def knn5_plane_plain(cand: torch.Tensor, found: torch.Tensor,
                     queries: torch.Tensor, threshold: float = 0.1):
    """The kernel's arithmetic in torch ops. cand (N, M, 3) f32, found
    (N, M) bool, queries (N, 3) f32 -> (pabcd (N, 4) f32, plane_ok (N,)
    bool, nd2_5 (N,) f32: the fifth-nearest squared distance)."""
    N, M = found.shape
    dev = cand.device
    diff = cand - queries[:, None, :]
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
          + diff[..., 2] * diff[..., 2])
    bigc = torch.full_like(d2, BIG)
    d2 = torch.where(found, d2, bigc)
    rowid = torch.arange(M, device=dev)
    rows = torch.arange(N, device=dev)
    nx, ny, nz = [], [], []
    dmin = None
    for _ in range(5):
        # min, then the lowest row holding it (not torch.topk: it
        # promises no tie order on CUDA)
        dmin = d2.min(dim=1).values
        pick = torch.where(d2 == dmin[:, None], rowid, M).min(dim=1).values
        v = (dmin < BIG * 0.5).to(cand.dtype)
        sel = cand[rows, pick]  # (N, 3)
        nx.append(sel[:, 0] * v)
        ny.append(sel[:, 1] * v)
        nz.append(sel[:, 2] * v)
        d2 = torch.where(rowid == pick[:, None], bigc, d2)

    # centred TLS plane: all five picks count, missing ones as zeros
    cxm = (nx[0] + nx[1] + nx[2] + nx[3] + nx[4]) * 0.2
    cym = (ny[0] + ny[1] + ny[2] + ny[3] + ny[4]) * 0.2
    czm = (nz[0] + nz[1] + nz[2] + nz[3] + nz[4]) * 0.2
    s00 = s01 = s02 = s11 = s12 = s22 = torch.zeros_like(cxm)
    for k in range(5):
        ex, ey, ez = nx[k] - cxm, ny[k] - cym, nz[k] - czm
        s00 = s00 + ex * ex
        s01 = s01 + ex * ey
        s02 = s02 + ex * ez
        s11 = s11 + ey * ey
        s12 = s12 + ey * ez
        s22 = s22 + ez * ez

    # smallest eigenvector of the symmetric 3x3 scatter
    q = (s00 + s11 + s22) * (1.0 / 3.0)
    b00, b11, b22 = s00 - q, s11 - q, s22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (s01 * s01 + s02 * s02 + s12 * s12))
    p = torch.sqrt(torch.clamp(p2 * (1.0 / 6.0), min=1e-30))
    detB = (b00 * (b11 * b22 - s12 * s12)
            - s01 * (s01 * b22 - s12 * s02)
            + s02 * (s01 * s12 - b11 * s02)) / (p * p * p)
    r = torch.clamp(detB * 0.5, -1.0, 1.0)
    phi = torch.arccos(r) * (1.0 / 3.0)
    lam = q + 2.0 * p * torch.cos(phi + 2.0943951)  # 2*pi/3

    r0 = (s00 - lam, s01, s02)
    r1 = (s01, s11 - lam, s12)
    r2 = (s02, s12, s22 - lam)

    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    def sq(c):
        return c[0] * c[0] + c[1] * c[1] + c[2] * c[2]

    c01, c02, c12 = cross(r0, r1), cross(r0, r2), cross(r1, r2)
    n01, n02, n12 = sq(c01), sq(c02), sq(c12)
    use01 = (n01 >= n02) & (n01 >= n12)
    use02 = ~use01 & (n02 >= n12)
    b = [torch.where(use01, c01[j], torch.where(use02, c02[j], c12[j]))
         for j in range(3)]
    bn = torch.sqrt(sq(b))
    okn = bn > 1e-20
    inv = 1.0 / torch.where(okn, bn, torch.ones_like(bn))
    zero, one = torch.zeros_like(bn), torch.ones_like(bn)
    ux = torch.where(okn, b[0] * inv, zero)
    uy = torch.where(okn, b[1] * inv, zero)
    uz = torch.where(okn, b[2] * inv, one)  # degenerate fallback +z
    d = -(ux * cxm + uy * cym + uz * czm)

    ok = okn
    for k in range(5):
        dist = torch.abs(nx[k] * ux + ny[k] * uy + nz[k] * uz + d)
        ok = ok & (dist <= threshold)
    return torch.stack([ux, uy, uz, d], dim=1), ok, dmin


def _check(cand, found, queries):
    N, M = found.shape
    if cand.shape != (N, M, 3) or queries.shape != (N, 3):
        raise ValueError(f"knn5_plane: shapes cand {tuple(cand.shape)}, "
                         f"found {tuple(found.shape)}, queries "
                         f"{tuple(queries.shape)}")
    if cand.dtype != torch.float32 or queries.dtype != torch.float32:
        raise TypeError("knn5_plane: cand and queries must be float32")
    if found.dtype != torch.bool:
        raise TypeError("knn5_plane: found must be bool")
    if M not in (27, 125):
        raise ValueError(f"knn5_plane: M={M}; the kernel takes 27 or 125 "
                         "candidates (knn radius 1 or 2)")
    for t in (cand, found, queries):
        if t.device != cand.device:
            raise ValueError("knn5_plane: inputs on different devices")
        if not t.is_contiguous():
            raise ValueError("knn5_plane: inputs must be contiguous")
    if N >= 1 << 31:
        raise ValueError("knn5_plane: too many queries")


@functools.cache
def _launcher():
    from . import _build

    fn = _build.load("knn5_plane").knn5_plane_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return _build.profiled("knn5_plane", fn)


def knn5_plane(cand: torch.Tensor, found: torch.Tensor,
               queries: torch.Tensor, threshold: float = 0.1):
    """Fused top-5 + plane fit: same signature and outputs as
    `knn5_plane_plain`. A CUDA tensor launches the kernel on the current
    stream (counted in `knn5_plane.launches`); a CPU tensor runs the
    plain version. No other device is taken and nothing falls back."""
    if cand.device.type == "cpu":
        return knn5_plane_plain(cand, found, queries, threshold)
    if cand.device.type != "cuda":
        raise ValueError(f"knn5_plane: unsupported device {cand.device}")
    _check(cand, found, queries)
    N, M = found.shape
    pabcd = torch.empty((N, 4), dtype=torch.float32, device=cand.device)
    plane_ok = torch.empty(N, dtype=torch.bool, device=cand.device)
    nd2_5 = torch.empty(N, dtype=torch.float32, device=cand.device)
    launch = _launcher()
    stream = torch.cuda.current_stream(cand.device).cuda_stream
    err = launch(cand.data_ptr(), found.data_ptr(), queries.data_ptr(),
                 pabcd.data_ptr(), plane_ok.data_ptr(), nd2_5.data_ptr(),
                 N, M, float(threshold), stream)
    if err != 0:
        raise RuntimeError(f"knn5_plane: kernel launch failed (cudaError {err})")
    knn5_plane.launches += 1
    return pabcd, plane_ok, nd2_5


knn5_plane.launches = 0


def knn5_plane_tiled_plain(m: tm.TiledMap, queries: torch.Tensor, radius: int = 1,
                           threshold: float = 0.1):
    """The unfused search: `knn5_plane_plain` on the tiled map's
    candidate block around each query (N, 3) f32, M = (2r+1)^3 voxels.
    Returns (pabcd (N, 4), plane_ok (N,), nd2_5 (N,))."""
    cand, found = tm.knn_candidates(m, queries, radius)
    return knn5_plane_plain(cand, found, queries, threshold)


def _check_tiled(m: tm.TiledMap, queries: torch.Tensor, radius: int):
    if queries.ndim != 2 or queries.shape[1] != 3:
        raise ValueError(f"knn5_plane_tiled: queries {tuple(queries.shape)}")
    if radius not in (1, 2):
        raise ValueError(f"knn5_plane_tiled: radius {radius}; the kernel takes "
                         "1 or 2 (27 or 125 candidates)")
    C = m.cell_check.shape[0]
    want = [(queries, None, torch.float32), (m.dir_check, None, torch.int32),
            (m.dir_slot, m.dir_check.shape, torch.int32),
            (m.cell_check, (C,), torch.int32), (m.pts, (C, 3), torch.float32),
            (m.voxel_size, (), torch.float32), (m.log2_dims, (3,), torch.int32)]
    for t, shape, dtype in want:
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"knn5_plane_tiled: map shape {tuple(t.shape)}, want "
                             f"{tuple(shape)}")
        if t.dtype != dtype:
            raise TypeError(f"knn5_plane_tiled: dtype {t.dtype}, want {dtype}")
        if t.device != queries.device:
            raise ValueError("knn5_plane_tiled: inputs on different devices")
        if not t.is_contiguous():
            raise ValueError("knn5_plane_tiled: inputs must be contiguous")
    if queries.shape[0] >= 1 << 26 or C != m.slot_key.shape[0] * tm.TC or C >= 1 << 31:
        raise ValueError("knn5_plane_tiled: too many queries or pool cells")


@functools.cache
def _tiled_launcher():
    from . import _build

    fn = _build.load("knn5_plane_tiled").knn5_plane_tiled_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return _build.profiled("knn5_plane_tiled", fn)


def knn5_plane_tiled(m: tm.TiledMap, queries: torch.Tensor, radius: int = 1,
                     threshold: float = 0.1):
    """The LIO search: same signature and outputs as
    `knn5_plane_tiled_plain`. A CUDA tensor launches the fused kernel on
    the current stream (counted in `knn5_plane_tiled.launches`); a CPU
    tensor runs the plain composition. No other device is taken and
    nothing falls back."""
    if queries.device.type == "cpu":
        return knn5_plane_tiled_plain(m, queries, radius, threshold)
    if queries.device.type != "cuda":
        raise ValueError(f"knn5_plane_tiled: unsupported device {queries.device}")
    _check_tiled(m, queries, radius)
    N, dev = queries.shape[0], queries.device
    offs = tm.neighbor_offsets(radius, dev)
    pabcd = torch.empty((N, 4), dtype=torch.float32, device=dev)
    plane_ok = torch.empty(N, dtype=torch.bool, device=dev)
    nd2_5 = torch.empty(N, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _tiled_launcher()(
        queries.data_ptr(), m.dir_check.data_ptr(), m.dir_slot.data_ptr(),
        m.cell_check.data_ptr(), m.pts.data_ptr(), m.voxel_size.data_ptr(),
        m.log2_dims.data_ptr(), offs.data_ptr(), pabcd.data_ptr(),
        plane_ok.data_ptr(), nd2_5.data_ptr(), N, offs.shape[0],
        m.slot_key.shape[0], float(threshold), stream)
    if err != 0:
        raise RuntimeError(f"knn5_plane_tiled: kernel launch failed (cudaError {err})")
    if N > 0:
        knn5_plane_tiled.launches += 1
    return pabcd, plane_ok, nd2_5


knn5_plane_tiled.launches = 0
