"""Fused 5-NN selection + TLS plane fit for the LIO search leg.

`knn5_plane` is the port of the TPU kernel `knn5_plane`
(fastlivo_tpu/ops/pallas_lio.py, `pl.pallas_call` at line 219), with its
signature: a candidate block in, planes out. On a CUDA tensor it
launches the hand-written kernel in csrc/knn5_plane.cu (built at first
use, see _build.py); on a CPU tensor it runs `knn5_plane_plain`, the same
arithmetic in torch ops, which is also the kernel's oracle on the card.
The host loop `lio.lio_loop` calls it under `cache_knn` (`lio.host_search`:
a mesh), on the block gathered once per frame; on one card the LIO cascade
writes that block at its first search and re-ranks it itself
(csrc/knn5_cached_walk.cuh), and this kernel is its oracle.

`knn5_plane_tiled` and `knn5_plane_hashed` are the LIO search itself in
one launch: the map's neighbourhood gather (tiled_map.knn_candidates,
voxel_map.knn_candidates on the hash map, dense_map.knn_candidates on
the dense grid) fused into the selection and fit, so the candidate block
is never written (csrc/knn5_plane_tiled.cu, csrc/knn5_plane_hashed.cu).
Their plain versions are the compositions `knn5_plane_tiled_plain` and
`knn5_plane_hashed_plain`; the kernels are bit-exact against them on the
card. `knn5_plane_search` picks one by the map's type; `lio.lio_update`
calls it on every search without a cache.

Contract of `knn5_plane` against the Pallas kernel (the JAX package's
tests/test_pallas_lio.py): identical selection for distinct distances
(ties to the lowest candidate row), nd2 at rtol 1e-5, planes at rtol
5e-3 / atol 5e-4 up to sign where both gates pass, gate mismatches under
1%.
"""
from __future__ import annotations

import ctypes
import functools
import numbers

import torch

from . import dense_map as dm
from . import tiled_map as tm
from . import voxel_map as vm

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
    if M < 1 or N * M * 3 >= 1 << 62:
        raise ValueError(f"knn5_plane: M={M}; the kernel takes one candidate or more")
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
    if N > 0:
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


def _check_map_inputs(name: str, queries: torch.Tensor, want):
    """Each (tensor, shape or None, dtype) of `want` has that shape and
    dtype and is contiguous on the queries' device."""
    for t, shape, dtype in want:
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: map shape {tuple(t.shape)}, want {tuple(shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
        if t.device != queries.device:
            raise ValueError(f"{name}: inputs on different devices")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def check_radius(name: str, radius) -> int:
    """The kernels' neighbourhoods: any radius r >= 0 that the plain
    version takes, M = (2r+1)^3 candidates (27 and 125 the walks'
    templated forms, any other M their generic form). Returns M; raises
    ValueError for a negative or non-integer radius, or one whose block
    rows outgrow an int32 index."""
    if isinstance(radius, bool) or not isinstance(radius, numbers.Integral) or radius < 0:
        raise ValueError(f"{name}: radius {radius!r}; the kernels take an int >= 0")
    M = (2 * int(radius) + 1) ** 3
    if 3 * M >= 1 << 31:
        raise ValueError(f"{name}: radius {radius}: {M} candidates a query")
    return M


def _check_tiled(m: tm.TiledMap, queries: torch.Tensor, radius: int):
    if queries.ndim != 2 or queries.shape[1] != 3:
        raise ValueError(f"knn5_plane_tiled: queries {tuple(queries.shape)}")
    check_radius("knn5_plane_tiled", radius)
    C = m.cell_check.shape[0]
    _check_map_inputs("knn5_plane_tiled", queries, [
        (queries, None, torch.float32), (m.dir_check, None, torch.int32),
        (m.dir_slot, m.dir_check.shape, torch.int32), (m.cell_check, (C,), torch.int32),
        (m.pts, (C, 3), torch.float32), (m.voxel_size, (), torch.float32),
        (m.log2_dims, (3,), torch.int32)])
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


def _hashed_module(m):
    """The backend module of a hash or dense map, and the kernel's
    backend code (0 hash, 1 dense)."""
    if isinstance(m, vm.VoxelMap):
        return vm, 0
    if isinstance(m, dm.DenseMap):
        return dm, 1
    raise TypeError(f"knn5_plane_hashed: not a hash or dense map: {type(m).__name__}")


def knn5_plane_hashed_plain(m, queries: torch.Tensor, radius: int = 1,
                            threshold: float = 0.1, max_probe: int = 12):
    """The unfused search on the hash map (voxel_map.VoxelMap, `max_probe`
    slots per voxel) or the dense grid (dense_map.DenseMap, `max_probe`
    ignored): `knn5_plane_plain` on the backend's candidate block around
    each query (N, 3) f32, M = (2r+1)^3 voxels. Returns (pabcd (N, 4),
    plane_ok (N,), nd2_5 (N,))."""
    mod, _ = _hashed_module(m)
    return knn5_plane_plain(*mod.knn_candidates(m, queries, radius, max_probe),
                            queries, threshold)


def _check_hashed(m, queries: torch.Tensor, radius: int, max_probe: int):
    _, backend = _hashed_module(m)
    if queries.ndim != 2 or queries.shape[1] != 3:
        raise ValueError(f"knn5_plane_hashed: queries {tuple(queries.shape)}")
    check_radius("knn5_plane_hashed", radius)
    if backend == 0 and not 0 <= max_probe < 1 << 31:
        raise ValueError(f"knn5_plane_hashed: max_probe {max_probe}")
    T = m.check.shape[0]
    want = [(queries, None, torch.float32), (m.check, (T,), torch.int32),
            (m.pts, (T, 3), torch.float32), (m.voxel_size, (), torch.float32)]
    if backend == 1:
        want.append((m.log2_dims, (3,), torch.int32))
    _check_map_inputs("knn5_plane_hashed", queries, want)
    if T & (T - 1) or not 0 < T < 1 << 31 or queries.shape[0] >= 1 << 26:
        raise ValueError("knn5_plane_hashed: the table must have a power-of-two "
                         "size below 2^31 and the queries be fewer than 2^26")


@functools.cache
def _hashed_launcher():
    from . import _build

    fn = _build.load("knn5_plane_hashed").knn5_plane_hashed_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return _build.profiled("knn5_plane_hashed", fn)


def knn5_plane_hashed(m, queries: torch.Tensor, radius: int = 1,
                      threshold: float = 0.1, max_probe: int = 12):
    """The LIO search on the hash map or the dense grid: same signature and
    outputs as `knn5_plane_hashed_plain`. A CUDA tensor launches the fused
    kernel on the current stream (counted in `knn5_plane_hashed.launches`);
    a CPU tensor runs the plain composition. No other device is taken and
    nothing falls back."""
    if queries.device.type == "cpu":
        return knn5_plane_hashed_plain(m, queries, radius, threshold, max_probe)
    if queries.device.type != "cuda":
        raise ValueError(f"knn5_plane_hashed: unsupported device {queries.device}")
    _check_hashed(m, queries, radius, max_probe)
    _, backend = _hashed_module(m)
    N, dev = queries.shape[0], queries.device
    offs = vm.neighbor_offsets(radius, dev)
    pabcd = torch.empty((N, 4), dtype=torch.float32, device=dev)
    plane_ok = torch.empty(N, dtype=torch.bool, device=dev)
    nd2_5 = torch.empty(N, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _hashed_launcher()(
        queries.data_ptr(), m.check.data_ptr(), m.pts.data_ptr(),
        m.voxel_size.data_ptr(), m.log2_dims.data_ptr() if backend else None,
        offs.data_ptr(), pabcd.data_ptr(), plane_ok.data_ptr(), nd2_5.data_ptr(),
        N, offs.shape[0], m.check.shape[0], backend, int(max_probe),
        float(threshold), stream)
    if err != 0:
        raise RuntimeError(f"knn5_plane_hashed: kernel launch failed (cudaError {err})")
    if N > 0:
        knn5_plane_hashed.launches += 1
    return pabcd, plane_ok, nd2_5


knn5_plane_hashed.launches = 0


def knn5_plane_search(m, queries: torch.Tensor, radius: int = 1,
                      threshold: float = 0.1, max_probe: int = 12):
    """The LIO search on any map in one launch: `knn5_plane_tiled` on the
    tiled map, `knn5_plane_hashed` on the hash map or the dense grid
    (`max_probe` is the hash map's)."""
    if isinstance(m, tm.TiledMap):
        return knn5_plane_tiled(m, queries, radius, threshold)
    return knn5_plane_hashed(m, queries, radius, threshold, max_probe)
