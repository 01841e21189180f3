"""The LIO iterated EKF of one scan in one launch, on the tiled map.

`lio_cascade` is the JAX package's `jax.lax.while_loop` of
`lio.lio_update` (fastlivo_tpu/lio.py:256), whose search runs the TPU
kernel `knn5_plane` (fastlivo_tpu/ops/pallas_lio.py, `pl.pallas_call` at
line 219), as one cooperative launch of csrc/lio_cascade.cu: every
iteration's search (the walk of csrc/knn5_tiled_walk.cuh, which
knn5_plane_tiled.cu runs alone), gates, H rows, [HᵀH₆ | Hᵀz] and f64 step
on the card, with no host read and no launch between iterations. It
takes CUDA tensors only. Its plain version is the host loop
`lio.lio_loop` (one `knn5_plane_tiled` search per search iteration, the
gates and rows in torch ops, `fixed_order_sum` and one
`photometric_step` per iteration, one flag read), which the CPU runs.
Contract on the card against that loop: with the step kernel every output
bit-equal (rot, x, G, sel, pabcd, plane_ok, iterations), its search
`knn5_plane_tiled` or `knn5_plane_tiled_plain`; all plain (that search
and `photometric_step_plain`), equal iterations and the pose within 1e-9.

`fixed_order_sum` is the order in which both sum the per-row products of
[HᵀH₆ | Hᵀz]: a halving tree over each chunk of CHUNK rows (the kernel's
chunk of a block), then over each group of CHUNK chunk sums, and so on,
zeros past the end. No float atomics: the same bits on every launch and
any grid.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import tiled_map as tm
from .knn_plane import _check_tiled
from .photometric import _check_step, _require

CHUNK = 64  # rows of a chunk, and chunk sums of a group (csrc/lio_cascade.cu: CH)
F32, F64 = torch.float32, torch.float64


def fixed_order_sum(rows: torch.Tensor) -> torch.Tensor:
    """(n, K) -> (K,): the rows summed in the cascade kernel's order. Each
    chunk of CHUNK rows (the last padded with zeros) is summed by a halving
    tree (row i + row i + 32, then i + 16, ..., i + 1); while more than one
    sum is left, the sums are grouped by CHUNK and summed the same way.
    Zero rows give zeros."""
    x = rows
    if x.shape[0] == 0:
        return rows.new_zeros(rows.shape[1])
    while True:
        n, K = x.shape
        g = -(-n // CHUNK)
        if g * CHUNK != n:
            x = torch.cat([x, x.new_zeros((g * CHUNK - n, K))])
        x = x.view(g, CHUNK, K)
        s = CHUNK // 2
        while s:
            x = x[:, :s] + x[:, s:2 * s]
            s //= 2
        x = x[:, 0]
        if g == 1:
            return x[0]


def _round4(k: int) -> int:
    return -(-max(k, 1) // 4) * 4


def scratch_shapes(n: int) -> tuple:
    """The kernel's sum scratch for n points: the chunk sums (2, 42,
    stride) and the group sums (2, 42, gstride), one half per iteration
    parity, a column per quantity; stride and gstride the chunks and the
    groups of CHUNK chunks (at least 1) rounded up to 4 (16-byte columns,
    copied into shared memory 16 bytes at a time); and the group tickets
    (groups,)."""
    nch = -(-n // CHUNK)
    groups = -(-nch // CHUNK)
    return (2, 42, _round4(nch)), (2, 42, _round4(groups)), (max(groups, 1),)


_tickets: dict = {}


def _group_tickets(device: torch.device, stream: int, k: int) -> torch.Tensor:
    """The kernel's group tickets for launches on `stream`: k ints at
    least, zeroed once; every launch leaves them at 0."""
    t = _tickets.get((device, stream))
    if t is None or t.numel() < k:
        t = _tickets[(device, stream)] = torch.zeros(k, dtype=torch.int32, device=device)
    return t


@functools.cache
def _launcher():
    from . import _build

    fn = _build.load("lio_cascade").lio_cascade_launch
    fn.argtypes = ([ctypes.c_void_p] * 25 + [ctypes.c_int] * 4 + [ctypes.c_float] * 4
                   + [ctypes.c_double] * 2 + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return _build.profiled("lio_cascade", fn)


def lio_cascade(m: tm.TiledMap, p_imu, bns, pmask, rot, x, prior_rot, prior_x, P_,
                max_iter: int, radius: int, threshold: float, gates, conv):
    """The iterated EKF on the tiled map `m` (radius 1 or 2: 27 or 125
    candidates; the plane fit's `threshold`, the gates (sq_dist, s, res)
    and the convergence thresholds `conv` (deg, cm) as lio.py sets them)
    from the pose (rot (3, 3), x = [pos, vel, bg, ba, grav]
    (15,), f64) toward the prior (prior_rot, prior_x, P' = prior.cov /
    laser_point_cov (18, 18)), for the scan p_imu (N, 3) f32 in the IMU
    frame with bns = |p_body|^(1/2) (N,) f32 and pmask (N,) bool, in one
    cooperative launch on the current stream (counted in
    `lio_cascade.launches`; the blocks launched in `lio_cascade.grid`).
    Returns (rot (3, 3), x (15,), G = K·HᵀH₆ (18, 6) f64 of the last
    iteration, sel (N,) bool, pabcd (N, 4) f32, plane_ok (N,) bool,
    iterations () int32), all on the card; nothing is read back. A tensor
    on any other device raises: the CPU runs `lio.lio_loop`. So does a
    card on which the grid cannot be co-resident."""
    if p_imu.device.type != "cuda":
        raise ValueError(f"lio_cascade: the kernel needs CUDA tensors, got {p_imu.device}")
    _check_tiled(m, p_imu, radius)
    dev = p_imu.device
    N = p_imu.shape[0]
    _require("lio_cascade: bns", bns, (N,), F32, dev)
    _require("lio_cascade: pmask", pmask, (N,), torch.bool, dev)
    _check_step("lio_cascade", rot, x, prior_rot, prior_x, P_)
    if rot.device != dev:
        raise ValueError("lio_cascade: inputs on different devices")
    offs = tm.neighbor_offsets(radius, dev)
    f64 = dict(dtype=F64, device=dev)
    rot_out, x_out, Gmat = (torch.empty((3, 3), **f64), torch.empty(15, **f64),
                            torch.empty((18, 6), **f64))
    sel = torch.empty(N, dtype=torch.bool, device=dev)
    plane_ok = torch.empty(N, dtype=torch.bool, device=dev)
    pabcd = torch.empty((N, 4), dtype=F32, device=dev)
    its = torch.empty((), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    part_s, gsum_s, tick_s = scratch_shapes(N)
    part = torch.empty(part_s, dtype=F32, device=dev)
    gsum = torch.empty(gsum_s, dtype=F32, device=dev)
    ptrs = [t.data_ptr() for t in (
        m.dir_check, m.dir_slot, m.cell_check, m.pts, m.voxel_size, m.log2_dims, offs, p_imu,
        bns, pmask, P_, prior_rot, prior_x, rot, x, part, gsum,
        _group_tickets(dev, stream, tick_s[0]), rot_out, x_out, Gmat, sel, pabcd, plane_ok,
        its)]
    grid = ctypes.c_int(0)
    err = _launcher()(*ptrs, N, offs.shape[0], m.slot_key.shape[0], int(max_iter),
                      float(threshold), *(float(g) for g in gates),
                      *(float(c) for c in conv), ctypes.byref(grid), stream)
    if err != 0:
        raise RuntimeError(f"lio_cascade: kernel launch failed (cudaError {err})")
    lio_cascade.launches += 1
    lio_cascade.grid = grid.value
    return rot_out, x_out, Gmat, sel, pabcd, plane_ok, its


lio_cascade.launches = 0
lio_cascade.grid = 0
