"""One photometric EKF iteration's measurement: [HᵀWH | HᵀWz], the mean
patch error and the per-point errors.

`photometric_err_H` is the measurement of one iteration of UpdateState
(lidar_selection.cpp:805-860; the JAX package's `compute_err_H`,
vio.py:585-655), which samples through the TPU kernel
`patches_and_grads_pallas` (fastlivo_tpu/ops/pallas_image.py,
`pl.pallas_call` at line 180). On a CUDA tensor it launches the
hand-written kernel in csrc/photometric_err_H.cu (built at first use, see
_build.py): the projection, the sampling of csrc/patches_and_grads.cu
(one shared header), the Jacobians, the robust weights and the (6, 7)
reduction in one launch. On a CPU tensor it runs
`photometric_err_H_plain`, the same arithmetic in torch ops, which is
also the kernel's oracle on the card.

`partials_sum` is the order in which both measurement kernels sum the
per-point partials (csrc/photometric_measure.cuh::reduce_partials): eight
interleaved chains a quantity, then a fixed tree of the eight.

`partials=True` returns the measurement as a device mesh sums it (the
JAX package's psums, vio.py:650-654): [HT (42) | Σperr | n_meas], with
this call's n_meas clamped to at least 1, so that a rank with nothing
tracked still adds 1 to the denominator; the mean error is formed after
the sum.

`point_sums` is the order in which both sum a point's per-pixel terms
(photometric_measure.cuh::measure_point): the pixels dealt to the
`meas_threads(P)` threads of a block, a thread's pixels summed in turn,
a butterfly in each warp, then the warps in order. The plain version
writes every product and both orders out, so that on the card the kernel
is bit-equal to it: HT, err, perr, Σperr and n_meas. Nothing tracked
gives exactly err = 0, Σperr = 0, HT = 0 and n_meas = 1.

`photometric_step` is one iteration's prior-anchored f64 step
(lidar_selection.cpp:861-878; the JAX package's while_loop body,
vio.py:669-691): the gain K = P'[:, :6] (HᵀH₆ P'[:6, :6] + I₆)⁻¹, the
solution, the next pose, G = K·HᵀH₆ and the convergence flag. The LIO
host loop (`lio.lio_loop`) runs it too, fed -Hᵀz with the LIO thresholds
(`conv`). On a CUDA tensor it launches the one-warp kernel of
csrc/photometric_cascade.cu (ekf_step.cuh: a 6x6 Gauss-Jordan with
partial pivoting, `linalg.gj_solve6`'s elimination);
on a CPU tensor it runs `photometric_step_plain` (the LU solve of
`linalg.kalman_gain6_f64`). Contract on the card: within 1e-12 of the
plain version.

`photometric_cascade` is the whole coarse-to-fine cascade in one launch
(the JAX package's `jax.lax.while_loop`, vio.py:723): every iteration's
measurement (the code of csrc/photometric_err_H.cu), step and carry on
the card, with no host read and no launch between iterations. It takes
CUDA tensors only; its plain version is the host loop
`vio.photometric_loop` (one `photometric_err_H` and one `photometric_step`
per iteration, two flags read), which the CPU runs. Contract on the card
against that loop: the measurement bit-equal to `photometric_err_H`'s on
the same pose, and so, with `photometric_step`'s kernel, every output
bit-equal; with `photometric_step_plain`, equal iterations, rot and pos
within 1e-9, G within 1e-9 of its largest entry.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import camera as cam_mod
from . import image, linalg, so3

ROBUST = {"none": 0, "huber": 1, "tukey": 2}
HUBER_K = 1.345  # vk::robust_cost defaults (lidar_selection.cpp:75-78)
TUKEY_B = 4.6851
MEAS_MAX_THREADS = 384  # a measuring block's threads (photometric_measure.cuh)
I32 = torch.int32
F32, F64 = torch.float32, torch.float64
CONV_ROT_DEG = 0.001  # lidar_selection.cpp:885
CONV_POS_CM = 0.001
MAX_LEVELS = 8  # the cascade's level list


def _recip32(c: float) -> float:
    """The f32 reciprocal XLA multiplies by where JAX divides by the
    constant `c` under jit."""
    return float(np.float32(1.0) / np.float32(c))


def _rows_times(p: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """p @ R.T for rows p (..., 3) and a (3, 3) R, as three products summed
    left to right: the kernel's order (a matmul's order and multiply-adds
    are the BLAS's own)."""
    return (p[..., 0:1] * R[:, 0] + p[..., 1:2] * R[:, 1]) + p[..., 2:3] * R[:, 2]


def meas_threads(P: int) -> int:
    """The threads that measure a point (photometric_measure.cuh): (P+3)^2
    rounded up to whole warps, at least 64, at most MEAS_MAX_THREADS (one
    thread a pixel for every P <= 16)."""
    return min(32 * max(-(-(P + 3) ** 2 // 32), 2), MEAS_MAX_THREADS)


def point_sums(terms: torch.Tensor, P: int) -> torch.Tensor:
    """(P*P, G, K) -> (G, K): each point's per-pixel terms (pixel-major)
    summed in the measurement kernels' order. Pixel p goes to thread p %
    nt (nt = meas_threads(P)); a thread sums its pixels p, p + nt, ...
    left to right, the first as it is, and holds zeros without one; each
    warp of 32 threads is summed by a butterfly (thread i with thread i +
    16, then i + 8, ..., i + 1); the warps' sums are added in warp
    order."""
    PP, G, K = terms.shape
    nt = meas_threads(P)
    if PP >= nt:
        acc = terms[:nt].clone()
        for lo in range(nt, PP, nt):
            cnt = min(nt, PP - lo)
            acc[:cnt] = acc[:cnt] + terms[lo:lo + cnt]
    else:
        acc = torch.cat([terms, terms.new_zeros((nt - PP, G, K))])
    x = acc.view(nt // 32, 32, G, K)
    s = 16
    while s:
        x = x[:, :s] + x[:, s:2 * s]
        s //= 2
    t = x[0, 0]
    for w in range(1, nt // 32):
        t = t + x[w, 0]
    return t


def photometric_err_H_plain(img, tr_pos, tr_patch_l, tr_slevel, tr_valid, rot, pos,
                            Rci, Pci, Jdphi_dR, Jdp_dR, cam, level: int, P: int,
                            robust: str = "none", robust_scale: float = 10.0,
                            partials: bool = False):
    """The measurement at the pose (rot (3, 3), pos (3,), f64) for
    pyramid `level`: tr_pos (G, 3), tr_patch_l (G, P, P) the level's
    reference patches, tr_slevel (G,) int32, tr_valid (G,) bool. Returns
    (err (), HTH6 (6, 6), HTz (6,), perr (G,)), all of img's dtype; with
    `partials`, ([HT (42) | Σperr | n_meas] (44,), perr (G,)). Every
    product is its own op and every sum is taken in the kernels' order:
    a point's pixels by `point_sums`, the points by `partials_sum`."""
    if robust not in ROBUST:
        raise ValueError(f"robust={robust!r}")
    dtype = img.dtype
    scale = torch.bitwise_left_shift(
        torch.full_like(tr_slevel, 1 << level, dtype=I32), tr_slevel.to(I32))
    rcw = _rows_times(Rci, rot.to(dtype))  # Rci @ rot32ᵀ
    pcw = -_rows_times(pos.to(dtype), rcw) + Pci
    pf = _rows_times(tr_pos, rcw) + pcw  # (G, 3)
    front = pf[:, 2] > 1e-6
    pc = cam_mod.world2cam(cam, pf)
    val, du, dv = image.patches_and_grads(img, pc, P, scale)
    G = tr_pos.shape[0]
    res = (val - tr_patch_l).reshape(G, P * P).T.contiguous()  # pixel-major (P*P, G)
    zi = 1.0 / torch.where(front, pf[:, 2], 1.0)
    zi2 = zi * zi
    zero = torch.zeros_like(zi)
    fx, fy = cam.fx, cam.fy
    Jdpi = torch.stack([
        torch.stack([fx * zi, zero, -fx * pf[:, 0] * zi2], -1),
        torch.stack([zero, fy * zi, -fy * pf[:, 1] * zi2], -1),
    ], dim=-2)  # (G, 2, 3)
    # h = Jimg·Jdpi·[p_hat·Jdphi_dR − Jdp_dR | −Jdp_dt] (:826-832), each
    # 3-term sum left to right
    p_hat = so3.skew(pf)
    Mg = torch.cat([_rows_times(p_hat, Jdphi_dR.T) - Jdp_dR,
                    (-rcw).expand(p_hat.shape)], dim=-1)  # (G, 3, 6)
    N = ((Jdpi[:, :, 0:1] * Mg[:, 0:1] + Jdpi[:, :, 1:2] * Mg[:, 1:2])
         + Jdpi[:, :, 2:3] * Mg[:, 2:3])  # (G, 2, 6)
    du, dv = du.reshape(G, -1).T.contiguous(), dv.reshape(G, -1).T.contiguous()  # (P*P, G)
    w = (tr_valid & front).to(dtype)
    res_w = res * w
    if robust == "none":
        wr = w.expand(res.shape)
    else:
        # the JAX package's divisions by constants are f32 reciprocal
        # multiplies; k / t stays a true division (a Python-scalar
        # numerator would make it a reciprocal multiply)
        t = torch.abs(res) * _recip32(robust_scale)
        if robust == "huber":
            wh = torch.clamp(torch.full_like(t, HUBER_K) / torch.clamp(t, min=1e-12), max=1.0)
        else:
            tb = t * _recip32(TUKEY_B)
            uu = torch.clamp(1.0 - tb * tb, 0.0, 1.0)
            wh = uu * uu
        wr = w * wh
    # the 43 terms per pixel; on the CPU a few points at a time (each
    # point's sums are its own; ~8 MB of terms a chunk stays in cache), on
    # the card in one pass
    chunk = max(G, 1) if res.is_cuda else max(1, (1 << 21) // (P * P * 43))
    sums = []
    for g in range(0, G, chunk):
        s = slice(g, g + chunk)
        h = du[:, s, None] * N[s, 0] + dv[:, s, None] * N[s, 1]  # (P*P, g, 6)
        hw = h * wr[:, s, None]
        rhs = torch.cat([h, res[:, s, None]], dim=-1)  # (P*P, g, 7)
        terms = torch.cat([(hw[..., :, None] * rhs[..., None, :]).reshape(P * P, -1, 42),
                           (res_w[:, s] * res_w[:, s])[..., None]], dim=-1)
        sums.append(point_sums(terms, P))
    sums = torch.cat(sums) if sums else res.new_zeros((0, 43))  # (G, 43)
    perr = sums[:, 42]
    tot = partials_sum(torch.cat([sums, w[:, None]], dim=1))
    HT = tot[:42].view(6, 7)
    n_meas = torch.clamp(tot[43] * P * P, min=1.0)
    if partials:
        return torch.cat([tot[:42], tot[42:43], n_meas[None]]), perr
    return tot[42] / n_meas, HT[:, 0:6], HT[:, 6], perr


def _check(img, tr_pos, tr_patch_l, tr_slevel, tr_valid, rot, pos, Rci, Pci,
           Jdphi_dR, Jdp_dR, cam, level, P):
    G = tr_pos.shape[0]
    f32, f64 = torch.float32, torch.float64
    want = [(img, None, f32), (tr_pos, (G, 3), f32), (tr_slevel, (G,), I32),
            (tr_valid, (G,), torch.bool), (rot, (3, 3), f64), (pos, (3,), f64),
            (Rci, (3, 3), f32), (Pci, (3,), f32), (Jdphi_dR, (3, 3), f32),
            (Jdp_dR, (3, 3), f32), (cam.fx, (), f32), (cam.fy, (), f32),
            (cam.cx, (), f32), (cam.cy, (), f32), (cam.d, (4,), f32),
            (tr_patch_l, (G, P, P), f32)]
    if img.ndim != 2:
        raise ValueError(f"photometric_err_H: image of shape {tuple(img.shape)}")
    if P < 1:
        raise ValueError(f"photometric_err_H: patch_size {P} < 1")
    if not 0 <= level <= 8:
        raise ValueError(f"photometric_err_H: level {level} not in 0..8")
    for t, shape, dtype in want:
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"photometric_err_H: shape {tuple(t.shape)}, want {shape}")
        if t.dtype != dtype:
            raise TypeError(f"photometric_err_H: dtype {t.dtype}, want {dtype}")
        if t.device != img.device:
            raise ValueError("photometric_err_H: inputs on different devices")
    for t, _, _ in want[:-1]:
        if not t.is_contiguous():
            raise ValueError("photometric_err_H: inputs must be contiguous")
    # the level slice of a (G, 3, P, P) block: contiguous (P, P) planes
    if tr_patch_l.stride()[1:] != (P, 1):
        raise ValueError("photometric_err_H: tr_patch planes must be contiguous")


def partials_sum(partial: torch.Tensor) -> torch.Tensor:
    """(G, K) -> (K,): the rows summed in the measurement kernels' order.
    Rows g < G8 = G - G % 8 go into eight interleaved chains (row g into
    chain g % 8, in row order, each chain from 0.0), the last G % 8 rows
    after chain 0's; then ((t0 + t1) + (t2 + t3)) + ((t4 + t5) + (t6 +
    t7)). Zero rows give zeros."""
    G, K = partial.shape
    G8 = G - G % 8
    t = partial.new_zeros((8, K))
    for row8 in partial[:G8].view(-1, 8, K):
        t = t + row8
    for r in range(G8, G):
        t[0] = t[0] + partial[r]
    return ((t[0] + t[1]) + (t[2] + t[3])) + ((t[4] + t[5]) + (t[6] + t[7]))


@functools.cache
def _launcher():
    from . import _build

    fn = _build.load("photometric_err_H").photometric_err_H_launch
    fn.argtypes = ([ctypes.c_void_p] * 20 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return _build.profiled("photometric_err_H", fn)


_tickets: dict = {}


def _ticket(device: torch.device, stream: int, k: int = 1) -> torch.Tensor:
    """Counters for launches on `stream` that every launch leaves at 0: k
    ints at least, zeroed once (photometric_err_H's last-block counter;
    voxel_centroids' ticket, finished blocks and tile status words)."""
    t = _tickets.get((device, stream))
    if t is None or t.numel() < k:
        t = _tickets[(device, stream)] = torch.zeros(k, dtype=I32, device=device)
    return t


def photometric_err_H(img, tr_pos, tr_patch_l, tr_slevel, tr_valid, rot, pos,
                      Rci, Pci, Jdphi_dR, Jdp_dR, cam, level: int, P: int,
                      robust: str = "none", robust_scale: float = 10.0,
                      partials: bool = False):
    """`photometric_err_H_plain`'s signature and outputs. A CUDA tensor
    launches the fused kernel on the current stream (counted in
    `photometric_err_H.launches`); a CPU tensor runs the plain version.
    No other device is taken and nothing falls back."""
    if img.device.type == "cpu":
        return photometric_err_H_plain(img, tr_pos, tr_patch_l, tr_slevel, tr_valid,
                                       rot, pos, Rci, Pci, Jdphi_dR, Jdp_dR, cam,
                                       level, P, robust, robust_scale, partials)
    if img.device.type != "cuda":
        raise ValueError(f"photometric_err_H: unsupported device {img.device}")
    if robust not in ROBUST:
        raise ValueError(f"robust={robust!r}")
    P, level = int(P), int(level)
    _check(img, tr_pos, tr_patch_l, tr_slevel, tr_valid, rot, pos, Rci, Pci,
           Jdphi_dR, Jdp_dR, cam, level, P)
    G, (H, W) = tr_pos.shape[0], img.shape
    dev = img.device
    # [HT (6, 7), err, n_meas, Σperr]; nothing to reduce leaves
    # err = Σperr = 0, HT = 0 and n_meas = 1
    if G == 0:
        out = torch.zeros(45, dtype=torch.float32, device=dev)
        out[43] = 1.0
    else:
        out = torch.empty(45, dtype=torch.float32, device=dev)
    perr = torch.empty(G, dtype=torch.float32, device=dev)
    if G > 0:
        stream = torch.cuda.current_stream(dev).cuda_stream
        partial = torch.empty((G, 44), dtype=torch.float32, device=dev)
        ptrs = [t.data_ptr() for t in (
            img, tr_pos, tr_patch_l, tr_slevel, tr_valid, rot, pos, Rci, Pci,
            Jdphi_dR, Jdp_dR, cam.fx, cam.fy, cam.cx, cam.cy, cam.d, partial,
            _ticket(dev, stream), out, perr)]
        err = _launcher()(*ptrs, G, H, W, P, level, tr_patch_l.stride(0),
                          ROBUST[robust], HUBER_K, _recip32(TUKEY_B),
                          _recip32(robust_scale), stream)
        if err != 0:
            raise RuntimeError(
                f"photometric_err_H: kernel launch failed (cudaError {err})")
        photometric_err_H.launches += 1
    if partials:
        return torch.cat([out[:42], out[44:45], out[43:44]]), perr
    HT = out[:42].view(6, 7)
    return out[42], HT[:, 0:6], HT[:, 6], perr


photometric_err_H.launches = 0


def photometric_step_plain(rot, x, prior_rot, prior_x, P_, HT,
                           conv=(CONV_ROT_DEG, CONV_POS_CM)):
    """One iteration's prior-anchored step from the pose (rot (3, 3), x =
    [pos, vel, bg, ba, grav] (15,), f64) with HT = [HᵀH₆ | Hᵀz] (6, 7) f32
    and P' = prior.cov / img_point_cov (18, 18) f64, converged when
    |sol[:3]|·57.3 < conv[0] and |sol[3:6]|·100 < conv[1]. Returns (rot'
    (3, 3), x' (15,), conv () bool, G = K·HᵀH₆ (18, 6)), all f64 but conv.
    The LIO step (lio.py) is this step fed -Hᵀz with its own thresholds."""
    HTH6, HTz = HT[:, 0:6].to(F64), HT[:, 6].to(F64)
    K16 = linalg.kalman_gain6_f64(P_, HTH6)
    vec = torch.cat([so3.log(rot.T @ prior_rot), prior_x - x])
    sol = vec - K16 @ (HTz + HTH6 @ vec[0:6])
    n_rot = rot @ so3.exp(sol[0:3])
    n_x = x + sol[3:18]
    conv = ((torch.linalg.norm(sol[0:3]) * 57.3 < conv[0])
            & (torch.linalg.norm(sol[3:6]) * 100.0 < conv[1]))
    return n_rot, n_x, conv, K16 @ HTH6


def _require(name, t, shape, dtype, dev):
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shape}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, want {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_step(where, rot, x, prior_rot, prior_x, P_):
    dev = rot.device
    for name, t, shape in (("rot", rot, (3, 3)), ("x", x, (15,)),
                           ("prior_rot", prior_rot, (3, 3)),
                           ("prior_x", prior_x, (15,)), ("P'", P_, (18, 18))):
        _require(f"{where}: {name}", t, shape, F64, dev)


@functools.cache
def _step_launcher():
    from . import _build

    fn = _build.load("photometric_cascade").photometric_step_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_double] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return _build.profiled("photometric_step", fn)


def photometric_step(rot, x, prior_rot, prior_x, P_, HT, conv=(CONV_ROT_DEG, CONV_POS_CM)):
    """`photometric_step_plain`'s signature and outputs. A CUDA tensor
    launches the one-warp step kernel on the current stream (counted in
    `photometric_step.launches`); a CPU tensor runs the plain version. No
    other device is taken and nothing falls back."""
    if rot.device.type == "cpu":
        return photometric_step_plain(rot, x, prior_rot, prior_x, P_, HT, conv)
    if rot.device.type != "cuda":
        raise ValueError(f"photometric_step: unsupported device {rot.device}")
    _check_step("photometric_step", rot, x, prior_rot, prior_x, P_)
    _require("photometric_step: HT", HT, (6, 7), F32, rot.device)
    out = dict(dtype=F64, device=rot.device)
    n_rot, n_x, G = torch.empty((3, 3), **out), torch.empty(15, **out), torch.empty((18, 6), **out)
    flag = torch.empty(1, dtype=torch.bool, device=rot.device)
    ptrs = [t.data_ptr() for t in (P_, prior_rot, prior_x, rot, x, HT, n_rot, n_x, flag, G)]
    err = _step_launcher()(*ptrs, float(conv[0]), float(conv[1]),
                           torch.cuda.current_stream(rot.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"photometric_step: kernel launch failed (cudaError {err})")
    photometric_step.launches += 1
    return n_rot, n_x, flag[0], G


photometric_step.launches = 0


@functools.cache
def _cascade_launcher():
    from . import _build

    fn = _build.load("photometric_cascade").photometric_cascade_launch
    fn.argtypes = ([ctypes.c_void_p] * 27 + [ctypes.POINTER(ctypes.c_int)]
                   + [ctypes.c_int] * 8 + [ctypes.c_float] * 3
                   + [ctypes.POINTER(ctypes.c_int), ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return _build.profiled("photometric_cascade", fn)


def photometric_cascade(img, tr_pos, tr_patch, tr_slevel, tr_valid, rot, x, prior_rot,
                        prior_x, P_, Rci, Pci, Jdphi_dR, Jdp_dR, cam, levels, P: int,
                        max_iter: int, robust: str = "none", robust_scale: float = 10.0):
    """The cascade over `levels` (coarse to fine, each an index into
    tr_patch (G, L, P, P)) from the pose (rot (3, 3), x (15,), f64) toward
    the prior (prior_rot, prior_x, P' = prior.cov / img_point_cov (18,
    18)), at most `max_iter` (>= 1) iterations a level, in one cooperative
    launch on the current stream (counted in
    `photometric_cascade.launches`; the blocks launched in
    `photometric_cascade.grid`). Returns (rot (3, 3), x (15,), G (18, 6),
    per-point errors (G,), mean error () f64, iterations () int32), all on
    the card; nothing is read back. A tensor on any other device raises:
    the CPU runs `vio.photometric_loop`. So does a card on which the grid
    cannot be co-resident."""
    if img.device.type != "cuda":
        raise ValueError(f"photometric_cascade: the kernel needs CUDA tensors, got {img.device}")
    if robust not in ROBUST:
        raise ValueError(f"robust={robust!r}")
    P, max_iter, levels = int(P), int(max_iter), [int(v) for v in levels]
    if tr_patch.ndim != 4 or not tr_patch.is_contiguous():
        raise ValueError(f"photometric_cascade: tr_patch {tuple(tr_patch.shape)} must be a "
                         "contiguous (G, L, P, P) block")
    if not 1 <= len(levels) <= MAX_LEVELS or not all(0 <= v < tr_patch.shape[1] for v in levels):
        raise ValueError(f"photometric_cascade: levels {levels} for {tr_patch.shape[1]} planes")
    if max_iter < 1:
        raise ValueError(f"photometric_cascade: max_iter {max_iter} < 1")
    _check(img, tr_pos, tr_patch[:, levels[0]], tr_slevel, tr_valid, rot, x[0:3], Rci, Pci,
           Jdphi_dR, Jdp_dR, cam, max(levels), P)
    _check_step("photometric_cascade", rot, x, prior_rot, prior_x, P_)
    G, (H, W) = tr_pos.shape[0], img.shape
    dev = img.device
    f64 = dict(dtype=F64, device=dev)
    rot_out, x_out = torch.empty((3, 3), **f64), torch.empty(15, **f64)
    Gmat, last_err = torch.empty((18, 6), **f64), torch.empty((), **f64)
    perr = torch.empty(G, dtype=F32, device=dev)
    its = torch.empty((), dtype=I32, device=dev)
    partial = torch.empty((2, max(G, 1), 44), dtype=F32, device=dev)  # by parity
    perr_cur = torch.empty((2, max(G, 1)), dtype=F32, device=dev)
    ptrs = [t.data_ptr() for t in (
        img, tr_pos, tr_patch, tr_slevel, tr_valid, Rci, Pci, Jdphi_dR, Jdp_dR, cam.fx,
        cam.fy, cam.cx, cam.cy, cam.d, P_, prior_rot, prior_x, rot, x, partial, perr_cur,
        rot_out, x_out, Gmat, perr, last_err, its)]
    grid = ctypes.c_int(0)
    err = _cascade_launcher()(
        *ptrs, (ctypes.c_int * len(levels))(*levels), len(levels), max_iter, G, H, W, P,
        tr_patch.stride(0), ROBUST[robust], HUBER_K, _recip32(TUKEY_B),
        _recip32(robust_scale), ctypes.byref(grid),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"photometric_cascade: kernel launch failed (cudaError {err})")
    photometric_cascade.launches += 1
    photometric_cascade.grid = grid.value
    return rot_out, x_out, Gmat, perr, last_err, its


photometric_cascade.launches = 0
photometric_cascade.grid = 0
