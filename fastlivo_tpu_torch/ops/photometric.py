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

`partials=True` returns the measurement as a device mesh sums it (the
JAX package's psums, vio.py:650-654): [HT (42) | Σperr | n_meas], with
this call's n_meas clamped to at least 1, so that a rank with nothing
tracked still adds 1 to the denominator; the mean error is formed after
the sum.

Contract on the card: HT within rtol 1e-4 of max|HT| and err, perr,
Σperr within rtol 1e-5 of the plain version (the sums over the G·P² rows
are taken in another order than its matmul; the projection and the
sampling round as there); n_meas equal; nothing tracked gives exactly
err = 0, Σperr = 0, HT = 0 and n_meas = 1.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import camera as cam_mod
from . import image, so3

ROBUST = {"none": 0, "huber": 1, "tukey": 2}
HUBER_K = 1.345  # vk::robust_cost defaults (lidar_selection.cpp:75-78)
TUKEY_B = 4.6851
MAX_PATCH = 16  # (P+3)^2 taps fit one block of threads
I32 = torch.int32


def _recip32(c: float) -> float:
    """The f32 reciprocal XLA multiplies by where JAX divides by the
    constant `c` under jit."""
    return float(np.float32(1.0) / np.float32(c))


def _rows_times(p: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """p @ R.T for rows p (..., 3) and a (3, 3) R, as three products summed
    left to right: the kernel's order (a matmul's order and multiply-adds
    are the BLAS's own)."""
    return (p[..., 0:1] * R[:, 0] + p[..., 1:2] * R[:, 1]) + p[..., 2:3] * R[:, 2]


def photometric_err_H_plain(img, tr_pos, tr_patch_l, tr_slevel, tr_valid, rot, pos,
                            Rci, Pci, Jdphi_dR, Jdp_dR, cam, level: int, P: int,
                            robust: str = "none", robust_scale: float = 10.0,
                            partials: bool = False):
    """The measurement at the pose (rot (3, 3), pos (3,), f64) for
    pyramid `level`: tr_pos (G, 3), tr_patch_l (G, P, P) the level's
    reference patches, tr_slevel (G,) int32, tr_valid (G,) bool. Returns
    (err (), HTH6 (6, 6), HTz (6,), perr (G,)), all of img's dtype; with
    `partials`, ([HT (42) | Σperr | n_meas] (44,), perr (G,))."""
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
    res = val - tr_patch_l  # (G, P, P)
    zi = 1.0 / torch.where(front, pf[:, 2], 1.0)
    zi2 = zi * zi
    zero = torch.zeros_like(zi)
    fx, fy = cam.fx, cam.fy
    Jdpi = torch.stack([
        torch.stack([fx * zi, zero, -fx * pf[:, 0] * zi2], -1),
        torch.stack([zero, fy * zi, -fy * pf[:, 1] * zi2], -1),
    ], dim=-2)  # (G, 2, 3)
    # h = Jimg·Jdpi·[p_hat·Jdphi_dR − Jdp_dR | −Jdp_dt] (:826-832)
    p_hat = so3.skew(pf)
    Mg = torch.cat([torch.einsum("gde,ef->gdf", p_hat, Jdphi_dR) - Jdp_dR,
                    (-rcw).expand(p_hat.shape)], dim=-1)  # (G, 3, 6)
    N = torch.einsum("gcd,gdf->gcf", Jdpi, Mg)  # (G, 2, 6)
    Jimg = torch.stack([du, dv], dim=-1)  # (G, P, P, 2)
    h = torch.einsum("gxyc,gcf->gxyf", Jimg, N)  # (G, P, P, 6)
    w = (tr_valid & front).to(dtype)[:, None, None]
    res_w = res * w
    n_meas = torch.clamp(torch.sum(w) * P * P, min=1.0)
    perr = torch.sum(res_w * res_w, dim=(1, 2))  # (G,)
    err = torch.sum(perr) / n_meas
    if robust == "none":
        wr = w[..., None]
    else:
        # the JAX package's divisions by constants are f32 reciprocal
        # multiplies; k / t stays a true division (a Python-scalar
        # numerator would make it a reciprocal multiply)
        t = torch.abs(res) * _recip32(robust_scale)
        if robust == "huber":
            wh = torch.clamp(torch.full_like(t, HUBER_K) / torch.clamp(t, min=1e-12), max=1.0)
        else:
            uu = torch.clamp(1.0 - (t * _recip32(TUKEY_B)) ** 2, 0.0, 1.0)
            wh = uu * uu
        wr = (w * wh)[..., None]
    hw = (h * wr).reshape(-1, 6)
    rhs = torch.cat([h.reshape(-1, 6), res.reshape(-1, 1)], dim=1)
    HT = hw.T @ rhs  # (6, 7)
    if partials:
        return torch.cat([HT.reshape(42), torch.sum(perr)[None], n_meas[None]]), perr
    return err, HT[:, 0:6], HT[:, 6], perr


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
    if not 1 <= P <= MAX_PATCH:
        raise ValueError(f"photometric_err_H: patch_size {P} not in 1..{MAX_PATCH}")
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


@functools.cache
def _launcher():
    from . import _build

    fn = _build.load("photometric_err_H").photometric_err_H_launch
    fn.argtypes = ([ctypes.c_void_p] * 20 + [ctypes.c_int] * 7
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return _build.profiled("photometric_err_H", fn)


_tickets: dict = {}


def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    """The kernel's last-block counter for launches on `stream`: one int,
    zeroed once; every launch leaves it at 0."""
    t = _tickets.get((device, stream))
    if t is None:
        t = _tickets[(device, stream)] = torch.zeros(1, dtype=I32, device=device)
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
