"""Fused patch + gradient sampling for the photometric EKF.

`patches_and_grads` is the port of the TPU kernel
`patches_and_grads_pallas` (fastlivo_tpu/ops/pallas_image.py,
`pl.pallas_call` at line 180). On a CUDA tensor it launches the
hand-written kernel in csrc/patches_and_grads.cu (built at first use,
see _build.py); on a CPU tensor it runs the plain version
`ops/image.patches_and_grads`, which is also the kernel's oracle on the
card. The JAX package never wired its Pallas kernel in (one-hot MXU
matmuls stood in for a gather, 15x slower than XLA's gather on the TPU);
the port calls its kernel on every photometric EKF iteration.

Contract: the kernel rounds as the plain version does (bit-exact with
-fmad=false); the plain version matches the JAX package's at atol 1e-3
(tests/test_torch_camera_image.py).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .image import _scale_vec
from .image import patches_and_grads as patches_and_grads_plain

MAX_PATCH = 16  # (P+3)^2 taps and P*P pixels fit one block of threads


def _check(img, pc, scale, P):
    if img.ndim != 2 or pc.ndim != 2 or pc.shape[1] != 2:
        raise ValueError(f"patches_and_grads: shapes img {tuple(img.shape)}, "
                         f"pc {tuple(pc.shape)}")
    if scale.shape != pc.shape[:1]:
        raise ValueError(f"patches_and_grads: scale {tuple(scale.shape)} "
                         f"for {pc.shape[0]} points")
    if img.dtype != torch.float32 or pc.dtype != torch.float32:
        raise TypeError("patches_and_grads: img and pc must be float32")
    if scale.dtype != torch.int32:
        raise TypeError("patches_and_grads: scale must be int32")
    if not 1 <= P <= MAX_PATCH:
        raise ValueError(f"patches_and_grads: patch_size {P} not in 1..{MAX_PATCH}")
    for t in (pc, scale):
        if t.device != img.device:
            raise ValueError("patches_and_grads: inputs on different devices")
    for t in (img, pc, scale):
        if not t.is_contiguous():
            raise ValueError("patches_and_grads: inputs must be contiguous")


@functools.cache
def _launcher():
    from . import _build

    fn = _build.load("patches_and_grads").patches_and_grads_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def patches_and_grads(img: torch.Tensor, pc: torch.Tensor, patch_size: int,
                      scale):
    """(val, du, dv), each (K, P, P) f32: the signature of the JAX
    package's `image.patches_and_grads`. `scale` is an int or a (K,)
    int32 tensor (1..16 on the photometric path). A CUDA tensor launches
    the kernel on the current stream (counted in
    `patches_and_grads.launches`); a CPU tensor runs the plain version.
    No other device is taken and nothing falls back."""
    if img.device.type == "cpu":
        return patches_and_grads_plain(img, pc, patch_size, scale)
    if img.device.type != "cuda":
        raise ValueError(f"patches_and_grads: unsupported device {img.device}")
    scale = _scale_vec(scale, pc).contiguous()
    P = int(patch_size)
    _check(img, pc, scale, P)
    K, (H, W) = pc.shape[0], img.shape
    out = [torch.empty((K, P, P), dtype=torch.float32, device=img.device)
           for _ in range(3)]
    if K == 0:
        return tuple(out)
    stream = torch.cuda.current_stream(img.device).cuda_stream
    err = _launcher()(img.data_ptr(), pc.data_ptr(), scale.data_ptr(),
                      out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
                      K, H, W, P, stream)
    if err != 0:
        raise RuntimeError(
            f"patches_and_grads: kernel launch failed (cudaError {err})")
    patches_and_grads.launches += 1
    return tuple(out)


patches_and_grads.launches = 0
