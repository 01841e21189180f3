"""Batched SO(3) operations on tensors.

Port of the JAX package's ops/so3.py (the reference's scalar helpers,
include/so3_math.h:11-103). Every function broadcasts over leading batch
dimensions and is branch-free: small angles take masked Taylor forms.
"""
from __future__ import annotations

import torch

_SMALL = 1e-7


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix (SKEW_SYM_MATRX)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([o, -z, y], dim=-1),
            torch.stack([z, o, -x], dim=-1),
            torch.stack([-y, x, o], dim=-1),
        ],
        dim=-2,
    )


def exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential map: (..., 3) axis-angle -> (..., 3, 3).

        R = I + A * K + B * K^2,  K = skew(phi),
        A = sin(t)/t, B = (1-cos(t))/t^2
    with 4th-order Taylor fallbacks near t = 0 (so3_math.h:54-72)."""
    t2 = torch.sum(phi * phi, dim=-1)
    t = torch.sqrt(torch.clamp(t2, min=_SMALL**2))
    small = t2 < (_SMALL * 10.0) ** 2
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / (t * t))
    k = skew(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(k.shape)
    return eye + a[..., None, None] * k + b[..., None, None] * (k @ k)


def log(R: torch.Tensor) -> torch.Tensor:
    """Matrix logarithm: (..., 3, 3) -> (..., 3) axis-angle (Log(),
    so3_math.h:75-81): theta from the trace, axis from the antisymmetric
    part, 0.5 * vee(R - R^T) below theta = 1e-3."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.where(
        tr > 3.0 - 1e-6,
        torch.zeros_like(tr),
        torch.arccos(torch.clamp(0.5 * (tr - 1.0), -1.0, 1.0)),
    )
    k = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    tiny = torch.abs(theta) < 1e-3
    safe_sin = torch.where(tiny, torch.ones_like(theta), torch.sin(theta))
    scale = torch.where(tiny, torch.full_like(theta, 0.5),
                        0.5 * theta / safe_sin)
    return scale[..., None] * k
