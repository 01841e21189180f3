"""The iterated-EKF gain in float64.

The card has native FP64, so the port evaluates the gain exactly in f64
(the JAX package's `kalman_gain6_f64`), not through a mixed-precision
refinement scheme.
"""
from __future__ import annotations

import torch


def kalman_gain6_f64(P: torch.Tensor, HTH6: torch.Tensor) -> torch.Tensor:
    """K_1[:, :6] of the gain K_1 = (HᵀH + (P/R)⁻¹)⁻¹ via the 6x6 reduction.

    The reference inverts two 18x18 matrices (laserMapping.cpp:1663).
    With HᵀH nonzero only in its top-left 6x6 block, the factored form
    K_1 = P' (HᵀH P' + I)⁻¹ reduces to
        K_1[:, :6] = P'[:, :6] (HᵀH₆ P'[:6, :6] + I₆)⁻¹
    — one 6x6 solve. Only the first 6 columns are ever used.

    Args: P (18, 18) = cov/R, HTH6 (6, 6), both f64.
    Returns: (18, 6) f64.
    """
    A = HTH6 @ P[0:6, 0:6] + torch.eye(6, dtype=P.dtype, device=P.device)
    # K A = P[:, :6]  <=>  Aᵀ Kᵀ = P[:, :6]ᵀ (LU with partial pivoting);
    # solve_ex leaves the singularity check to the caller, so it does
    # not wait for the device
    X, _ = torch.linalg.solve_ex(A.T, P[:, 0:6].T)
    return X.T


def gj_solve6(S: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve S X = B (S (n, n), B (n, m) or (n,)) by Gauss-Jordan with
    partial pivoting, the elimination the photometric step kernel runs on
    its 6x6 system (csrc/photometric_cascade.cu, `step_warp`) and the JAX
    package's `gj_solve`: at column k the first row of the largest |entry|
    at or below the diagonal is swapped up, the row divided by its pivot,
    and every other row less its factor times that row. The plain version
    of the kernel's solve (one host read of the pivot row per column)."""
    vec = B.ndim == 1
    A = torch.cat([S, (B[:, None] if vec else B).to(S.dtype)], dim=1)
    n = S.shape[0]
    rows = torch.arange(n, device=S.device)
    for k in range(n):
        col = torch.where(rows >= k, torch.abs(A[:, k]), torch.full_like(A[:, k], -1.0))
        p = int(torch.argmax(col))
        if p != k:
            A[[k, p]] = A[[p, k]]
        A[k] = A[k] / A[k, k]
        fac = A[:, k].clone()
        fac[k] = 0.0
        A = A - fac[:, None] * A[k][None, :]
    X = A[:, n:]
    return X[:, 0] if vec else X


# 3-vectors and 3x3 products as the camera-frame kernels evaluate them
# (csrc/vio_common.cuh): each sum left to right, one rounding per product.
# A matmul's order and multiply-adds are the BLAS's own, and
# torch.linalg.norm's reduction order is its own on each device.

def norm3(x: torch.Tensor) -> torch.Tensor:
    """|x| over the last axis of (..., 3): sqrt((x0² + x1²) + x2²)."""
    return torch.sqrt((x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]) + x[..., 2] * x[..., 2])


def norm2(x: torch.Tensor) -> torch.Tensor:
    """|x| over the last axis of (..., 2)."""
    return torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1])


def matvec3(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """M @ x for (..., 3, 3) and (..., 3), broadcast over the batch."""
    return (M[..., 0] * x[..., 0:1] + M[..., 1] * x[..., 1:2]) + M[..., 2] * x[..., 2:3]


def mat3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B for (..., 3, 3) matrices, broadcast over the batch."""
    return ((A[..., :, 0:1] * B[..., 0:1, :] + A[..., :, 1:2] * B[..., 1:2, :])
            + A[..., :, 2:3] * B[..., 2:3, :])
