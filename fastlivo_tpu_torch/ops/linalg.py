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
