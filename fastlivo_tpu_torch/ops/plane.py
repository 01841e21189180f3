"""Batched total-least-squares plane fitting.

Port of the JAX package's ops/plane.py: the smallest eigenvector of the
centred 3x3 scatter in closed form (trigonometric cubic solution), then
the plane in the reference's [n, d] form (esti_plane,
include/common_lib.h:449-493) with its all-neighbours-within-threshold
validity gate.
"""
from __future__ import annotations

import math

import torch


def sym3x3_min_eigvec(S: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of a symmetric 3x3
    batch (..., 3, 3): eigenvalues from the characteristic cubic, the
    vector as the largest cross product of rows of (S - lambda_min I).
    An isotropic scatter falls back to +z."""
    a00, a01, a02 = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    a11, a12, a22 = S[..., 1, 1], S[..., 1, 2], S[..., 2, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (
        a01 * a01 + a02 * a02 + a12 * a12
    )
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    detB = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    ) / (p * p * p)
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)

    r0 = torch.stack([a00 - lam_min, a01, a02], dim=-1)
    r1 = torch.stack([a01, a11 - lam_min, a12], dim=-1)
    r2 = torch.stack([a02, a12, a22 - lam_min], dim=-1)
    c01 = torch.linalg.cross(r0, r1)
    c02 = torch.linalg.cross(r0, r2)
    c12 = torch.linalg.cross(r1, r2)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    best = torch.where(
        ((n01 >= n02) & (n01 >= n12))[..., None],
        c01,
        torch.where((n02 >= n12)[..., None], c02, c12),
    )
    norm = torch.linalg.norm(best, dim=-1, keepdim=True)
    fallback = torch.zeros_like(best)
    fallback[..., 2] = 1.0
    ok = norm > 1e-20
    return torch.where(ok, best / torch.where(ok, norm, torch.ones_like(norm)),
                       fallback)


def fit_plane(pts: torch.Tensor, valid: torch.Tensor | None = None,
              threshold: float = 0.1):
    """Fit planes through neighbour sets (centred total least squares).

    Args:
      pts: (..., K, 3) neighbour coordinates (K = 5).
      valid: optional (..., K) bool; invalid rows don't constrain the fit.
      threshold: max point-to-plane distance for validity
        (reference: 0.1, laserMapping.cpp:1571).

    Returns:
      pabcd: (..., 4) [nx, ny, nz, d] with |n| = 1
      ok:    (...,) bool validity
    """
    if valid is None:
        valid = torch.ones(pts.shape[:-1], dtype=torch.bool, device=pts.device)
    w = valid.to(pts.dtype)[..., None]  # (..., K, 1)
    nvalid = torch.clamp(torch.sum(w, dim=(-2, -1)), min=1.0)
    centroid = torch.sum(pts * w, dim=-2) / nvalid[..., None]
    centered = (pts - centroid[..., None, :]) * w
    scatter = torch.einsum("...ki,...kj->...ij", centered, centered)
    normal = sym3x3_min_eigvec(scatter)
    d = -torch.sum(normal * centroid, dim=-1)
    pabcd = torch.cat([normal, d[..., None]], dim=-1)
    dist = torch.abs(torch.einsum("...ki,...i->...k", pts, normal) + d[..., None])
    ok = torch.all(torch.where(valid, dist <= threshold, True), dim=-1)
    ok = ok & (nvalid >= 3.0) & torch.all(torch.isfinite(pabcd), dim=-1)
    return pabcd, ok


def point_to_plane(pabcd: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Signed distance(s): (..., 4), (..., 3) -> (...,)."""
    return torch.sum(pabcd[..., :3] * p, dim=-1) + pabcd[..., 3]
