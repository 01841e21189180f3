"""Batched plane fitting.

Port of the JAX package's ops/plane.py. Two fits, both reporting the
plane in the reference's [n, d] form (esti_plane,
include/common_lib.h:449-493) with its all-neighbours-within-threshold
validity gate:
  - `fit_plane` (`plane_fit: tls`, the default): the smallest
    eigenvector of the centred 3x3 scatter in closed form
    (trigonometric cubic solution);
  - `fit_plane_ref` (`plane_fit: ref`): the reference's own
    parametrisation, A·n = -1 solved by least squares in float64.
"""
from __future__ import annotations

import math

import torch


def _solve3x3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 solve through the adjugate (Cramer). A (..., 3, 3),
    b (..., 3). A near-singular system gives a large solution, which the
    validity gate downstream rejects."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
    x = c00 * b[..., 0] + c01 * b[..., 1] + c02 * b[..., 2]
    y = c10 * b[..., 0] + c11 * b[..., 1] + c12 * b[..., 2]
    z = c20 * b[..., 0] + c21 * b[..., 1] + c22 * b[..., 2]
    return torch.stack([x, y, z], dim=-1) * inv_det[..., None]


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


def fit_plane_ref(pts: torch.Tensor, valid: torch.Tensor | None = None,
                  threshold: float = 0.1):
    """The reference's exact plane (esti_plane, common_lib.h:449-493):
    the least-squares solution of A·n = -1 over the K neighbours, then
    pabcd = [n / |n|, 1 / |n|]; valid iff every neighbour lies within
    `threshold` of the normalised plane. The normal equations square the
    conditioning, so the algebra runs in float64.

    Same signature and returns as `fit_plane`. With a `valid` mask, rows
    outside it do not constrain the fit and validity also needs all K
    rows valid (the reference fits only a full neighbour set).

    Every sum is written out in the order that csrc/plane_fit.cuh's
    plane5_fit_ref copies (AᵀA and Aᵀb over the rows left to right, |n|²
    as (x² + y²) + z², each distance as ((x nx + y ny) + z nz) + d), so
    that the card's fit and this one round alike."""
    K = pts.shape[-2]
    if valid is None:
        valid = torch.ones(pts.shape[:-1], dtype=torch.bool, device=pts.device)
    f64 = torch.float64
    q = pts.to(f64)
    p = q * valid.to(f64)[..., None]
    x, y, z = p[..., 0], p[..., 1], p[..., 2]

    def ksum(v):  # over the K rows, left to right
        s = v[..., 0]
        for k in range(1, K):
            s = s + v[..., k]
        return s

    sxx, sxy, sxz = ksum(x * x), ksum(x * y), ksum(x * z)
    syy, syz, szz = ksum(y * y), ksum(y * z), ksum(z * z)
    AtA = torch.stack([torch.stack([sxx, sxy, sxz], -1), torch.stack([sxy, syy, syz], -1),
                       torch.stack([sxz, syz, szz], -1)], -2)
    Atb = -torch.stack([ksum(x), ksum(y), ksum(z)], -1)  # Aᵀ·(-1)
    n = _solve3x3(AtA, Atb)
    norm = torch.sqrt((n[..., 0] * n[..., 0] + n[..., 1] * n[..., 1]) + n[..., 2] * n[..., 2])
    inv = 1.0 / torch.clamp(norm, min=1e-30)
    normal = n * inv[..., None]
    pabcd = torch.cat([normal, inv[..., None]], dim=-1)  # d = 1/|n| (:469)
    dist = torch.abs(((q[..., 0] * normal[..., None, 0] + q[..., 1] * normal[..., None, 1])
                      + q[..., 2] * normal[..., None, 2]) + inv[..., None])
    ok = torch.all(torch.where(valid, dist <= threshold, True), dim=-1)
    ok = (ok & (torch.sum(valid, dim=-1) == K) & (norm > 1e-30)
          & torch.all(torch.isfinite(pabcd), dim=-1))
    return pabcd.to(pts.dtype), ok


def point_to_plane(pabcd: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Signed distance(s): (..., 4), (..., 3) -> (...,)."""
    return torch.sum(pabcd[..., :3] * p, dim=-1) + pabcd[..., 3]
