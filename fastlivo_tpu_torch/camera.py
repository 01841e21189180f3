"""Pinhole camera model with radial-tangential distortion, on tensors.

Port of the JAX package's camera.py (the reference's `vk::PinholeCamera`
from rpg_vikit, loaded from camera_*.yaml). All maps broadcast over
leading dimensions and are float32.

Conventions (vikit's):
  - `world2cam(xyz)`: camera-frame point -> distorted pixel (u, v).
  - `cam2world(px)`: pixel -> unit-norm bearing in the camera frame
    (undistorts by the same fixed-point scheme).
  - `is_in_frame(px, border)`: inside the image with a margin.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .config import CameraConfig


class Camera(NamedTuple):
    fx: torch.Tensor  # 0-d
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    d: torch.Tensor  # (4,) [k1, k2, p1, p2]
    width: int
    height: int


def from_config(cfg: CameraConfig, device, dtype=torch.float32) -> Camera:
    t = lambda v: torch.tensor(v, dtype=dtype, device=device)  # noqa: E731
    return Camera(fx=t(cfg.fx), fy=t(cfg.fy), cx=t(cfg.cx), cy=t(cfg.cy),
                  d=t(list(cfg.d[:4])), width=cfg.width, height=cfg.height)


def distort(cam: Camera, xn: torch.Tensor) -> torch.Tensor:
    """Normalized coords (..., 2) -> distorted normalized coords."""
    x, y = xn[..., 0], xn[..., 1]
    k1, k2, p1, p2 = cam.d[0], cam.d[1], cam.d[2], cam.d[3]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort(cam: Camera, xd: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Inverse of `distort` by fixed-point iteration (vikit's scheme)."""
    xn = xd
    for _ in range(iters):
        xn = xd - (distort(cam, xn) - xn)
    return xn


def world2cam(cam: Camera, xyz: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixel (..., 2). No z > 0 check."""
    xn = xyz[..., 0:2] / xyz[..., 2:3]
    xd = distort(cam, xn)
    u = cam.fx * xd[..., 0] + cam.cx
    v = cam.fy * xd[..., 1] + cam.cy
    return torch.stack([u, v], dim=-1)


def cam2world(cam: Camera, px: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> unit bearing vectors (..., 3). The 8-step
    undistortion runs for d = 0 cameras too, as in the JAX package."""
    xd = torch.stack([(px[..., 0] - cam.cx) / cam.fx,
                      (px[..., 1] - cam.cy) / cam.fy], dim=-1)
    xn = undistort(cam, xd)
    f = torch.cat([xn, torch.ones_like(xn[..., :1])], dim=-1)
    # the norm as sqrt((x² + y²) + 1²), the camera-frame kernels' order
    return f / torch.sqrt((xn[..., 0:1] * xn[..., 0:1] + xn[..., 1:2] * xn[..., 1:2]) + 1.0)


def is_in_frame(cam: Camera, px: torch.Tensor, border: int = 0) -> torch.Tensor:
    """(..., 2) -> (...,) bool, with the truncation of
    vk::AbstractCamera::isInFrame(px.cast<int>(), border)."""
    u = px[..., 0].to(torch.int32)
    v = px[..., 1].to(torch.int32)
    return ((u >= border) & (u < cam.width - border)
            & (v >= border) & (v < cam.height - border))


def load_camera_yaml(path) -> CameraConfig:
    """Load a vikit-style camera YAML (config/camera_pinhole.yaml)."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    return CameraConfig(
        width=int(raw["cam_width"]),
        height=int(raw["cam_height"]),
        fx=float(raw["cam_fx"]),
        fy=float(raw["cam_fy"]),
        cx=float(raw["cam_cx"]),
        cy=float(raw["cam_cy"]),
        d=[float(raw.get(f"cam_d{i}", 0.0)) for i in range(4)],
    )

