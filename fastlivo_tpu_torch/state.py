"""The 18-dimensional navigation error-state as a NamedTuple of tensors.

Port of the JAX package's state.py (the reference's `StatesGroup`,
include/common_lib.h:296-381). Field names and layout are the JAX
package's, so states convert across field by field (convert.py).

State ordering (DIM_STATE=18, common_lib.h:330-365):
    [0:3]   delta-rotation (so3, right perturbation: R <- R Exp(d))
    [3:6]   position
    [6:9]   velocity
    [9:12]  gyro bias
    [12:15] accel bias
    [15:18] gravity
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .ops import so3

DIM_STATE = 18
INIT_COV = 0.001
G_M_S2 = 9.81  # gravity constant (common_lib.h:33)


class NavState(NamedTuple):
    """Navigation state. Every member is float64: the iterated-EKF
    covariance contracts to ~1e-8 variances beside ~1e-3 entries, below
    float32 resolution (the reference solves in double too). Point
    batches are float32 and take the pose cast down at the boundary."""

    rot: torch.Tensor  # (3, 3) world-from-imu rotation at segment end
    pos: torch.Tensor  # (3,)
    vel: torch.Tensor  # (3,)
    bg: torch.Tensor  # (3,) gyro bias
    ba: torch.Tensor  # (3,) accel bias
    grav: torch.Tensor  # (3,) gravity in world frame
    cov: torch.Tensor  # (18, 18) covariance


def identity_state(device, dtype=torch.float64) -> NavState:
    """Fresh state (StatesGroup's constructor, common_lib.h:298-306):
    identity pose, zero vectors, INIT_COV * I."""
    z = torch.zeros(3, dtype=dtype, device=device)
    return NavState(
        rot=torch.eye(3, dtype=dtype, device=device),
        pos=z, vel=z.clone(), bg=z.clone(), ba=z.clone(), grav=z.clone(),
        cov=torch.eye(DIM_STATE, dtype=dtype, device=device) * INIT_COV,
    )


def pack24(s: NavState) -> torch.Tensor:
    """Flatten the 24 logged state values [rot(9), pos, vel, bg, ba,
    grav] into one f64 vector, so the host reads them in one transfer."""
    return torch.cat(
        [s.rot.reshape(9), s.pos, s.vel, s.bg, s.ba, s.grav]
    ).to(torch.float64)


def boxplus(s: NavState, delta: torch.Tensor) -> NavState:
    """s [+] delta (StatesGroup::operator+=, common_lib.h:343-352)."""
    return NavState(
        rot=s.rot @ so3.exp(delta[0:3]),
        pos=s.pos + delta[3:6],
        vel=s.vel + delta[6:9],
        bg=s.bg + delta[9:12],
        ba=s.ba + delta[12:15],
        grav=s.grav + delta[15:18],
        cov=s.cov,
    )


def boxminus(a: NavState, b: NavState) -> torch.Tensor:
    """a [-] b -> (18,) (StatesGroup::operator-, common_lib.h:354-365)."""
    return torch.cat(
        [
            so3.log(b.rot.T @ a.rot),
            a.pos - b.pos,
            a.vel - b.vel,
            a.bg - b.bg,
            a.ba - b.ba,
            a.grav - b.grav,
        ]
    )
