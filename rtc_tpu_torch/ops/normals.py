"""Object-space normals per primitive kind (counterpart of
rtc_tpu/ops/normals.py; reference: src/shape.rs:466-519).

Each function maps object-space points (..., 3) to unnormalized
object-space normals; the integrator applies the inverse-transpose and
normalizes (src/shape.rs:623-635).
"""

from __future__ import annotations

import torch

from ..utils.constants import EPSILON
from .vec import safe_sqrt


def sphere(p):
    """point - origin (reference: src/shape.rs:470)."""
    return p


def plane(p):
    """Constant +y (reference: src/shape.rs:471), made on p's device
    with no data from the host."""
    n = p.new_zeros(3)
    n[1].fill_(1.0)  # a fill; n[1] = 1.0 would copy a host scalar
    return n.expand_as(p)


def cube(p):
    """The face of the largest |component|; ties break x, then y, then z,
    as the reference's if/else chain (src/shape.rs:472-486)."""
    ax = torch.abs(p)
    maxc = ax.amax(-1, keepdim=True)
    is_x = ax[..., 0:1] == maxc
    is_y = (~is_x) & (ax[..., 1:2] == maxc)
    zeros = torch.zeros_like(p[..., 0])
    nx = torch.stack([p[..., 0], zeros, zeros], -1)
    ny = torch.stack([zeros, p[..., 1], zeros], -1)
    nz = torch.stack([zeros, zeros, p[..., 2]], -1)
    return torch.where(is_x, nx, torch.where(is_y, ny, nz))


def cylinder(p, ymin, ymax, eps: float = EPSILON):
    """Caps win within unit radius and within eps of the cap plane
    (reference: src/shape.rs:487-500). ymin/ymax broadcast."""
    dist = p[..., 0] * p[..., 0] + p[..., 2] * p[..., 2]
    y = p[..., 1]
    zeros = torch.zeros_like(y)
    top = (dist < 1.0) & (y >= ymax - eps)
    bottom = (dist < 1.0) & (y <= ymin + eps)
    n_side = torch.stack([p[..., 0], zeros, p[..., 2]], -1)
    n_top = torch.stack([zeros, torch.ones_like(y), zeros], -1)
    n_bot = torch.stack([zeros, -torch.ones_like(y), zeros], -1)
    return torch.where(top[..., None], n_top,
                       torch.where(bottom[..., None], n_bot, n_side))


def cone(p):
    """(x, -sign(y) sqrt(x^2 + z^2), z), no cap case (reference:
    src/shape.rs:501-507)."""
    y = safe_sqrt(p[..., 0] * p[..., 0] + p[..., 2] * p[..., 2])
    y = torch.where(p[..., 1] > 0.0, -y, y)
    return torch.stack([p[..., 0], y, p[..., 2]], -1)
