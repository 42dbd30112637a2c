"""Rays as (origin, direction) pairs (counterpart of rtc_tpu/ops/rays.py;
reference: src/ray.rs:5-25)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import transforms


class Ray(NamedTuple):
    """origin, direction: (..., 3) tensors."""

    origin: torch.Tensor
    direction: torch.Tensor


def ray(origin, direction, dtype=torch.float64, device="cuda") -> Ray:
    return Ray(torch.as_tensor(origin, dtype=dtype, device=device),
               torch.as_tensor(direction, dtype=dtype, device=device))


def position(r: Ray, t):
    """origin + direction * t (reference: src/ray.rs:15-17)."""
    t = torch.as_tensor(t, dtype=r.origin.dtype, device=r.origin.device)
    return r.origin + r.direction * t[..., None]


def transform(r: Ray, m) -> Ray:
    """Both origin and direction mapped; the direction is NOT renormalized,
    so t stays in the pre-transform scale (reference: src/ray.rs:19-24)."""
    return Ray(transforms.transform_points(m, r.origin),
               transforms.transform_dirs(m, r.direction))
