"""The reference's homogeneous Tuple (vec4) (counterpart of
rtc_tpu/ops/tuples.py; reference: src/tuple.rs).

A point has w == 1 and a vector w == 0. As in the reference, dot and
magnitude include w (src/tuple.rs:43-48, 67-73). The renderer itself
works on 3-vectors (ops/vec.py); this module serves the book's tuple
tables and users of the reference-shaped API.

Tuples are plain (..., 4) tensors, and their arithmetic is tensor
arithmetic. The constructors take dtype and device (the card by default,
as compile_scene); every other function follows its inputs.
"""

from __future__ import annotations

import torch

from ..utils.constants import EPSILON


def tuple4(x, y, z, w, dtype=torch.float64, device="cuda"):
    """(..., 4) tuples from four broadcastable components."""
    parts = [torch.as_tensor(c, dtype=dtype, device=device) for c in (x, y, z, w)]
    return torch.stack(torch.broadcast_tensors(*parts), dim=-1)


def point(x, y, z, dtype=torch.float64, device="cuda"):
    """(reference: src/tuple.rs:35-37)"""
    return tuple4(x, y, z, 1.0, dtype=dtype, device=device)


def vector(x, y, z, dtype=torch.float64, device="cuda"):
    """(reference: src/tuple.rs:39-41)"""
    return tuple4(x, y, z, 0.0, dtype=dtype, device=device)


def is_point(t):
    return t[..., 3] == 1.0


def is_vector(t):
    return t[..., 3] == 0.0


def magnitude(t):
    """Includes w, like the reference (src/tuple.rs:43-48)."""
    return torch.sqrt(torch.sum(t * t, dim=-1))


def normalize(t):
    """A zero tuple normalizes to zero (reference: src/tuple.rs:50-65)."""
    mag = magnitude(t)[..., None]
    return torch.where(mag > 0.0, t / torch.where(mag > 0.0, mag, 1.0), 0.0)


def dot(a, b):
    """Includes w, like the reference (src/tuple.rs:67-73)."""
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    """3D cross product of two vectors, as a w = 0 vector (src/tuple.rs:75-84)."""
    c = torch.linalg.cross(a[..., :3], b[..., :3], dim=-1)
    return torch.cat([c, torch.zeros_like(c[..., :1])], dim=-1)


def reflect(v, n):
    """(reference: src/tuple.rs:86-91)"""
    return v - n * (2.0 * dot(v, n))[..., None]


def almost_equal(a, b, eps: float = EPSILON):
    """Componentwise approximate equality, all-reduced over the last axis
    (reference: src/tuple.rs:93-100)."""
    return torch.all(torch.abs(a - b) < eps, dim=-1)
