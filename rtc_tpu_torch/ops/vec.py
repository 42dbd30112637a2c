"""3-vector ops (counterpart of rtc_tpu/ops/vec.py), packed (..., 3) and
in component form.

The shading stage works on three (R,) tensors per vector. Every formula
keeps rtc_tpu's association order, because its f64 goldens pin the
output to about 1 ulp.
"""

from __future__ import annotations

import torch


def dot(a, b):
    """Batched dot product over the last axis (reference: src/tuple.rs:67-73)."""
    return torch.sum(a * b, dim=-1)


def cross(a, b):
    """Batched 3D cross product over the last axis (reference:
    src/tuple.rs:75-84). dim=-1 is explicit: torch.cross without it takes
    the first axis of size 3, which is wrong for a (3, 3) batch."""
    return torch.linalg.cross(a, b, dim=-1)


def magnitude(v):
    """Euclidean norm over the last axis (reference: src/tuple.rs:43-48)."""
    return torch.sqrt(torch.clamp_min(dot(v, v), 0.0))


def reflect(v, n):
    """Reflect v about the unit normal n (reference: src/tuple.rs:86-91)."""
    return v - n * (2.0 * dot(v, n))[..., None]


def unpack3(v):
    """(..., 3) -> three (...,) component tensors."""
    return v[..., 0], v[..., 1], v[..., 2]


def pack3(x, y, z):
    """Three (...,) component tensors -> (..., 3)."""
    return torch.stack([x, y, z], dim=-1)


def affine3(m, x, y, z):
    """One matrix a row applied to component vectors: m (R, 3, 3), or
    (R, 3, 4) with its last column the translation, and x, y, z (R,) ->
    (R, 3), row i ((m[:, i, 0] x + m[:, i, 1] y) + m[:, i, 2] z) (+ m[:, i, 3]),
    summed left to right as mesh_intersect.instance_rays and the prim kernel
    round. Shared matrices broadcast: m (N, 3, 4) with x, y, z (R, 1) gives
    (R, N, 3) (intersect.local_rays). Elementwise by column: a per-row
    einsum is a batched gemv on the card (cuBLAS, far below its bandwidth
    at 3x3), whose order is the library's."""
    c = m.unbind(-1)
    out = c[0] * x[:, None] + c[1] * y[:, None] + c[2] * z[:, None]
    return out + c[3] if len(c) == 4 else out


def dot3(ax, ay, az, bx, by, bz):
    """Component-form dot product, summed left to right."""
    return ax * bx + ay * by + az * bz


def cross3(ax, ay, az, bx, by, bz):
    """Component-form cross product, in jnp.cross's order."""
    return ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx


def normalize3(x, y, z):
    """Component-form normalize; a zero vector stays zero."""
    sq = x * x + y * y + z * z
    safe = torch.where(sq > 0.0, sq, 1.0)
    inv = torch.where(sq > 0.0, 1.0 / torch.sqrt(safe), 0.0)
    return x * inv, y * inv, z * inv


def normalize(v):
    """Packed (..., 3) normalize, with normalize3's rounding."""
    return pack3(*normalize3(*unpack3(v)))


def safe_sqrt(x):
    """sqrt clamped at zero (rtc_tpu's double-where form)."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def safe_div(num, den, eps=0.0):
    """num / den, with 0 where |den| <= eps (finite gradients)."""
    nonzero = torch.abs(den) > eps
    return torch.where(nonzero, num / torch.where(nonzero, den, 1.0), 0.0)
