"""Ray-triangle intersection (counterpart of rtc_tpu/ops/intersect.py,
triangle only; the analytic kinds wait for ROADMAP queue 1 item 11)."""

from __future__ import annotations

import torch

from ..utils.constants import EPSILON
from .vec import cross3, dot3, unpack3


def triangle(o, d, p1, e1, e2, eps: float = EPSILON):
    """Möller-Trumbore (reference: src/shape.rs:437-459).

    o/d: (..., 3) rays; p1/e1/e2: (..., 3) triangle rows, broadcast against
    the rays by the caller (rays (R, 1, 3) x triangles (1, T, 3) give (R, T)
    results without any (R, T, 3) intermediate).

    Returns (t, valid, u, v). The CUDA kernels in ops/kernels evaluate the
    same expressions in the same order.
    """
    ox, oy, oz = unpack3(o)
    dx, dy, dz = unpack3(d)
    ax, ay, az = unpack3(p1)
    e1x, e1y, e1z = unpack3(e1)
    e2x, e2y, e2z = unpack3(e2)
    hx, hy, hz = cross3(dx, dy, dz, e2x, e2y, e2z)
    det = dot3(e1x, e1y, e1z, hx, hy, hz)
    det_ok = torch.abs(det) >= eps  # parallel -> miss (src/shape.rs:443)
    f = 1.0 / torch.where(det_ok, det, 1.0)
    sx, sy, sz = ox - ax, oy - ay, oz - az
    u = f * dot3(sx, sy, sz, hx, hy, hz)
    qx, qy, qz = cross3(sx, sy, sz, e1x, e1y, e1z)
    v = f * dot3(dx, dy, dz, qx, qy, qz)
    t = f * dot3(e2x, e2y, e2z, qx, qy, qz)
    valid = det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, valid, u, v
