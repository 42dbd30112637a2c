"""Object-space intersection for every primitive kind (counterpart of
rtc_tpu/ops/intersect.py; reference: src/shape.rs:248-463).

Each analytic kind is a branchless batched function over rays of shape
(..., 3) returning a fixed number of candidate-t slots and their validity:

    sphere   -> 2 slots   (src/shape.rs:258-273)
    plane    -> 1 slot    (src/shape.rs:274-282)
    cube     -> 2 slots   (src/shape.rs:283-319, check_axis :587-606)
    cylinder -> 4 slots: wall0, wall1, cap_min, cap_max  (src/shape.rs:320-355)
    cone     -> 4 slots: wall0/linear, wall1, cap_min, cap_max (src/shape.rs:356-398)
    triangle -> 1 slot    (Möller-Trumbore, src/shape.rs:437-459)
    aabb     -> 2 slots   (the group-bounds cull, src/shape.rs:399-425)

Invalid slots carry arbitrary finite t values; callers mask with `valid`.
Every formula keeps rtc_tpu's association order, summed left to right,
and the prim kernel (csrc/mesh_intersect.cu prim_sweep_kernel) evaluates
the analytic kinds in the same order: prims() below is its plain version.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.constants import BIG, EPSILON
from .vec import affine3, cross3, dot3, safe_sqrt, unpack3

# kind codes (scene.shapes.KIND_CODES)
SPHERE, PLANE, CUBE, CYLINDER, CONE = 0, 1, 2, 3, 4

# calls of prims(), the plain sweep over every prim; apart from the kernels'
# launches (mesh_intersect.LAUNCHES), and like them repeated by each replay
# of a CUDA graph whose capture made them (render/compiled.py)
PLAIN_SWEEPS = {"prims": 0}


class Hits(NamedTuple):
    """t: (..., k) candidate hit times; valid: (..., k) mask."""

    t: torch.Tensor
    valid: torch.Tensor


def _quadratic(a, b, c):
    """Both roots of ax^2+bx+c, smaller first when a > 0; valid iff
    disc >= 0 (a != 0 is the callers' job)."""
    disc = b * b - 4.0 * a * c
    valid = disc >= 0.0
    sq = safe_sqrt(disc)
    denom = torch.where(torch.abs(a) > 0.0, 2.0 * a, 1.0)
    return (-b - sq) / denom, (-b + sq) / denom, valid


def sphere(o, d) -> Hits:
    """Unit sphere at the origin (reference: src/shape.rs:258-273)."""
    o3, d3 = unpack3(o), unpack3(d)
    a = dot3(*d3, *d3)
    b = 2.0 * dot3(*d3, *o3)
    c = dot3(*o3, *o3) - 1.0
    t0, t1, valid = _quadratic(a, b, c)
    return Hits(torch.stack([t0, t1], -1), torch.stack([valid, valid], -1))


def plane(o, d, eps: float = EPSILON) -> Hits:
    """The xz plane, +y normal (reference: src/shape.rs:274-282)."""
    dy = d[..., 1]
    valid = torch.abs(dy) >= eps
    t = -o[..., 1] / torch.where(valid, dy, 1.0)
    return Hits(t[..., None], valid[..., None])


def _check_axis(o1, d1, lo, hi, eps: float):
    """One slab (reference: src/shape.rs:587-606). A parallel ray gives
    (-BIG, BIG) inside the slab and an empty interval outside, as the
    reference's NaN-ignoring min/max do."""
    num_lo = lo - o1
    num_hi = hi - o1
    parallel = torch.abs(d1) < eps
    d_safe = torch.where(parallel, 1.0, d1)
    ta = num_lo / d_safe
    tb = num_hi / d_safe
    big = torch.full_like(num_lo, BIG)  # keeps BIG in the rays' dtype
    tmin = torch.where(parallel, torch.where(num_lo <= 0.0, -big, big),
                       torch.minimum(ta, tb))
    tmax = torch.where(parallel, torch.where(num_hi >= 0.0, big, -big),
                       torch.maximum(ta, tb))
    return tmin, tmax


def cube(o, d, eps: float = EPSILON) -> Hits:
    """The axis-aligned +-1 cube (reference: src/shape.rs:283-319)."""
    xtmin, xtmax = _check_axis(o[..., 0], d[..., 0], -1.0, 1.0, eps)
    ytmin, ytmax = _check_axis(o[..., 1], d[..., 1], -1.0, 1.0, eps)
    ztmin, ztmax = _check_axis(o[..., 2], d[..., 2], -1.0, 1.0, eps)
    tmin = torch.maximum(torch.maximum(xtmin, ytmin), ztmin)
    tmax = torch.minimum(torch.minimum(xtmax, ytmax), ztmax)
    valid = tmax >= tmin
    return Hits(torch.stack([tmin, tmax], -1), torch.stack([valid, valid], -1))


def aabb(o, d, box_min, box_max, eps: float = EPSILON) -> Hits:
    """General AABB slab test, the group-bounds cull (reference:
    src/shape.rs:399-425). box_min/box_max: (..., 3). The group cull hits
    on tmax > tmin (strict), unlike the cube's >= (src/shape.rs:425)."""
    tmins, tmaxs = zip(*(_check_axis(o[..., ax], d[..., ax], box_min[..., ax],
                                     box_max[..., ax], eps) for ax in range(3)))
    tmin = torch.maximum(torch.maximum(tmins[0], tmins[1]), tmins[2])
    tmax = torch.minimum(torch.minimum(tmaxs[0], tmaxs[1]), tmaxs[2])
    valid = tmax > tmin
    return Hits(torch.stack([tmin, tmax], -1), torch.stack([valid, valid], -1))


def _check_cap(o, d, t):
    """Cap-disc membership x^2 + z^2 <= |y| at time t (reference:
    src/shape.rs:579-585: the bound is |y|, not 1, faithfully)."""
    x = o[..., 0] + t * d[..., 0]
    y = o[..., 1] + t * d[..., 1]
    z = o[..., 2] + t * d[..., 2]
    return x * x + z * z <= torch.abs(y)


def _caps(o, d, ymin, ymax, capped, eps: float):
    """Cylinder and cone caps (reference: src/shape.rs:537-573)."""
    oy, dy = o[..., 1], d[..., 1]
    dy_ok = torch.abs(dy) >= eps
    dy_safe = torch.where(dy_ok, dy, 1.0)
    t_lo = (ymin - oy) / dy_safe
    t_hi = (ymax - oy) / dy_safe
    enabled = capped & dy_ok
    return (t_lo, enabled & _check_cap(o, d, t_lo),
            t_hi, enabled & _check_cap(o, d, t_hi))


def cylinder(o, d, ymin, ymax, capped, eps: float = EPSILON) -> Hits:
    """Unit-radius y-axis cylinder, truncated to ymin < y < ymax, open or
    capped (reference: src/shape.rs:320-355). ymin/ymax/capped broadcast."""
    ox, oz = o[..., 0], o[..., 2]
    dx, dz = d[..., 0], d[..., 2]
    a = dx * dx + dz * dz
    wall_possible = torch.abs(a) >= eps
    b = 2.0 * (ox * dx + oz * dz)
    c = ox * ox + oz * oz - 1.0
    t0, t1, disc_ok = _quadratic(torch.where(wall_possible, a, 1.0), b, c)
    y0 = o[..., 1] + t0 * d[..., 1]
    y1 = o[..., 1] + t1 * d[..., 1]
    v0 = wall_possible & disc_ok & (ymin < y0) & (y0 < ymax)
    v1 = wall_possible & disc_ok & (ymin < y1) & (y1 < ymax)
    t_lo, v_lo, t_hi, v_hi = _caps(o, d, ymin, ymax, capped, eps)
    return Hits(torch.stack([t0, t1, t_lo, t_hi], -1),
                torch.stack([v0, v1, v_lo, v_hi], -1))


def cone(o, d, ymin, ymax, capped, eps: float = EPSILON) -> Hits:
    """Double-napped unit cone along y (reference: src/shape.rs:356-398).
    A degenerate quadratic (|a| < eps) gives the single linear root
    t = -c/2b in slot 0, unbounded by the y range, as the reference."""
    ox, oy, oz = unpack3(o)
    dx, dy, dz = unpack3(d)
    a = dx * dx - dy * dy + dz * dz
    b = 2.0 * (ox * dx - oy * dy + oz * dz)
    c = ox * ox - oy * oy + oz * oz
    a_zero = torch.abs(a) < eps
    b_ok = torch.abs(b) >= eps
    t_lin = -c / torch.where(b_ok, 2.0 * b, 1.0)
    t0, t1, disc_ok = _quadratic(torch.where(a_zero, 1.0, a), b, c)
    t_sm = torch.minimum(t0, t1)
    t_lg = torch.maximum(t0, t1)
    y0 = oy + t_sm * dy
    y1 = oy + t_lg * dy
    v0_quad = ~a_zero & disc_ok & (ymin < y0) & (y0 < ymax)
    v1_quad = ~a_zero & disc_ok & (ymin < y1) & (y1 < ymax)
    slot0_t = torch.where(a_zero, t_lin, t_sm)
    slot0_v = torch.where(a_zero, b_ok, v0_quad)
    t_lo, v_lo, t_hi, v_hi = _caps(o, d, ymin, ymax, capped, eps)
    return Hits(torch.stack([slot0_t, t_lg, t_lo, t_hi], -1),
                torch.stack([slot0_v, v1_quad, v_lo, v_hi], -1))


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


def local_rays(inv, o, d):
    """Rays in each prim's object space: inv (N, 3, 4), o/d (R, 3) ->
    (R, N, 3) each, by component in affine3's order, as the prim kernel
    rounds them (a shared einsum is a cuBLAS product in the library's
    order)."""
    o3 = (c[:, None] for c in unpack3(o))
    d3 = (c[:, None] for c in unpack3(d))
    return affine3(inv, *o3), affine3(inv[..., :3], *d3)


def prims(inv, kind, params, o, d, eps: float = EPSILON) -> Hits:
    """(R, N, 4) candidate t and validity of every analytic prim of the
    tables inv (N, 3, 4), kind (N,) and params (N, 3) (ymin, ymax, capped)
    for rays o/d (R, 3): prim_slots on the rays in each prim's object
    space. The prim kernel's plain version: it evaluates each prim's own
    kind. Counted in PLAIN_SWEEPS."""
    PLAIN_SWEEPS["prims"] += 1
    return prim_slots(*local_rays(inv, o, d), kind, params, eps)


def prim_slots(o_l, d_l, kind, params, eps: float = EPSILON) -> Hits:
    """(..., 4) candidate t and validity of object-space rays o_l/d_l
    (..., 3) against prims whose kind (...) and params (..., 3) broadcast
    with them: (R, N, 3) rays and a table's (N,) kinds, or one prim a ray.
    Every kind runs on every prim, masked by kind, each padded to 4 slots
    with invalid zeros (rtc_tpu integrator :64-105)."""
    ymin, ymax = params[..., 0], params[..., 1]
    capped = params[..., 2] > 0.5

    def pad4(h: Hits):
        extra = h.t.shape[:-1] + (4 - h.t.shape[-1],)
        return Hits(torch.cat([h.t, h.t.new_zeros(extra)], -1),
                    torch.cat([h.valid, h.valid.new_zeros(extra)], -1))

    sp = pad4(sphere(o_l, d_l))
    pl = pad4(plane(o_l, d_l, eps))
    cu = pad4(cube(o_l, d_l, eps))
    cy = pad4(cylinder(o_l, d_l, ymin, ymax, capped, eps))
    co = pad4(cone(o_l, d_l, ymin, ymax, capped, eps))

    k = kind[..., None]
    t = torch.where(k == SPHERE, sp.t, 0.0)
    v = (k == SPHERE) & sp.valid
    for code, h in ((PLANE, pl), (CUBE, cu), (CYLINDER, cy), (CONE, co)):
        t = torch.where(k == code, h.t, t)
        v = torch.where(k == code, h.valid, v)
    return Hits(t, v)
