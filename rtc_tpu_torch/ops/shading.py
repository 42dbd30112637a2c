"""A bounce node's shading, a ray at a time: the plain versions of the
shading kernels (csrc/mesh_intersect.cu shade_kernel; wrappers
ops/kernels/mesh_intersect.py shade_surface, shade_node, shade_blend).
Counterpart of the shading half of rtc_tpu/render/integrator.py
(:1114-1160, :1185-1262); reference src/world.rs:80-163.

render/integrator.py color_at shades a node in three stages around the
searches that only it can launch:

  shade_surface  after the closest hit: the hit's frame (surface_frame)
                 and its shadow query toward the light, parked where the
                 lane is dead (surface)
  shade_node     after the shadow flag and the n1/n2 census: the base
                 colour (the object's pattern), Phong under the shadow
                 flag, and where the node can branch the children's
                 parked rays and their weights (node); a node with no
                 child returns its final colour
  shade_blend    after the children return: the Schlick blend of their
                 colours onto the surface colour (blend)

Every formula keeps rtc_tpu's association order (ops/vec.py); the
kernels round each operation as these functions do, so they equal them
bit for bit. These functions are differentiable: the autograd path and
the CPU shade with them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..scene.materials import NONE
from ..utils.constants import FAR, PARK
from . import lighting, normals, patterns
from .intersect import CONE, CUBE, CYLINDER, PLANE
from .vec import affine3, normalize, normalize3, pack3, safe_sqrt, unpack3


class HitInfo(NamedTuple):
    t: torch.Tensor        # (R,) hit time (BIG on a miss)
    valid: torch.Tensor    # (R,) bool
    obj: torch.Tensor      # (R,) i32 object id (0 on a miss)
    prim: torch.Tensor     # (R,) analytic prim id (0 unless a prim won)
    tri: torch.Tensor      # (R,) i32 triangle id (0 on a miss)
    is_tri: torch.Tensor   # (R,) bool: a triangle won
    tri_n: torch.Tensor    # (R, 3) the winning triangle's unit world normal


class Prims(NamedTuple):
    """The analytic prims' rows a normal reads (N >= 1)."""
    inv: torch.Tensor      # (N, 3, 4) world -> object
    invT: torch.Tensor     # (N, 3, 3) inverse-transpose linear part
    kind: torch.Tensor     # (N,) i32, intersect.SPHERE .. CONE
    params: torch.Tensor   # (N, 3) ymin, ymax, capped


class Objects(NamedTuple):
    """The objects' rows a node's shading reads, (O, ...) each; Scene's
    fields of the same meaning (OBJECT_FIELDS)."""
    pat_kind: torch.Tensor      # (O,) i32, materials.NONE .. TEST
    pat_a: torch.Tensor         # (O, 3)
    pat_b: torch.Tensor         # (O, 3)
    pat_inv: torch.Tensor       # (O, 3, 4) pattern_inv @ object_inv
    color: torch.Tensor         # (O, 3)
    ambient: torch.Tensor       # (O,)
    diffuse: torch.Tensor
    specular: torch.Tensor
    shininess: torch.Tensor
    reflective: torch.Tensor
    transparency: torch.Tensor


# the Scene field of each Objects entry
OBJECT_FIELDS = ("pat_kind", "pat_a", "pat_b", "pat_inv", "mat_color", "mat_ambient",
                 "mat_diffuse", "mat_specular", "mat_shininess", "mat_reflective",
                 "mat_transparency")


class Frame(NamedTuple):
    """prepare_computations without n1/n2 (src/intersection.rs:17-77), in
    component form: each 3-vector a tuple of three (R,) tensors."""
    point: tuple
    eyev: tuple
    normalv: tuple         # flipped toward the eye when inside
    inside: torch.Tensor
    over_point: tuple
    under_point: tuple
    reflectv: tuple


class Node(NamedTuple):
    """What shade_node gives: color, the surface colour, or the node's
    final colour where it has no child (refl and refr None); refl and
    refr, each child's parked rays (o, d) or None; weights, the blend's
    (reflective, transparency, 1 - tir, Schlick's reflectance): a tuple
    of (R,) tensors (None where unused) or the kernel's (R, 4); factors,
    where asked for, the (R, 4) partials of color that its backward reads
    (node, factors=True)."""
    color: torch.Tensor
    refl: tuple | None
    refr: tuple | None
    weights: tuple | torch.Tensor | None
    factors: torch.Tensor | None = None


def hit_normal(prims: Prims | None, hit, world_point, eps):
    """World-space unit normal at the hit (reference: src/shape.rs:466-519):
    the triangle's from closest-hit time, else the prim's, through its
    inverse-transpose. world_point: its (R,) components. Both products with
    the hit prim's matrices are affine3's, by component: an einsum would
    run a cuBLAS batched gemv over one 3x3 a ray."""
    if prims is None:
        return hit.tri_n
    p = hit.prim.long()
    inv, invT = prims.inv[p], prims.invT[p]
    params, kind = prims.params[p], prims.kind[p]
    p_l = affine3(inv, *world_point)
    n_l = normals.sphere(p_l)
    n_l = torch.where((kind == PLANE)[:, None], normals.plane(p_l), n_l)
    n_l = torch.where((kind == CUBE)[:, None], normals.cube(p_l), n_l)
    n_l = torch.where((kind == CYLINDER)[:, None],
                      normals.cylinder(p_l, params[:, 0], params[:, 1], eps), n_l)
    n_l = torch.where((kind == CONE)[:, None], normals.cone(p_l), n_l)
    n_p = normalize(affine3(invT, *unpack3(n_l)))
    return torch.where(hit.is_tri[:, None], hit.tri_n, n_p)


def surface_frame(o, d, hit, prims: Prims | None, eps) -> Frame:
    """The shading frame of a wavefront of hits (rtc_tpu :1114-1160).
    Misses carry finite dummies; callers mask on hit.valid."""
    t_safe = torch.where(hit.valid, hit.t, 1.0)
    ox, oy, oz = unpack3(o)
    dx, dy, dz = unpack3(d)
    px, py, pz = ox + dx * t_safe, oy + dy * t_safe, oz + dz * t_safe
    ex, ey, ez = -dx, -dy, -dz
    nx, ny, nz = unpack3(hit_normal(prims, hit, (px, py, pz), eps))
    inside = (nx * ex + ny * ey + nz * ez) < 0.0
    nx = torch.where(inside, -nx, nx)
    ny = torch.where(inside, -ny, ny)
    nz = torch.where(inside, -nz, nz)
    k = 2.0 * (dx * nx + dy * ny + dz * nz)
    return Frame(
        point=(px, py, pz),
        eyev=(ex, ey, ez),
        normalv=(nx, ny, nz),
        inside=inside,
        over_point=(px + nx * eps, py + ny * eps, pz + nz * eps),
        under_point=(px - nx * eps, py - ny * eps, pz - nz * eps),
        reflectv=(dx - nx * k, dy - ny * k, dz - nz * k),
    )


def shadow_query(point, light_pos, live=None):
    """is_shadowed's query from each point (R, 3) toward the light:
    (unit direction (R, 3), distance (R,)), the distance -1 on dead lanes
    (live False), which never report a hit."""
    px, py, pz = unpack3(point)
    lx, ly, lz = light_pos.unbind(0)
    vx, vy, vz = lx - px, ly - py, lz - pz
    distance = torch.sqrt(torch.clamp_min(vx * vx + vy * vy + vz * vz, 1e-30))
    direction = pack3(vx / distance, vy / distance, vz / distance)
    if live is not None:
        distance = torch.where(live, distance, -1.0)
    return direction, distance


def surface(o, d, hit, prims: Prims | None, light_pos, eps, frame: Frame | None = None):
    """shade_surface's plain version: the shadow query of each hit, from
    its over point (FAR on a miss) toward the light, live where the hit is
    valid and its surface faces the light (lighting zeroes diffuse and
    specular when light . normal < 0, src/material.rs:57-67, so
    back-facing lanes leave the sweep): (origin (R, 3), direction (R, 3),
    distance (R,)), the distance -1 on a dead lane. frame: the hits'
    surface_frame, where the caller has it."""
    fr = surface_frame(o, d, hit, prims, eps) if frame is None else frame
    px, py, pz = fr.point
    nx, ny, nz = fr.normalv
    over = pack3(*(torch.where(hit.valid, c, FAR) for c in fr.over_point))
    lx, ly, lz = light_pos.unbind(0)
    lvx, lvy, lvz = normalize3(lx - px, ly - py, lz - pz)
    facing = (lvx * nx + lvy * ny + lvz * nz) >= 0.0
    return (over, *shadow_query(over, light_pos, live=hit.valid & facing))


def schlick(cos_eye_normal, n1, n2):
    """Fresnel approximation (reference: src/intersection.rs:107-128)."""
    cos = cos_eye_normal
    n = n1 / n2
    sin2_t = n * n * (1.0 - cos * cos)
    tir = (n1 > n2) & (sin2_t > 1.0)
    cos_t = safe_sqrt(1.0 - torch.clamp_max(sin2_t, 1.0))
    cos_used = torch.where(n1 > n2, cos_t, cos)
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    reflectance = r0 + (1.0 - r0) * (1.0 - cos_used) ** 5
    return torch.where(tir, 1.0, reflectance)


def park(live, o3, d3):
    """Packed secondary rays, with the lanes that spawn none parked
    pointing away from the scene (src/world.rs:117-119,132-134)."""
    return (pack3(*(torch.where(live, c, FAR) for c in o3)),
            pack3(*(torch.where(live, c, PARK) for c in d3)))


def object_rows(objects: Objects, obj) -> dict:
    """Each Objects entry's rows of the rays' objects obj (R,), by name."""
    idx = obj.long()
    return {k: x.index_select(0, idx) for k, x in zip(Objects._fields, objects)}


def node(o, d, hit, shadowed, n1, n2, prims: Prims | None, rec: dict, light_pos,
         light_intensity, eps, branch_r: bool, branch_t: bool, blend: bool,
         pattern: bool, frame: Frame | None = None, factors: bool = False) -> Node:
    """shade_node's plain version on the rays' object rows rec (an entry
    of Objects' names each, (R, ...); object_rows): the base colour (the
    object's pattern in pattern space where pattern, the scene has one),
    Phong under shadowed ((R,) bool, None: lit), and the children where
    the node branches: branch_r, the reflection from the over point;
    branch_t, Snell's refraction from the under point with n1/n2 (R,) the
    census's. n1 and n2 None: 1 (a node that cannot branch reads no
    census). blend: the scene is reflective and refractive, so the
    children meet in the Schlick blend. A node with neither child returns
    its final colour (blend with no child). frame: the hits'
    surface_frame, where the caller has it. factors: the kernel's grad
    instance, with Node.factors: the colour
    is bilinear in the object's colour row and the light's intensity, and
    the factors are its partials, a ray's column 0 that of the row (a,
    ambient plus the diffuse term where lit; 0 where a pattern gives the
    base colour) and columns 1-3 that of the intensity (base * a plus the
    specular term where lit), 0 where a childless node's hit is not
    valid."""
    fr = surface_frame(o, d, hit, prims, eps) if frame is None else frame
    valid = hit.valid
    ex, ey, ez = fr.eyev
    nx, ny, nz = fr.normalv
    if pattern:
        # pattern space: one affine per object (pattern_inv @ object_inv),
        # by component (affine3): an einsum is a cuBLAS batched gemv
        pat_p = affine3(rec["pat_inv"], *fr.point)
        pat_kind = rec["pat_kind"]
        base_color = torch.where(
            (pat_kind == NONE)[:, None], rec["color"],
            patterns.color_at(pat_p, pat_kind, rec["pat_a"], rec["pat_b"]))
    else:
        base_color = rec["color"]
    if shadowed is None:
        shadowed = torch.zeros_like(valid)
    surface_color = lighting.lighting3(
        base_color, rec["ambient"], rec["diffuse"], rec["specular"], rec["shininess"],
        light_pos, light_intensity, fr.point, fr.eyev, fr.normalv, shadowed)
    if n1 is None:
        n1 = n2 = torch.ones(o.shape[:1], dtype=o.dtype, device=o.device)

    reflective, transparency = rec["reflective"], rec["transparency"]
    refl = refr = notir = reflectance = None
    if branch_r:  # (src/intersection.rs:27, world.rs:125)
        over = tuple(torch.where(valid, c, FAR) for c in fr.over_point)
        refl = park(valid & (reflective > 0.0), over, fr.reflectv)
    if branch_t:
        # Snell construction (reference: src/world.rs:140-162)
        n_ratio = n1 / n2
        cos_i = ex * nx + ey * ny + ez * nz
        sin2_t = n_ratio * n_ratio * (1.0 - cos_i * cos_i)
        tir = sin2_t > 1.0
        cos_t = safe_sqrt(1.0 - torch.clamp_max(sin2_t, 1.0))
        a = n_ratio * cos_i - cos_t
        refr_d = (nx * a - ex * n_ratio, ny * a - ey * n_ratio,
                  nz * a - ez * n_ratio)
        under = tuple(torch.where(valid, c, FAR) for c in fr.under_point)
        refr = park(valid & (transparency > 0.0) & ~tir, under, refr_d)
        notir = (~tir).to(o.dtype)
    if blend:
        # the Schlick blend, only where the material is both
        # (src/world.rs:71-77)
        reflectance = schlick(ex * nx + ey * ny + ez * nz, n1, n2)
    weights = (reflective, transparency, notir, reflectance)
    leaf = refl is None and refr is None
    fac = None
    if factors:
        lit, dl, spec_on, sf = lighting.phong_terms(
            rec["diffuse"], rec["specular"], rec["shininess"],
            unpack3(light_pos.expand_as(base_color)), fr.point, fr.eyev, fr.normalv, shadowed)
        a = rec["ambient"] + torch.where(lit, dl, 0.0)
        own = torch.where(rec["pat_kind"] == NONE, a, 0.0) if pattern else a
        fac = torch.cat([own[:, None],
                         base_color * a[:, None] + torch.where(spec_on, sf, 0.0)[:, None]], 1)
        if leaf:
            fac = torch.where(valid[:, None], fac, 0.0)
    if leaf:
        return Node(blend_colors(valid, surface_color, None, None, weights, blend),
                    None, None, None, fac)
    return Node(surface_color, refl, refr, weights, fac)


def blend_colors(valid, surface_color, refl_color, refr_color, weights, blend: bool):
    """shade_blend's plain version: the node's colour from its surface
    colour (R, 3) and its children's colours (R, 3) (None: no such child),
    weighted by weights (Node.weights; an (R, 4) tensor is unbound), in
    the Schlick blend where blend and the material is both; 0 on a miss."""
    reflective, transparency, notir, reflectance = (
        weights.unbind(1) if torch.is_tensor(weights) else weights)
    refl = (torch.zeros_like(surface_color) if refl_color is None
            else refl_color * reflective[:, None])
    refr = (torch.zeros_like(surface_color) if refr_color is None
            else refr_color * transparency[:, None] * notir[:, None])
    if blend:
        both = (reflective > 0.0) & (transparency > 0.0)
        secondary = torch.where(
            both[:, None],
            refl * reflectance[:, None] + refr * (1.0 - reflectance)[:, None],
            refl + refr)
    else:
        secondary = refl + refr
    return torch.where(valid[:, None], surface_color + secondary, 0.0)
