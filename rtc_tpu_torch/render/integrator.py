"""Wavefront Whitted integrator, main-path subset (counterpart of
rtc_tpu/render/integrator.py).

The reference recurses per pixel (src/world.rs:80-163); here each node of
the statically unrolled bounce tree shades a whole wavefront of rays. With
the reference's budget semantics each secondary ray costs 3 budget, so
RECURSION_LIMIT = 5 yields two shading levels (primary + one reflection).

Ported: flat triangle meshes with shadows and reflection. Masked lanes
carry finite dummy values, and dead lanes are parked outside every box so
the kernels' traversal drops them at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import lighting
from ..ops.kernels import mesh_intersect as mi
from ..ops.vec import normalize3, pack3, unpack3
from ..scene.compile import Scene
from ..utils.config import RenderConfig
from ..utils.constants import BIG, FAR, PARK


class HitInfo(NamedTuple):
    t: torch.Tensor        # (R,) hit time (BIG on a miss)
    valid: torch.Tensor    # (R,) bool
    obj: torch.Tensor      # (R,) i32 object id (0 on a miss)
    tri: torch.Tensor      # (R,) i32 triangle id (0 on a miss)
    tri_n: torch.Tensor    # (R, 3) the winning triangle's world normal


def _resolve_mesh_impl(scene: Scene, cfg: RenderConfig, x) -> str:
    """'kernel' or 'bruteforce' for rays x. 'auto' takes the kernels for
    f32 tensors on CUDA and the dense sweep otherwise; an explicit
    'kernel' on a CPU or f64 tensor raises."""
    impl = cfg.mesh_impl
    if impl == "auto":
        impl = ("kernel" if scene.static.n_clusters and x.is_cuda
                and x.dtype == torch.float32 else "bruteforce")
    if impl == "kernel" and not scene.static.n_clusters:
        impl = "bruteforce"
    if impl == "kernel" and not (x.is_cuda and x.dtype == torch.float32):
        raise ValueError(
            "mesh_impl='kernel' runs the CUDA kernels, which take float32 "
            f"tensors on a CUDA device (got {x.dtype} on {x.device})")
    return impl


def _use_fused_shadow(scene: Scene, cfg: RenderConfig, impl: str) -> bool:
    """Fused closest+shadow eligibility: kernel backend, shadows on, a
    pure-mesh scene. (rtc_tpu also asks that the mesh fit one VMEM block;
    the card has no such budget.)"""
    return (cfg.fused_shadow and cfg.shadows and impl == "kernel"
            and scene.static.n_prims == 0 and scene.static.n_tris > 0)


def mesh_closest(scene: Scene, o, d, cfg: RenderConfig):
    """Closest triangle hit: (t, idx, n); t == BIG, idx == 0 and n == 0 on
    a miss. 'kernel' launches K1; 'bruteforce' is the dense sweep."""
    if _resolve_mesh_impl(scene, cfg, o) == "kernel":
        t, idx, n = mi.mesh_closest_hit(
            o, d, scene.tri_p1, scene.tri_e1, scene.tri_e2, scene.tri_n,
            scene.cluster_aabb, scene.static.cluster_size, cfg.epsilon)
    else:
        t, idx, n = mi.closest_hit_plain(
            o, d, scene.tri_p1, scene.tri_e1, scene.tri_e2, scene.tri_n,
            cfg.epsilon)
    return t, idx.clamp_min(0), n


def _hit_info(scene: Scene, t, idx, n) -> HitInfo:
    st = scene.static
    if st.single_tri_obj >= 0:
        # single-mesh scene: every triangle shares one object id
        obj = torch.full_like(idx, st.single_tri_obj)
    else:
        obj = scene.tri_obj[idx.long()]
    return HitInfo(t=t, valid=t < BIG * 0.5, obj=obj, tri=idx, tri_n=n)


def closest_hit(scene: Scene, o, d, cfg: RenderConfig) -> HitInfo:
    """World::intersect + Intersection::hit: the global min over t >= 0
    (reference: src/world.rs:43-54, src/intersection.rs:79-84)."""
    return _hit_info(scene, *mesh_closest(scene, o, d, cfg))


def is_shadowed(scene: Scene, point, cfg: RenderConfig, live=None):
    """Shadow ray toward the light (reference: src/world.rs:100-114).

    `hit().t < distance` is "any candidate t in [0, distance)", which the
    any-hit kernel answers without min bookkeeping. live: optional (R,)
    bool; dead lanes get max_t = -1 and report unshadowed.
    """
    px, py, pz = unpack3(point)
    lx, ly, lz = scene.light_pos.unbind(0)
    vx, vy, vz = lx - px, ly - py, lz - pz
    distance = torch.sqrt(torch.clamp_min(vx * vx + vy * vy + vz * vz, 1e-30))
    direction = pack3(vx / distance, vy / distance, vz / distance)
    if live is not None:
        distance = torch.where(live, distance, -1.0)
    if _resolve_mesh_impl(scene, cfg, point) == "kernel":
        return mi.mesh_any_hit(
            point, direction, distance, scene.tri_p1, scene.tri_e1,
            scene.tri_e2, scene.cluster_aabb, scene.static.cluster_size,
            cfg.epsilon)
    return mi.any_hit_plain(point, direction, distance, scene.tri_p1,
                            scene.tri_e1, scene.tri_e2, cfg.epsilon)


def object_record(scene: Scene, obj):
    """One fused gather of the per-object shading data: (R,) columns."""
    tbl = torch.cat([
        scene.mat_color,                    # 0:3
        scene.mat_ambient[:, None],         # 3
        scene.mat_diffuse[:, None],         # 4
        scene.mat_specular[:, None],        # 5
        scene.mat_shininess[:, None],       # 6
        scene.mat_reflective[:, None],      # 7
        scene.mat_transparency[:, None],    # 8
        scene.mat_ior[:, None],             # 9
    ], dim=1)
    if scene.static.n_objects == 1:
        g = tbl[0].expand(obj.shape[0], tbl.shape[1])
    else:
        g = tbl[obj.long()]
    return dict(color=g[:, 0:3], ambient=g[:, 3], diffuse=g[:, 4],
                specular=g[:, 5], shininess=g[:, 6], reflective=g[:, 7],
                transparency=g[:, 8], ior=g[:, 9])


class Comps3(NamedTuple):
    """Component shading frame (reference: src/intersection.rs:17-77):
    every 3-vector is a tuple of three (R,) tensors. n1/n2 (refraction)
    are not ported yet."""

    point: tuple
    eyev: tuple
    normalv: tuple         # flipped toward the eye when inside
    inside: torch.Tensor
    over_point: tuple
    reflectv: tuple


def prepare_hit3(o, d, hit: HitInfo, cfg: RenderConfig) -> Comps3:
    """The shading frame of a wavefront of hits on a pure-mesh scene
    (rtc_tpu prepare_hit3 with need_refraction=False). Misses carry finite
    dummies; callers mask on hit.valid. Every formula keeps rtc_tpu's
    association order."""
    eps = cfg.epsilon
    t_safe = torch.where(hit.valid, hit.t, 1.0)
    ox, oy, oz = unpack3(o)
    dx, dy, dz = unpack3(d)
    px, py, pz = ox + dx * t_safe, oy + dy * t_safe, oz + dz * t_safe
    ex, ey, ez = -dx, -dy, -dz
    nx, ny, nz = unpack3(hit.tri_n)
    inside = (nx * ex + ny * ey + nz * ez) < 0.0
    nx = torch.where(inside, -nx, nx)
    ny = torch.where(inside, -ny, ny)
    nz = torch.where(inside, -nz, nz)
    k = 2.0 * (dx * nx + dy * ny + dz * nz)
    return Comps3(
        point=(px, py, pz),
        eyev=(ex, ey, ez),
        normalv=(nx, ny, nz),
        inside=inside,
        over_point=(px + nx * eps, py + ny * eps, pz + nz * eps),
        reflectv=(dx - nx * k, dy - ny * k, dz - nz * k),
    )


def color_at(scene: Scene, o, d, cfg: RenderConfig, budget: int | None = None):
    """Whole-wavefront color (reference: src/world.rs:80-98). o/d: (R, 3)."""
    if budget is None:
        budget = cfg.max_depth
    st = scene.static
    if budget < 1 or st.n_objects == 0:
        return torch.zeros_like(o)

    impl = _resolve_mesh_impl(scene, cfg, o)
    shadowed = None
    if _use_fused_shadow(scene, cfg, impl):
        # one K3 launch: closest hit + the in-register shadow query
        t, idx, n, shadowed = mi.mesh_closest_shadow(
            o, d, scene.tri_p1, scene.tri_e1, scene.tri_e2, scene.tri_n,
            scene.cluster_aabb, scene.light_pos, st.cluster_size, cfg.epsilon)
        hit = _hit_info(scene, t, idx.clamp_min(0), n)
    else:
        hit = closest_hit(scene, o, d, cfg)
    valid = hit.valid
    rec = object_record(scene, hit.obj)
    comps = prepare_hit3(o, d, hit, cfg)
    px, py, pz = comps.point
    nx, ny, nz = comps.normalv
    ovx, ovy, ovz = (torch.where(valid, c, FAR) for c in comps.over_point)

    if shadowed is None and cfg.shadows:
        # occlusion matters only where the surface faces the light
        # (lighting zeroes diffuse+specular when light.normal < 0,
        # src/material.rs:57-67): back-facing lanes leave the sweep
        lx, ly, lz = scene.light_pos.unbind(0)
        lvx, lvy, lvz = normalize3(lx - px, ly - py, lz - pz)
        facing = (lvx * nx + lvy * ny + lvz * nz) >= 0.0
        shadowed = is_shadowed(scene, pack3(ovx, ovy, ovz), cfg,
                               live=valid & facing)
    elif shadowed is None:
        shadowed = torch.zeros_like(valid)
    surface = lighting.lighting3(
        rec["color"], rec["ambient"], rec["diffuse"], rec["specular"],
        rec["shininess"], scene.light_pos, scene.light_intensity,
        comps.point, comps.eyev, comps.normalv, shadowed)

    refl = torch.zeros_like(o)
    if budget >= 4 and st.any_reflective:  # children shade iff budget-3 >= 1
        # (src/intersection.rs:27, world.rs:125); lanes that spawn no ray
        # are parked pointing away from the scene (src/world.rs:117-119)
        reflective = rec["reflective"]
        live = valid & (reflective > 0.0)
        rvx, rvy, rvz = comps.reflectv
        refl = color_at(
            scene,
            pack3(*(torch.where(live, c, FAR) for c in (ovx, ovy, ovz))),
            pack3(*(torch.where(live, c, PARK) for c in (rvx, rvy, rvz))),
            cfg, budget - 3,
        ) * reflective[:, None]

    return torch.where(valid[:, None], surface + refl, 0.0)
