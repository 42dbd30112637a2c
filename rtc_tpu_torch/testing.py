"""The book's single-ray queries (counterpart of rtc_tpu/testing.py).

The reference tests Shape::intersect, Shape::normal_at, prepare_computations
and the World's shading one ray at a time (src/shape.rs:248,466,
src/intersection.rs:17-77, src/world.rs:56-163). These helpers ask the
same questions of the real compiled pipeline (compile_scene,
prim_candidates, prepare_hit, refraction_indices, color_at, schlick), so
the book's scalar tables check the production path, not a shadow of it.

Each helper takes dtype (torch.float64 by default, the book's precision)
and device. The device defaults to the card, as compile_scene's does, and
then raises without one; pass device="cpu" for the plain versions. In
float32 on the card the helpers run the kernels as a render does: on a
mesh world color_at_single launches K3 and is_shadowed K2.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import lighting as lighting_ops
from .ops import patterns as pattern_ops
from .render import integrator
from .scene.compile import compile_scene
from .scene.shapes import Shape
from .scene.world import World
from .utils.config import RenderConfig


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _config(dtype) -> RenderConfig:
    return RenderConfig(dtype=str(dtype).split(".")[-1])


def _rows(dtype, device, *values):
    """Each value as a one-row tensor."""
    return [torch.as_tensor(np.asarray([v], dtype=np.float64), dtype=dtype,
                            device=device) for v in values]


def _scene_for(shape: Shape, dtype, device):
    return compile_scene(World(objects=[shape]), dtype=dtype, device=device)


def intersect_shape(shape: Shape, origin, direction, dtype=torch.float64,
                    device="cuda"):
    """Every intersection t of a ray with one (possibly grouped) shape,
    sorted by t as the reference's group sort (src/shape.rs:431-432).
    Returns (ts, object_ids) numpy arrays, negative ts included (the
    reference's Vec keeps them; only hit() filters)."""
    scene = _scene_for(shape, dtype, device)
    o, d = _rows(dtype, device, origin, direction)
    xs = integrator.intersect_all(scene, o, d, _config(dtype))
    valid = _np(xs.valid[0])
    return (_np(xs.t[0]).astype(np.float64)[valid],
            _np(xs.obj[0]).astype(np.int64)[valid])


def normal_at(shape: Shape, point, dtype=torch.float64, device="cuda"):
    """Shape::normal_at through the compiled pipeline (src/shape.rs:466-519).
    The shape must compile to one prim or one triangle."""
    scene = _scene_for(shape, dtype, device)
    st = scene.static
    # a single triangle pads to one whole cluster; the real one stays at row 0
    if not (st.n_prims == 1 or (st.n_prims == 0 and st.n_tris >= 1)):
        raise ValueError("normal_at expects a shape of a single leaf")
    is_tri = st.n_prims == 0
    (p,) = _rows(dtype, device, point)
    i32 = dict(dtype=torch.int32, device=device)
    hit = integrator.HitInfo(
        t=p.new_zeros((1,)), valid=torch.ones((1,), dtype=torch.bool, device=device),
        obj=torch.zeros((1,), **i32), prim=torch.zeros((1,), **i32),
        tri=torch.zeros((1,), **i32),
        is_tri=torch.full((1,), is_tri, device=device),
        tri_n=scene.tri_n[0:1] if is_tri else p.new_zeros((1, 3)))
    return _np(integrator.normal_at(scene, hit, p.unbind(1), _config(dtype).epsilon))[0]


def hit(ts):
    """Intersection::hit: the index into ts of the lowest non-negative t,
    or None (src/intersection.rs:79-84)."""
    ts = np.asarray(ts, dtype=np.float64)
    idx = np.flatnonzero(ts >= 0.0)
    if not idx.size:
        return None
    return int(idx[np.argmin(ts[idx])])


def comps_at(scene, origin, direction, t, prim_id=0, is_tri=False, tri_id=0,
             obj_id=None, dtype=torch.float64, device="cuda", cfg=None):
    """prepare_computations at a chosen intersection (t, object): the
    reference's Intersection::prepare_computations(ray, xs), with xs
    implied by the scene (src/intersection.rs:17-77). Returns Comps of
    numpy values."""
    cfg = cfg or _config(dtype)
    o, d = _rows(dtype, device, origin, direction)
    t_parity = t
    if not is_tri and scene.static.n_prims:
        # The n1/n2 walk's strict `<` excludes the hit itself only when
        # t_hit IS one of the candidates, as it always is in production
        # (the reference matches on identity, src/intersection.rs:33): snap
        # t to the nearest candidate of the prim, bit for bit. The caller's
        # t stays for the geometric frame, as the book's tests pass
        # truncated values.
        ct, cv = integrator.prim_candidates(scene, o, d, cfg.epsilon)
        ct, cv = _np(ct[0, prim_id]), _np(cv[0, prim_id])
        if cv.any():
            cand = ct[cv]
            t_parity = float(cand[np.argmin(np.abs(cand - t))])
    if obj_id is None:
        obj_id = int((scene.tri_obj[tri_id] if is_tri else scene.prim_obj[prim_id]).item())

    def hit_at(tv):
        tri_n = (scene.tri_n[tri_id:tri_id + 1] if is_tri and scene.static.n_tris
                 else o.new_zeros((1, 3)))
        i32 = dict(dtype=torch.int32, device=device)
        return integrator.HitInfo(
            t=torch.tensor([tv], dtype=dtype, device=device),
            valid=torch.ones((1,), dtype=torch.bool, device=device),
            obj=torch.tensor([obj_id], **i32), prim=torch.tensor([prim_id], **i32),
            tri=torch.tensor([tri_id], **i32),
            is_tri=torch.tensor([is_tri], device=device), tri_n=tri_n)

    comps = integrator.prepare_hit(scene, o, d, hit_at(t), cfg)
    if t_parity != t:
        n1, n2 = integrator.refraction_indices(scene, o, d, hit_at(t_parity), cfg)
        comps = comps._replace(n1=n1, n2=n2)
    return integrator.Comps(*[_np(f)[0] for f in comps])


def color_at_single(scene, origin, direction, cfg=None, dtype=torch.float64,
                    device="cuda"):
    """World::color_at for one ray (src/world.rs:80-98)."""
    o, d = _rows(dtype, device, origin, direction)
    return _np(integrator.color_at(scene, o, d, cfg or _config(dtype)))[0]


def is_shadowed(scene, point, dtype=torch.float64, device="cuda", cfg=None):
    """World::is_shadowed (src/world.rs:100-114)."""
    (p,) = _rows(dtype, device, point)
    return bool(integrator.is_shadowed(scene, p, cfg or _config(dtype))[0].item())


def _material(scene, prim_id):
    """The object id of a prim, and its reflective and transparency."""
    obj = int(scene.prim_obj[prim_id].item())
    return (obj, float(scene.mat_reflective[obj].item()),
            float(scene.mat_transparency[obj].item()))


def _child_color(scene, origin, direction, remaining, dtype, device, cfg):
    """color_at of one secondary ray at budget remaining - 1."""
    o, d = _rows(dtype, device, origin, direction)
    return _np(integrator.color_at(scene, o, d, cfg, budget=remaining - 1))[0]


def reflected_color(scene, origin, direction, t, prim_id, remaining,
                    dtype=torch.float64, device="cuda", cfg=None):
    """World::reflected_color(comps, remaining) (src/world.rs:116-129)."""
    cfg = cfg or _config(dtype)
    comps = comps_at(scene, origin, direction, t, prim_id=prim_id, dtype=dtype,
                     device=device, cfg=cfg)
    _, reflective, _ = _material(scene, prim_id)
    if remaining < 1 or reflective == 0.0:
        return np.zeros(3)
    return _child_color(scene, comps.over_point, comps.reflectv, remaining, dtype,
                        device, cfg) * reflective


def refracted_color(scene, origin, direction, t, prim_id, remaining,
                    dtype=torch.float64, device="cuda", cfg=None):
    """World::refracted_color(comps, remaining) (src/world.rs:131-163)."""
    cfg = cfg or _config(dtype)
    comps = comps_at(scene, origin, direction, t, prim_id=prim_id, dtype=dtype,
                     device=device, cfg=cfg)
    _, _, transparency = _material(scene, prim_id)
    if remaining == 0 or transparency == 0.0:
        return np.zeros(3)
    n_ratio = comps.n1 / comps.n2
    cos_i = float(np.dot(comps.eyev, comps.normalv))
    sin2_t = n_ratio**2 * (1.0 - cos_i**2)
    if sin2_t > 1.0:
        return np.zeros(3)
    cos_t = float(np.sqrt(1.0 - sin2_t))
    direction_r = comps.normalv * (n_ratio * cos_i - cos_t) - comps.eyev * n_ratio
    return _child_color(scene, comps.under_point, direction_r, remaining, dtype,
                        device, cfg) * transparency


def shade_hit(scene, origin, direction, t, prim_id, remaining=5,
              dtype=torch.float64, device="cuda", cfg=None):
    """World::shade_hit(comps, remaining) (src/world.rs:56-78)."""
    cfg = cfg or _config(dtype)
    comps = comps_at(scene, origin, direction, t, prim_id=prim_id, dtype=dtype,
                     device=device, cfg=cfg)
    obj, reflective, transparency = _material(scene, prim_id)
    row = lambda name: getattr(scene, name)[obj:obj + 1]

    pinv = _np(scene.pat_inv[obj])
    kind = scene.pat_kind[obj:obj + 1]
    if int(kind.item()) == pattern_ops.NONE:
        base = row("mat_color")
    else:
        (pat_p,) = _rows(dtype, device, pinv[:, :3] @ comps.point + pinv[:, 3])
        base = pattern_ops.color_at(pat_p, kind, row("pat_a"), row("pat_b"))
    shadowed = is_shadowed(scene, comps.over_point, dtype=dtype, device=device,
                           cfg=cfg)
    point, eyev, normalv = _rows(dtype, device, comps.point, comps.eyev, comps.normalv)
    surface = _np(lighting_ops.lighting(
        base, row("mat_ambient"), row("mat_diffuse"), row("mat_specular"),
        row("mat_shininess"), scene.light_pos, scene.light_intensity, point, eyev,
        normalv, torch.tensor([shadowed], device=device)))[0]

    reflected = reflected_color(scene, origin, direction, t, prim_id, remaining - 1,
                                dtype=dtype, device=device, cfg=cfg)
    refracted = refracted_color(scene, origin, direction, t, prim_id, remaining - 1,
                                dtype=dtype, device=device, cfg=cfg)
    if reflective > 0.0 and transparency > 0.0:
        cos, n1, n2 = _rows(dtype, device, np.dot(comps.eyev, comps.normalv),
                            comps.n1, comps.n2)
        r = float(integrator.schlick(cos, n1, n2)[0].item())
        return surface + reflected * r + refracted * (1.0 - r)
    return surface + reflected + refracted
