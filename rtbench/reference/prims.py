"""The plain reference with the book's cube and stripe pattern: tracer.py's
Whitted integrator (world.rs color_at, shade_hit, is_shadowed,
reflected_color, refracted_color; intersection.rs prepare_computations
and schlick; material.rs lighting), in plain torch, vectorised over rays,
for a configuration whose objects are meshes, planes and cubes, and whose
patterns are checkers and stripes. tracer.py's meshes and planes are
tested as there; its helpers that know no object kind (the triangle
features, the bounds' slab test, the n1/n2 stack, Schlick) are imported
from it.

The additions, each as the book has it:
  cube     the slab test in object space (shape.rs:283-319, check_axis
           :587-606): both crossings (tmin, tmax) of the +-1 box, valid
           where tmax >= tmin; a direction component under EPSILON is
           parallel to its slab, which is then the whole line where the
           origin lies inside the slab and empty outside it. The normal is
           the face of the largest |component| of the object-space point,
           ties broken x, then y, then z (shape.rs:472-486).
  stripe   a if floor(x) of the pattern-space point is even, else b
           (pattern.rs:70-76).

Departures from the book, the framework's documented extensions as in
tracer.py: the stripe and checkers patterns nudge their coordinate by
PATTERN_EPS before flooring; smooth meshes interpolate per-corner
normals; a mesh is one container of the n1/n2 walk (crossing parity),
and a cube container counts both of its crossings before the hit,
negative t included, as a mesh counts its triangles; `containers` names
which objects the walk enrols ("all": every object, as the book;
"refractive": objects with a refractive index other than 1 or any
transparency). An object outside the walk takes no part in n1/n2, which
only a transparent hit reads.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from . import geometry as G
from .obj import read_obj, vertex_normals
from .precision import mm
from .tracer import (CHUNK_BYTES, EPSILON, MATERIAL, PAIR_MATRICES, PATTERN_EPS, Hits,
                     Node, Obj, _dot, _line_meets_box, _schlick, _spread, _to_object, _top,
                     triangle_features)

KINDS = ("mesh", "plane", "cube")
PATTERNS = ("checkers", "stripe")


class Scene:
    """A configuration's scene in dtype on device: objects in the order
    the file lists them, the material tables by object, the light."""

    def __init__(self, config: dict, root: str, dtype=torch.float64, device="cpu"):
        self.dtype, self.device = dtype, device
        t = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)
        self.objects, mats, self.patterns = [], [], []
        for spec in config["objects"]:
            if spec["kind"] not in KINDS:
                raise ValueError(f"the reference has no {spec['kind']!r} object")
            inv = np.linalg.inv(G.compose(spec.get("transform")))
            obj = Obj(spec["kind"], t(inv[:3, :3]), t(inv[:3, 3]))
            if obj.kind == "mesh":
                verts, faces = read_obj(os.path.join(root, spec["file"]))
                p1, p2, p3 = (verts[faces[:, c]] for c in range(3))
                obj.feats, obj.normals = (t(x) for x in triangle_features(p1, p2, p3))
                lo, hi = verts.min(0), verts.max(0)
                pad = 1e-6 * (hi - lo).max() + 1e-9
                obj.box = t(np.stack([lo - pad, hi + pad]))
                if spec.get("smooth"):
                    vn = vertex_normals(verts, faces)
                    obj.corners = t(np.stack([vn[faces[:, c]] for c in range(3)]))
            self.objects.append(obj)
            mat = {**MATERIAL, **spec.get("material", {})}
            mats.append(mat)
            pat = mat.get("pattern")
            if pat is not None and pat["kind"] not in PATTERNS:
                raise ValueError(f"the reference has no {pat['kind']!r} pattern")
            if pat is not None:
                pinv = np.linalg.inv(G.compose(pat.get("transform")))
                pat = (pat["kind"], t(pinv[:3, :3]), t(pinv[:3, 3]), t(pat["a"]), t(pat["b"]))
            self.patterns.append(pat)
        col = lambda k: t([m[k] for m in mats])
        self.color = col("color")
        self.ambient, self.diffuse, self.specular = col("ambient"), col("diffuse"), col("specular")
        self.shininess, self.reflective = col("shininess"), col("reflective")
        self.transparency, self.ior = col("transparency"), col("refractive_index")
        light = config["light"]
        self.light_pos, self.intensity = t(light["position"]), t(light["intensity"])
        rule = config["render"]["containers"]
        self.containers = [k for k, m in enumerate(mats) if rule == "all"
                           or m["refractive_index"] != 1.0 or m["transparency"] > 0.0]
        self.census = bool(self.containers) and any(m["transparency"] > 0 for m in mats)
        n_tris = sum(o.normals.shape[0] for o in self.objects if o.kind == "mesh")
        budget = CHUNK_BYTES[torch.device(device).type]
        self.chunk = max(1, budget // (PAIR_MATRICES * max(n_tris, 1)
                                       * self.transparency.element_size()))


def _slab(o1, d1):
    """The +-1 slab of one axis: (tmin, tmax) of the line o1 + t d1."""
    lo, hi = -1.0 - o1, 1.0 - o1
    flat = d1.abs() < EPSILON
    safe = torch.where(flat, 1.0, d1)
    a, b = lo / safe, hi / safe
    inf = torch.full_like(lo, float("inf"))
    tmin = torch.where(flat, torch.where(lo <= 0.0, -inf, inf), torch.minimum(a, b))
    tmax = torch.where(flat, torch.where(hi >= 0.0, inf, -inf), torch.maximum(a, b))
    return tmin, tmax


def _cube(oo, dd):
    """(R, 2) crossings (tmin, tmax) of the object-space rays with the
    +-1 cube, inf where a ray misses it."""
    slabs = [_slab(oo[:, k], dd[:, k]) for k in range(3)]
    tmin = torch.stack([s[0] for s in slabs], 1).amax(1)
    tmax = torch.stack([s[1] for s in slabs], 1).amin(1)
    t = torch.stack([tmin, tmax], 1)
    return torch.where((tmax >= tmin)[:, None], t, float("inf"))


def _crossings(obj: Obj, o, d):
    """Every intersection of the rays with obj: (sel, t, u, v), t, u and v
    (len(sel), n) for the rays sel (n: 1 for a plane, 2 for a cube, T for
    a mesh), t inf where a ray misses. sel is None for every ray; for a
    mesh it is the rays whose line meets its bounds, the only ones that
    can cross it."""
    oo, dd = _to_object(obj, o, d)
    inf = torch.tensor(float("inf"), dtype=o.dtype, device=o.device)
    if obj.kind == "plane":
        ok = dd[:, 1].abs() >= EPSILON
        t = torch.where(ok, -oo[:, 1] / torch.where(ok, dd[:, 1], 1.0), inf)[:, None]
        return None, t, torch.zeros_like(t), torch.zeros_like(t)
    if obj.kind == "cube":
        t = _cube(oo, dd)
        return None, t, torch.zeros_like(t), torch.zeros_like(t)
    sel = torch.nonzero(_line_meets_box(obj.box, oo, dd))[:, 0]
    oo, dd = oo[sel], dd[sel]
    n = obj.normals.shape[0]
    f = torch.cat([dd, torch.linalg.cross(oo, dd), oo, torch.ones_like(dd[:, :1])], 1)
    x = mm(f, obj.feats)
    det, ud, vd, td = x[:, :n], x[:, n:2 * n], x[:, 2 * n:3 * n], x[:, 3 * n:]
    ok = det.abs() >= EPSILON
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    u, v = inv * ud, inv * vd
    ok &= (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    return sel, torch.where(ok, inv * td, inf), u, v


def _closest_chunk(scene: Scene, o, d) -> Hits:
    r = o.shape[0]
    best = torch.full((r,), float("inf"), dtype=o.dtype, device=o.device)
    obj = torch.full((r,), -1, dtype=torch.long, device=o.device)
    row = torch.zeros_like(obj)
    u, v = torch.zeros_like(best), torch.zeros_like(best)
    crossings = {}
    for k, ob in enumerate(scene.objects):
        sel, t, uu, vv = _crossings(ob, o, d)
        tmin, rmin = torch.where(t >= 0.0, t, float("inf")).min(1)
        uu, vv = (x.gather(1, rmin[:, None])[:, 0] for x in (uu, vv))
        tmin, rmin, uu, vv = (_spread(sel, x, r, f) for x, f in
                              ((tmin, float("inf")), (rmin, 0), (uu, 0.0), (vv, 0.0)))
        better = tmin < best  # a tie keeps the earlier object, as the book's stable sort
        best = torch.where(better, tmin, best)
        obj = torch.where(better, k, obj)
        row = torch.where(better, rmin, row)
        u = torch.where(better, uu, u)
        v = torch.where(better, vv, v)
        if scene.census and k in scene.containers:
            crossings[k] = (sel, t)
    n1 = n2 = torch.ones_like(best)
    if scene.census:
        # the n1/n2 walk over every intersection before the hit (negative t
        # included): a container is inside on odd crossings, and the one
        # entered last is on top of the list
        count, last = [], []
        for k in scene.containers:
            sel, t = crossings[k]
            before = t < (best if sel is None else best[sel])[:, None]
            count.append(_spread(sel, before.sum(1), r, 0))
            last.append(_spread(sel, torch.where(before, t, -float("inf")).amax(1), r,
                                -float("inf")))
        count, last = torch.stack(count, 1), torch.stack(last, 1)
        ior = scene.ior[scene.containers]
        inside = count % 2 == 1
        n1 = _top(inside, last, ior)
        which = torch.tensor(scene.containers, device=o.device)
        hk = (obj[:, None] == which).long().argmax(1)
        is_c = (obj[:, None] == which).any(1)
        leaving = is_c & inside.gather(1, hk[:, None])[:, 0]
        rest = inside & ~(torch.nn.functional.one_hot(hk, len(which)).bool() & leaving[:, None])
        n2 = torch.where(is_c, torch.where(leaving, _top(rest, last, ior), ior[hk]), n1)
    return Hits(best, obj, row, u, v, n1, n2)


def closest(scene: Scene, o, d) -> Hits:
    parts = [_closest_chunk(scene, o[i:i + scene.chunk], d[i:i + scene.chunk])
             for i in range(0, o.shape[0], scene.chunk)]
    return Hits(*(torch.cat([getattr(p, f.name) for p in parts])
                  for f in dataclasses.fields(Hits)))


def shadowed(scene: Scene, point):
    """is_shadowed of each point: a hit at 0 <= t < the light's distance."""
    vec = scene.light_pos - point
    dist = torch.linalg.norm(vec, dim=1)
    d = vec / dist[:, None]
    out = []
    for i in range(0, point.shape[0], scene.chunk):
        o_, d_, m = point[i:i + scene.chunk], d[i:i + scene.chunk], dist[i:i + scene.chunk]
        hit = torch.zeros_like(m, dtype=torch.bool)
        for ob in scene.objects:
            sel, t = _crossings(ob, o_, d_)[:2]
            tmin = _spread(sel, torch.where(t >= 0.0, t, float("inf")).amin(1), len(m),
                           float("inf"))
            hit |= tmin < m
        out.append(hit)
    return torch.cat(out)


def _cube_normal(p):
    """The face of the largest |component| of p (R, 3), ties x, y, z."""
    a = p.abs()
    top = a.amax(1, keepdim=True)
    is_x = a[:, 0:1] == top
    is_y = ~is_x & (a[:, 1:2] == top)
    is_z = ~is_x & ~is_y
    return p * torch.cat([is_x, is_y, is_z], 1).to(p.dtype)


def _normal(scene: Scene, h: Hits, point):
    """World normals at the hits (normal_at, with smooth meshes)."""
    n = torch.empty_like(point)
    for k, ob in enumerate(scene.objects):
        sel = h.obj == k
        if not bool(sel.any()):
            continue
        if ob.kind == "plane":
            local = torch.zeros_like(point[sel])
            local[:, 1] = 1.0
            nk = mm(local, ob.inv3)
        elif ob.kind == "cube":
            nk = mm(_cube_normal(mm(point[sel], ob.inv3.T) + ob.inv_t), ob.inv3)
        elif ob.corners is None:
            nk = mm(ob.normals[h.row[sel]], ob.inv3)
        else:
            c = [mm(ob.corners[j][h.row[sel]], ob.inv3) for j in range(3)]
            c = [x / torch.linalg.norm(x, dim=1, keepdim=True) for x in c]
            u, v = h.u[sel][:, None], h.v[sel][:, None]
            nk = (1.0 - u - v) * c[0] + u * c[1] + v * c[2]
        n[sel] = nk / torch.linalg.norm(nk, dim=1, keepdim=True)
    return n


@torch.no_grad()
def trace(scene: Scene, o, d, remaining: int):
    """The ray tree of color_at(o, d) with `remaining` budget: a Node per
    shading level, or None where no level shades (internal_color_at)."""
    if remaining < 1 or o.shape[0] == 0:
        return None
    h = closest(scene, o, d)
    idx = torch.nonzero(torch.isfinite(h.t))[:, 0]
    if idx.numel() == 0:
        return None
    h = Hits(*(getattr(h, f.name)[idx] for f in dataclasses.fields(Hits)))
    o, d = o[idx], d[idx]
    point = o + d * h.t[:, None]
    eyev = -d
    normal = _normal(scene, h, point)
    inside = _dot(normal, eyev) < 0.0
    normal = torch.where(inside[:, None], -normal, normal)
    over = point + normal * EPSILON
    node = Node(idx, h.obj, point, eyev, normal, shadowed(scene, over),
                _schlick(eyev, normal, h.n1, h.n2))
    if remaining - 2 < 1:
        return node
    refl = torch.nonzero(scene.reflective[h.obj] > 0.0)[:, 0]
    if refl.numel():
        rd = d[refl] - normal[refl] * (2.0 * _dot(d[refl], normal[refl]))[:, None]
        node.refl, node.refl_idx = trace(scene, over[refl], rd, remaining - 3), refl
    ratio = h.n1 / h.n2
    cos_i = _dot(eyev, normal)
    sin2_t = ratio * ratio * (1.0 - cos_i * cos_i)
    refr = torch.nonzero((scene.transparency[h.obj] > 0.0) & (sin2_t <= 1.0))[:, 0]
    if refr.numel():
        cos_t = torch.sqrt(1.0 - sin2_t[refr])
        rd = (normal[refr] * (ratio[refr] * cos_i[refr] - cos_t)[:, None]
              - eyev[refr] * ratio[refr][:, None])
        under = point[refr] - normal[refr] * EPSILON
        node.refr, node.refr_idx = trace(scene, under, rd, remaining - 3), refr
    return node


def _pattern(scene: Scene, k: int, point):
    ob = scene.objects[k]
    kind, pinv3, pinv_t, a, b = scene.patterns[k]
    p = mm(mm(point, ob.inv3.T) + ob.inv_t, pinv3.T) + pinv_t
    cells = torch.floor(p + PATTERN_EPS)
    s = cells[:, 0] if kind == "stripe" else cells.sum(1)
    return torch.where((torch.remainder(s, 2.0) == 0.0)[:, None], a, b)


def _surface(scene: Scene, node: Node, color, intensity):
    """lighting() at each hit of node, Phong with the shadow flag."""
    obj = node.obj
    base = color[obj]
    for k, pat in enumerate(scene.patterns):
        sel = obj == k
        if pat is not None and bool(sel.any()):
            base = torch.where(sel[:, None], _pattern(scene, k, node.point), base)
    effective = base * intensity
    lightv = scene.light_pos - node.point
    lightv = lightv / torch.linalg.norm(lightv, dim=1, keepdim=True)
    ambient = effective * scene.ambient[obj][:, None]
    ldn = _dot(lightv, node.normal)
    lit = ~node.shadow & (ldn >= 0.0)
    diffuse = effective * (scene.diffuse[obj] * ldn)[:, None]
    reflectv = -lightv + node.normal * (2.0 * ldn)[:, None]
    rde = _dot(reflectv, node.eyev)
    shine = torch.where(rde > 0.0, rde, torch.zeros_like(rde)) ** scene.shininess[obj]
    specular = intensity * (scene.specular[obj] * shine)[:, None]
    zero = torch.zeros_like(diffuse)
    return (ambient + torch.where(lit[:, None], diffuse, zero)
            + torch.where((lit & (rde > 0.0))[:, None], specular, zero))


def shade(scene: Scene, node: Node, n_rays: int, color=None, intensity=None):
    """The (n_rays, 3) colours of a level's rays from its Node (black
    where a ray missed or the level is None), differentiable in color
    (objects x 3) and intensity (3,), which default to the scene's."""
    color = scene.color if color is None else color
    intensity = scene.intensity if intensity is None else intensity
    if node is None:
        return torch.zeros((n_rays, 3), dtype=scene.dtype, device=scene.device)
    out = _surface(scene, node, color, intensity)
    refl = torch.zeros_like(out)
    refr = torch.zeros_like(out)
    if node.refl_idx is not None:
        part = shade(scene, node.refl, len(node.refl_idx), color, intensity)
        refl = refl.index_copy(0, node.refl_idx, part) * scene.reflective[node.obj][:, None]
    if node.refr_idx is not None:
        part = shade(scene, node.refr, len(node.refr_idx), color, intensity)
        refr = refr.index_copy(0, node.refr_idx, part) * scene.transparency[node.obj][:, None]
    both = ((scene.reflective[node.obj] > 0.0) & (scene.transparency[node.obj] > 0.0))[:, None]
    r = node.schlick[:, None]
    out = torch.where(both, out + refl * r + refr * (1.0 - r), out + refl + refr)
    return torch.zeros((n_rays, 3), dtype=out.dtype, device=out.device).index_copy(
        0, node.idx, out)


def render_rays(scene: Scene, o, d, max_depth: int):
    """color_at of each ray: (R, 3)."""
    return shade(scene, trace(scene, o, d, max_depth), o.shape[0])
