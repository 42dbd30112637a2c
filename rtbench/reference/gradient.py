"""The plain reference with the book's gradient pattern: tracer.py's
Whitted integrator (world.rs color_at, shade_hit, is_shadowed,
reflected_color, refracted_color; intersection.rs prepare_computations
and schlick; material.rs lighting), in plain torch, vectorised over rays,
for a configuration whose objects are meshes and planes, and whose
patterns are checkers and gradient. The ray tree is tracer.py's own
(tracer.trace: the triangle features, the closest and shadow sweeps, the
normals, Schlick, the n1/n2 walk), and so is the scene but for its
patterns; what this file adds is the pattern of each object by its kind,
and lighting and the blend over that pattern.

The addition, as the book has it:
  gradient  a + (b - a) (x - floor x) of the pattern-space point's x
            (pattern.rs:77), with no nudge: the colour wraps from b back
            to a at every integer x.

Departures from the book, the framework's documented extensions as in
tracer.py: smooth meshes interpolate per-corner normals; the checkers
pattern nudges its cells by PATTERN_EPS before flooring, and the gradient
takes no such nudge (rtc_tpu_torch ops/patterns.py, as rtc_tpu's); a mesh
is one container of the n1/n2 walk (crossing parity); `containers` names
which objects the walk enrols ("all": every object, as the book;
"refractive": objects with a refractive index other than 1 or any
transparency).
"""

from __future__ import annotations

import numpy as np
import torch

from . import geometry as G
from . import tracer
from .precision import mm
from .tracer import PATTERN_EPS, Node, _dot, trace

PATTERNS = ("checkers", "gradient")


class Scene(tracer.Scene):
    """tracer.py's scene of a configuration (which refuses any object but
    a mesh or a plane), with each object's pattern by its kind."""

    def __init__(self, config: dict, root: str, dtype=torch.float64, device="cpu"):
        pats = [o.get("material", {}).get("pattern") for o in config["objects"]]
        for pat in pats:
            if pat is not None and pat["kind"] not in PATTERNS:
                raise ValueError(f"the reference has no {pat['kind']!r} pattern")
        bare = [dict(o, material={k: v for k, v in o.get("material", {}).items()
                                  if k != "pattern"}) for o in config["objects"]]
        super().__init__(dict(config, objects=bare), root, dtype, device)
        t = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)
        self.patterns = []
        for pat in pats:
            if pat is not None:
                pinv = np.linalg.inv(G.compose(pat.get("transform")))
                pat = (pat["kind"], t(pinv[:3, :3]), t(pinv[:3, 3]), t(pat["a"]), t(pat["b"]))
            self.patterns.append(pat)


def _pattern(scene: Scene, k: int, point):
    ob = scene.objects[k]
    kind, pinv3, pinv_t, a, b = scene.patterns[k]
    p = mm(mm(point, ob.inv3.T) + ob.inv_t, pinv3.T) + pinv_t
    if kind == "gradient":
        x = p[:, 0:1]
        return a + (b - a) * (x - torch.floor(x))
    s = torch.floor(p + PATTERN_EPS).sum(1)
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
