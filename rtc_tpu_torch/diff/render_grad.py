"""Differentiable rendering: gradients of the image with respect to scene
parameters (counterpart of rtc_tpu/diff/render_grad.py, name for name).

The pure-PyTorch integrator is differentiable as it stands, and every
closest-hit kernel call goes through an autograd Function whose backward
recomputes the winning triangle's closed form (render/integrator.py), so
autograd flows through shading, Phong, Fresnel, refraction directions and
hit positions. Hit/miss boundaries, shadow edges and pattern parity are
steps, with zero gradient, as in rtc_tpu.

Parameters are a dict of leaf tensors. extract_params copies them out of
a Scene, so an optimizer that updates them in place leaves the scene as it
was; inject_params puts them back. make_train_step takes a torch.optim
optimizer in place of rtc_tpu's optax transform. render() stays under
no_grad: the gradient path goes through integrator.color_at.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..ops import transforms as X
from ..render import compiled, integrator
from ..render.camera import camera_rays
from ..scene.compile import GEOMETRY_FIELDS, Scene, derived_tables
from ..utils.config import DEFAULT_CONFIG, RenderConfig
from ..utils.profiling import span

# Scene fields exposed as trainable parameters: materials, light, patterns,
# and object transforms (the inverse slabs; inject_params derives
# prim_invT from prim_inv). The triangle rows (GEOMETRY_FIELDS) may be
# injected too.
MATERIAL_PARAMS = (
    "mat_color", "mat_ambient", "mat_diffuse", "mat_specular",
    "mat_shininess", "mat_reflective", "mat_transparency", "mat_ior",
)
LIGHT_PARAMS = ("light_pos", "light_intensity")
PATTERN_PARAMS = ("pat_a", "pat_b")
TRANSFORM_PARAMS = ("prim_inv",)

DEFAULT_PARAMS = MATERIAL_PARAMS + LIGHT_PARAMS + PATTERN_PARAMS


def extract_params(scene: Scene, names=DEFAULT_PARAMS) -> Dict[str, torch.Tensor]:
    """Copies of the named scene fields as leaf tensors that require grad."""
    return {n: getattr(scene, n).detach().clone().requires_grad_() for n in names}


def inject_params(scene: Scene, params: Dict[str, torch.Tensor]) -> Scene:
    """The scene with params in place of its fields. prim_invT follows
    prim_inv. New triangle rows (tri_p1, tri_e1, tri_e2) rebuild the
    tables derived from them, the cluster boxes and the occlusion walk's
    tables, which the kernels read in place of the rows (an instanced
    scene refuses them; scene/compile.py derived_tables)."""
    repl = dict(params)
    if "prim_inv" in repl and scene.static.n_prims:
        # keep the normal-transform slab consistent with the optimized inverse
        repl["prim_invT"] = repl["prim_inv"][:, :, :3].transpose(-1, -2)
    if any(k in repl for k in GEOMETRY_FIELDS):
        repl.update(derived_tables(scene, *(repl.get(k, getattr(scene, k))
                                            for k in GEOMETRY_FIELDS)))
    return dataclasses.replace(scene, **repl)


def render_loss(params, scene: Scene, o, d, target, cfg: RenderConfig):
    """Mean-squared error between the rendered wavefront and a target."""
    img = integrator.color_at(inject_params(scene, params), o, d, cfg)
    return torch.mean((img - target) ** 2)


def _loss_and_grad(params, scene: Scene, o, d, target, cfg: RenderConfig):
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss = render_loss(leaves, scene, o, d, target, cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return loss.detach(), {k: torch.zeros_like(v) if g is None else g
                           for (k, v), g in zip(leaves.items(), grads)}


def _shapes(*tensors) -> tuple:
    return tuple((tuple(x.shape), x.dtype) for x in tensors)


def loss_and_grad(params, scene: Scene, o, d, target, cfg: RenderConfig):
    """(loss, {name: gradient}) of render_loss; a parameter the image does
    not depend on gets a zero gradient. On the graphed route one graph per
    (scene, the parameters' names, shapes and dtypes, the rays' and
    target's, cfg) runs the forward and the backward; the parameters'
    values, o, d and target are its inputs, and the results are the
    caller's own. Span rtc.loss_and_grad, around rtc.route, compiled.run's
    and rtc.graph.output (the copies)."""
    with span("rtc.loss_and_grad"):
        with span("rtc.route"):
            graphed = compiled.step_graphed("loss_and_grad", scene, cfg, params)
        if not graphed:
            return _loss_and_grad(params, scene, o, d, target, cfg)
        names = tuple(params)
        key = ("grad", tuple(zip(names, _shapes(*params.values()))), _shapes(o, d, target),
               cfg)

        def fn(*inputs):
            return _loss_and_grad(dict(zip(names, inputs)), scene, *inputs[len(names):], cfg)

        loss, grads = compiled.run(scene, key, fn, (*params.values(), o, d, target),
                                   "loss_and_grad")
        with span("rtc.graph.output"):
            return loss.clone(), {k: g.clone() for k, g in grads.items()}


def _optimizer_tensors(optimizer: torch.optim.Optimizer) -> tuple:
    """The optimizer's parameters and the tensors of its state."""
    ps = [p for g in optimizer.param_groups for p in g["params"]]
    return (*ps, *(v for p in ps for v in optimizer.state.get(p, {}).values()
                   if isinstance(v, torch.Tensor)))


def make_train_step(optimizer: torch.optim.Optimizer,
                    cfg: RenderConfig = DEFAULT_CONFIG):
    """A step of any torch.optim optimizer over scene parameters.
    train_step(params, scene, o, d, target) -> loss before the step;
    params must hold the leaf tensors the optimizer was built on, which
    the step updates in place.

    On the graphed route (compiled.step_route: Adam and its kin need
    capturable=True) the first call for a (scene, parameters, rays' shape)
    takes its step eagerly and captures the next; each later call copies
    o, d and target into the graph and replays it: the forward, the
    backward and optimizer.step(), reading and writing the parameters and
    the optimizer's state in place. The learning rate and every other
    setting of the optimizer is fixed at the capture, as rtc_tpu's optax
    transform is when jitted; new parameter tensors capture again. Span
    rtc.train_step, around rtc.route, compiled.run's and rtc.graph.output
    (the loss's copy)."""

    def step(params, scene, o, d, target):
        optimizer.zero_grad(set_to_none=True)
        loss = render_loss(params, scene, o, d, target, cfg)
        loss.backward()
        optimizer.step()
        return loss.detach()

    def train_step(params, scene, o, d, target):
        with span("rtc.train_step"):
            with span("rtc.route"):
                graphed = compiled.step_graphed("train_step", scene, cfg, params, optimizer)
            if not graphed:
                return step(params, scene, o, d, target)
            key = ("step", id(optimizer), tuple(zip(params, _shapes(*params.values()))),
                   _shapes(o, d, target), cfg)
            loss = compiled.run(scene, key, lambda *x: step(params, scene, *x), (o, d, target),
                                "the train step",
                                held=lambda: (*params.values(), *_optimizer_tensors(optimizer)))
            with span("rtc.graph.output"):
                return loss.clone()

    return train_step


# --- camera-pose differentiability ------------------------------------------
#
# Ray generation is differentiable (render/camera.py, ops/transforms.py
# view_transform on tensors), so the camera pose (from/to/up of the view
# transform, src/transformations.rs:80-93, and the field of view,
# src/camera.rs:16-41) is just another parameter dict.

CAMERA_PARAMS = ("cam_from", "cam_to", "cam_up", "cam_fov")


def camera_params(frm, to, up, fov, dtype=torch.float64,
                  device="cuda") -> Dict[str, torch.Tensor]:
    """A camera pose as a trainable parameter dict of leaf tensors."""
    f = lambda x: torch.tensor(x, dtype=dtype, device=device).requires_grad_()
    return {"cam_from": f(frm), "cam_to": f(to), "cam_up": f(up),
            "cam_fov": f(fov)}


def camera_pose_rays(cam: Dict[str, torch.Tensor], hsize: int, vsize: int,
                     dtype=torch.float32):
    """Differentiable primary-ray wavefront from pose parameters:
    view_transform -> torch.linalg.inv -> camera_rays, row-major, on the
    pose's device. Returns (o, d) of shape (H*V, 3)."""
    v = X.view_transform(cam["cam_from"], cam["cam_to"], cam["cam_up"])
    inv = torch.linalg.inv(v.to(dtype))
    half_view = torch.tan(cam["cam_fov"].to(dtype) / 2.0)
    aspect = hsize / vsize
    if aspect >= 1.0:
        half_width, half_height = half_view, half_view / aspect
    else:
        half_width, half_height = half_view * aspect, half_view
    pixel_size = half_width * 2.0 / hsize
    return camera_rays(inv, hsize, vsize, half_width, half_height,
                       pixel_size, dtype, device=inv.device)


def camera_render_loss(cam: Dict[str, torch.Tensor], scene: Scene, target,
                       cfg: RenderConfig, hsize: int, vsize: int):
    """MSE between the pose-parameterized render and a target image: the
    inverse-rendering objective for camera calibration."""
    o, d = camera_pose_rays(cam, hsize, vsize, cfg.torch_dtype())
    img = integrator.color_at(scene, o, d, cfg)
    return torch.mean((img - target.reshape(-1, 3)) ** 2)


def finite_diff_check(params, scene, o, d, target, cfg, name: str, index: Tuple,
                      eps: float = 1e-4):
    """(autograd, central finite difference) of one parameter entry."""
    _, grads = loss_and_grad(params, scene, o, d, target, cfg)

    @torch.no_grad()
    def loss_at(v):
        p = dict(params)
        p[name] = params[name].detach().clone()
        p[name][index] = v
        return float(render_loss(p, scene, o, d, target, cfg))

    v0 = float(params[name].detach()[index])
    fd = (loss_at(v0 + eps) - loss_at(v0 - eps)) / (2 * eps)
    return float(grads[name][index]), fd
