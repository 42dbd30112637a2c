"""What decides `correct`: the timed path's answers against the plain
reference (rtbench/reference), which builds its own scene, rays and
targets from the configuration and the seed, in float64, after the
program's state is freed. The control is the same reference in float32
with TF32 matrix products, put in the program's place.

frames: the pixels kept from every frame of the window (a seeded sample
  of `pixels_compared` of them), each against the reference's colour of
  that pixel of that frame's view. A pixel's gap is its largest channel
  difference. Compared: `bad_share`, the share of pixels whose gap
  exceeds `bad_gap` (a pixel on the other side of a silhouette, shadow
  or checker edge); `gap_p90`, the 90th percentile of the gaps of the
  pixels the reference does not leave black (the rounding every lit
  pixel carries).
fit: the first `checked_steps` steps, the reference following them with
  its own targets and its own Adam. Compared: `loss_gap`, the largest
  relative gap of a step's loss; `grad_gap`, the first gradient's norm
  (the program's from Adam's first moment after one step) and
  `change_gap`, the parameters' change over the steps, each by the worst
  parameter: the gap between the program's norm and the reference's,
  over the reference's norm of that parameter or the median
  parameter's, whichever is larger. `change_gap` leaves out parameters
  whose reference gradient is under a thousandth of the median's.
"""

from __future__ import annotations

import numpy as np
import torch

from . import loops
from .reference import geometry as G
from .reference import tracer
from .reference.precision import tf32

REF_DTYPE = torch.float64
CONTROL_DTYPE = torch.float32

# the reference's tables for the parameters a fit may name
FIT_PARAMS = {"mat_color": "color", "light_intensity": "intensity"}


def _compared(ctx, answers):
    """(frame of each compared pixel, its index, the program's colours)."""
    frames = np.concatenate([np.full(len(idx), k) for k, idx, _ in answers["kept"]])
    idx = np.concatenate([idx for _, idx, _ in answers["kept"]])
    vals = np.concatenate([v for _, _, v in answers["kept"]])
    n = ctx.cell["check"]["pixels_compared"]
    if len(idx) > n:
        sel = np.sort(np.random.default_rng([ctx.seed, 2]).choice(len(idx), n, replace=False))
        frames, idx, vals = frames[sel], idx[sel], vals[sel]
    return frames, idx, vals


def _frame_colors(ctx, answers, frames, idx, dtype, device):
    config = ctx.config
    c, cam = config["canvas"], config["camera"]
    views = {k: G.view_transform(answers["at"](k), cam["to"], cam["up"]) for k in set(frames)}
    transforms = np.stack([views[k] for k in frames])
    scene = tracer.Scene(config, ctx.root, dtype, device)
    o, d = G.pixel_rays(transforms, c["width"], c["height"], c["field_of_view"],
                        idx % c["width"], idx // c["width"], dtype, device)
    return tracer.render_rays(scene, o, d, config["render"]["max_depth"])


def frame_numbers(ctx, answers, device, control: bool = False) -> dict:
    frames, idx, vals = _compared(ctx, answers)
    ref = _frame_colors(ctx, answers, frames, idx, REF_DTYPE, device)
    if control:
        with tf32():
            vals = _frame_colors(ctx, answers, frames, idx, CONTROL_DTYPE, device)
    gap = (torch.as_tensor(vals, device=device).to(REF_DTYPE) - ref).abs().amax(1)
    lit = gap[ref.amax(1) > 0]
    return {"bad_share": float((gap > ctx.cell["check"]["bad_gap"]).double().mean()),
            "gap_p90": float(torch.quantile(lit, 0.9)) if lit.numel() else float("nan")}


def fit_readings(ctx, dtype, device) -> dict:
    """The reference's losses, first gradient and change over the checked
    steps of the seed's fit, in dtype."""
    config, tr = ctx.config, ctx.traffic
    at, scales = loops.fit_plan(config, tr, ctx.seed)
    scene = tracer.Scene(config, ctx.root, dtype, device)
    names = tuple(tr["params"])
    start = {k: getattr(scene, FIT_PARAMS[k]) for k in names}
    true = {k: v * torch.as_tensor(scales[k], dtype=dtype, device=device) for k, v in start.items()}
    params = {k: v.clone().requires_grad_() for k, v in start.items()}
    opt = tr["optimizer"]
    (b1, b2), lr, eps = opt["betas"], opt["lr"], opt["eps"]
    m = {k: torch.zeros_like(v) for k, v in start.items()}
    s = {k: torch.zeros_like(v) for k, v in start.items()}
    losses, grad1 = [], None
    depth = config["render"]["max_depth"]
    for i in range(tr["checked_steps"]):
        o, d = loops.view_rays(config, at(i), dtype, device)
        tree = tracer.trace(scene, o, d, depth)
        shade = lambda p: tracer.shade(scene, tree, o.shape[0], p.get("mat_color"),
                                       p.get("light_intensity"))
        with torch.no_grad():
            target = shade(true)
        loss = torch.mean((shade(params) - target) ** 2)
        grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
        losses.append(float(loss.detach()))
        if i == 0:
            grad1 = {k: g.detach() for k, g in grads.items()}
        with torch.no_grad():
            for k in names:  # Adam (Kingma and Ba), as torch.optim.Adam steps
                m[k].mul_(b1).add_(grads[k], alpha=1 - b1)
                s[k].mul_(b2).addcmul_(grads[k], grads[k], value=1 - b2)
                t = i + 1
                denom = (s[k].sqrt() / (1 - b2 ** t) ** 0.5).add_(eps)
                params[k].addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
        del tree
    return {"losses": losses, "grad1": grad1,
            "change": {k: (params[k] - start[k]).detach() for k in names}}


def _norms(leaves: dict) -> dict:
    return {k: float(torch.linalg.norm(v.double())) for k, v in leaves.items()}


def _worst(prog: dict, ref: dict, keep) -> float:
    p, r = _norms(prog), _norms(ref)
    med = float(np.median(list(r.values())))
    return max(abs(p[k] - r[k]) / max(r[k], med) for k in keep)


def fit_numbers(ctx, answers, device, control: bool = False) -> dict:
    ref = fit_readings(ctx, REF_DTYPE, device)
    if control:
        with tf32():
            answers = fit_readings(ctx, CONTROL_DTYPE, device)
    g = _norms(ref["grad1"])
    med = float(np.median(list(g.values())))
    moved = [k for k in g if g[k] >= 1e-3 * med]
    return {"loss_gap": max(abs(p - r) / abs(r) for p, r in zip(answers["losses"],
                                                               ref["losses"])),
            "grad_gap": _worst(answers["grad1"], ref["grad1"], list(g)),
            "change_gap": _worst(answers["change"], ref["change"], moved)}


NUMBERS = {"frames": frame_numbers, "fit": fit_numbers}


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit (a NaN fails)."""
    return all(numbers[k] <= limits[k] for k in limits)
