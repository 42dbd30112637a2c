"""A turntable of a configuration with the gradient pattern: the `frames`
loop itself (loops.frames), checked as check.frame_numbers checks it,
against the reference that knows the book's gradient pattern
(reference/gradient.py) in float64. The control is that reference in
float32 with TF32 products, put in the program's place."""

from __future__ import annotations

import numpy as np
import torch

from rtbench import check
from rtbench.loops import frames as run  # noqa: F401  (the kind's generator)
from rtbench.reference import geometry as G
from rtbench.reference import gradient
from rtbench.reference.precision import tf32


def _frame_colors(ctx, answers, frames, idx, dtype, device):
    config = ctx.config
    c, cam = config["canvas"], config["camera"]
    views = {k: G.view_transform(answers["at"](k), cam["to"], cam["up"]) for k in set(frames)}
    transforms = np.stack([views[k] for k in frames])
    scene = gradient.Scene(config, ctx.root, dtype, device)
    o, d = G.pixel_rays(transforms, c["width"], c["height"], c["field_of_view"],
                        idx % c["width"], idx // c["width"], dtype, device)
    return gradient.render_rays(scene, o, d, config["render"]["max_depth"])


def numbers(ctx, answers, device, control: bool = False) -> dict:
    """check.frame_numbers's `bad_share` and `gap_p90` against gradient.py."""
    frames, idx, vals = check._compared(ctx, answers)
    ref = _frame_colors(ctx, answers, frames, idx, check.REF_DTYPE, device)
    if control:
        with tf32():
            vals = _frame_colors(ctx, answers, frames, idx, check.CONTROL_DTYPE, device)
    gap = (torch.as_tensor(vals, device=device).to(check.REF_DTYPE) - ref).abs().amax(1)
    lit = gap[ref.amax(1) > 0]
    return {"bad_share": float((gap > ctx.cell["check"]["bad_gap"]).double().mean()),
            "gap_p90": float(torch.quantile(lit, 0.9)) if lit.numel() else float("nan")}
