"""The traffic generator: one closed loop for each `loop` a traffic file
names, driven by that file's parameters and the seed.

frames: a turntable. The camera circles the configuration's look-at
  point at the published pose's distance and height, from a seeded
  azimuth, turning `azimuth_step_deg` a frame. A frame is render() and
  the image's copy to the host (into one pinned buffer), asked for when
  the last frame is in host memory. Of every frame the check keeps a
  seeded sample of pixels.
fit: inverse rendering. Set-up renders targets at seeded true
  parameters (each named parameter scaled channel-wise by factors drawn
  from `true_scale`) on a ring of `views` views of the seed's orbit; the
  fit starts from the published parameters, and a step takes the next
  view's rays (16x16 screen blocks) and target through the train step
  with Adam, its loss read to the host. The first `checked_steps` steps
  are set-up, and the check holds them to the reference.

Both time the window on the host clock: it opens after set-up and
closes at the end of the first frame or step that ends `seconds` after
it opened.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from .reference import geometry as G
from .tracing import Tracer


@dataclasses.dataclass
class Outcome:
    metrics: dict        # end-to-end values by name
    host: dict           # host-clock values of set-up by name
    attempted: int
    failed: int
    answers: object      # what the check compares
    summary: object = None  # trace.Summary of the traced part, or None


def _sync(device) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def orbit(config: dict, azimuth0: float, step: float):
    """The eye's position at frame k of a turntable (the published pose is
    on the ring, at its own azimuth)."""
    cam = config["camera"]
    to = np.asarray(cam["to"], np.float64)
    off = np.asarray(cam["from"], np.float64) - to
    radius, height = math.hypot(off[0], off[2]), off[1]

    def at(k: int) -> np.ndarray:
        a = azimuth0 + k * step
        return to + np.array([radius * math.cos(a), height, radius * math.sin(a)])
    return at


def frame_plan(config: dict, traffic: dict, seed: int):
    rng = np.random.default_rng([seed, 0])
    return orbit(config, rng.uniform(0.0, 2 * math.pi), math.radians(traffic["azimuth_step_deg"]))


def fit_plan(config: dict, traffic: dict, seed: int):
    """(the eye of view v, {parameter: (3,) true-scale factors})."""
    rng = np.random.default_rng([seed, 0])
    at = orbit(config, rng.uniform(0.0, 2 * math.pi), 2 * math.pi / traffic["views"])
    scales = {name: rng.uniform(*traffic["true_scale"], 3) for name in traffic["params"]}
    return at, scales


def view_rays(config: dict, eye, dtype, device):
    """A view's primary rays in 16x16 screen blocks."""
    c, cam = config["canvas"], config["camera"]
    px, py = G.blocked_pixels(c["width"], c["height"], device)
    return G.pixel_rays(G.view_transform(eye, cam["to"], cam["up"]), c["width"], c["height"],
                        c["field_of_view"], px, py, dtype, device)


def _window(ctx, tracer: Tracer, one) -> tuple:
    """Run one(k) for k = 0, 1, ... until the window's seconds are up and
    the traced part, if any, is over: (each call's seconds, the window's
    seconds)."""
    times, k = [], 0
    start = time.perf_counter()
    while True:
        tracer.at(k)
        t = time.perf_counter()
        one(k)
        end = time.perf_counter()
        times.append(end - t)
        k += 1
        if end - start >= ctx.seconds and tracer.done(k):
            break
    tracer.stop(k)
    return times, end - start


def frames(ctx, prog, tracer: Tracer) -> Outcome:
    config, check = ctx.config, ctx.cell["check"]
    w, h = config["canvas"]["width"], config["canvas"]["height"]
    at = frame_plan(config, ctx.traffic, ctx.seed)
    t = time.perf_counter()
    host = {"ready_s": t - ctx.t0}
    scene = prog.compile(prog.world())
    host["scene_compile_s"] = time.perf_counter() - t
    image = torch.empty((h, w, 3), dtype=prog.dtype, pin_memory=ctx.device == "cuda")
    flat = image.numpy().reshape(-1, 3)

    def frame(k: int) -> None:
        with tracer.span("render"):
            out = prog.render(scene, prog.camera(at(k)))
        with tracer.span("readback"):
            image.copy_(out, non_blocking=True)
            _sync(ctx.device)

    t = time.perf_counter()
    frame(-2)  # builds the kernels, runs the frame eagerly and captures it
    host["first_call_s"] = time.perf_counter() - t
    frame(-1)
    host["setup_s"] = time.perf_counter() - ctx.t0

    pick = np.random.default_rng([ctx.seed, 1])
    kept = []

    def one(k: int) -> None:
        frame(k)
        idx = pick.integers(0, w * h, check["pixels_kept_per_frame"])
        kept.append((k, idx, flat[idx]))

    times, window = _window(ctx, tracer, one)
    metrics = {"setup_s": host["setup_s"], "frame_ms": window / len(times) * 1e3,
               "frame_p95_ms": float(np.percentile(times, 95)) * 1e3}
    answers = {"at": at, "kept": kept}
    return Outcome(metrics, host, len(times), 0, answers, tracer.summary)


def fit(ctx, prog, tracer: Tracer) -> Outcome:
    config, tr = ctx.config, ctx.traffic
    at, scales = fit_plan(config, tr, ctx.seed)
    t = time.perf_counter()
    host = {"ready_s": t - ctx.t0}
    scene = prog.compile(prog.world())
    host["scene_compile_s"] = time.perf_counter() - t
    t = time.perf_counter()
    rays = [tuple(x.to(prog.dtype) for x in view_rays(config, at(v), torch.float64, ctx.device))
            for v in range(tr["views"])]
    published = prog.params(scene, tuple(tr["params"]))
    true = {k: v.detach() * torch.as_tensor(scales[k], dtype=v.dtype, device=v.device)
            for k, v in published.items()}
    truth = prog.with_params(scene, true)
    targets = [prog.colors(truth, o, d) for o, d in rays]
    del truth
    host["targets_s"] = time.perf_counter() - t
    params = prog.params(scene, tuple(tr["params"]))
    opt = tr["optimizer"]
    optimizer = torch.optim.Adam(params.values(), lr=opt["lr"], betas=tuple(opt["betas"]),
                                 eps=opt["eps"], capturable=ctx.device == "cuda")
    step = prog.train_step(optimizer)
    losses = []

    def one(k: int) -> None:
        v = k % tr["views"]
        with tracer.span("step"):
            loss = step(params, scene, rays[v][0], rays[v][1], targets[v])
        with tracer.span("loss_read"):
            losses.append(float(loss))

    first = {k: v.detach().clone() for k, v in params.items()}
    t = time.perf_counter()
    one(0)  # runs the step eagerly and captures it
    host["first_call_s"] = time.perf_counter() - t
    # the first gradient as Adam got it: its first moment after one step
    grad1 = {k: optimizer.state[v]["exp_avg"].detach() / (1.0 - opt["betas"][0])
             if v in optimizer.state else torch.zeros_like(v) for k, v in params.items()}
    for k in range(1, tr["checked_steps"]):
        one(k)
    change = {k: v.detach() - first[k] for k, v in params.items()}
    host["setup_s"] = time.perf_counter() - ctx.t0
    n = tr["checked_steps"]
    times, window = _window(ctx, tracer, lambda k: one(n + k))
    metrics = {"setup_s": host["setup_s"], "step_ms": window / len(times) * 1e3}
    answers = {"losses": losses[:n], "grad1": grad1, "change": change}
    return Outcome(metrics, host, len(times), 0, answers, tracer.summary)


LOOPS = {"frames": frames, "fit": fit}
