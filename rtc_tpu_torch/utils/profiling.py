"""Observability: ray accounting, render reports, timing and profiler
traces (counterpart of rtc_tpu/utils/profiling.py).

Both packages must count ray casts identically, since rays/s is the
metric the two are compared by. Traces come from torch.profiler in place
of jax.profiler.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Dict

import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bounce_levels(max_depth: int) -> int:
    """Number of shading levels the budget yields: each secondary ray costs
    3 budget, and a node shades iff its budget >= 1."""
    levels = 0
    b = max_depth
    while b >= 1:
        levels += 1
        b -= 3
    return levels


def rays_per_pixel(max_depth: int, any_reflective: bool, any_refractive: bool,
                   shadows: bool = True) -> int:
    """Ray casts per pixel in the wavefront integrator: each tree node costs
    1 closest-hit sweep + 1 shadow sweep; nodes branch 2-way per level when
    both reflect/refract subtrees are live."""
    levels = bounce_levels(max_depth)
    branch = (1 if any_reflective else 0) + (1 if any_refractive else 0)
    nodes = 0
    width = 1
    for _ in range(levels):
        nodes += width
        width *= max(branch, 1) if branch else 0
        if width == 0:
            break
    per_node = 2 if shadows else 1
    return max(nodes, 1) * per_node


@dataclasses.dataclass
class RenderReport:
    """rtc_tpu's report fields. device: the card's name, or "cpu"."""

    scene: str
    width: int
    height: int
    wall_s: float
    compile_s: float
    primary_rays: int
    total_ray_casts: int
    rays_per_s: float
    device: str
    dtype: str

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


@contextlib.contextmanager
def trace(logdir: str = os.path.join(_ROOT, "build", "profile", "trace")):
    """torch.profiler trace (host and, with a card, device) around a
    render, written to logdir for TensorBoard or a Chrome trace viewer.
    Usage:

        with profiling.trace(logdir) as prof:
            img = render(scene, cam, cfg)
            torch.cuda.synchronize()
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        yield prof


def annotate(name: str):
    """Named region for profiler timelines (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def timed(result: Dict[str, float], key: str):
    t0 = time.perf_counter()
    yield
    result[key] = time.perf_counter() - t0


def _force(out) -> None:
    """Wait until out is computed: a CUDA tensor's device is synchronized
    (PyTorch returns before the kernels finish); anything else is copied
    to the host, which is what a consumer (the PPM write) does anyway."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)
    elif isinstance(out, torch.Tensor):
        out.cpu()


def time_render(render_fn, *args, warmup: bool = True, iters: int = 1,
                **kwargs):
    """Return (result, compile_seconds, per_iter_seconds). compile_seconds
    is the first call, with everything it builds and loads (the CUDA
    kernels at first use); per_iter_seconds the mean of iters later calls,
    each forced before the clock stops."""
    t0 = time.perf_counter()
    out = render_fn(*args, **kwargs)
    _force(out)
    compile_s = time.perf_counter() - t0
    if not warmup:
        return out, compile_s, compile_s
    t1 = time.perf_counter()
    for _ in range(iters):
        out = render_fn(*args, **kwargs)
        _force(out)
    per_iter = (time.perf_counter() - t1) / max(iters, 1)
    return out, compile_s, per_iter
