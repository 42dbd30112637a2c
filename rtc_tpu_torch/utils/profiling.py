"""Observability: ray accounting, render reports, timing, the program's
spans and profiler traces (counterpart of rtc_tpu/utils/profiling.py).

Both packages must count ray casts identically, since rays/s is the
metric the two are compared by. Traces come from torch.profiler in place
of jax.profiler.

span(name) is the program's one span recorder. Its spans (named rtc.*)
mark the host work of the public entries that go through the frame and
step cache (render/compiled.py): a root for each call of render(),
render_tiles, loss_and_grad and a train step, and inside it the camera's
values, the route, the graph's lookup, the inputs' fill, the replay, the
output's copy, and a capture's eager run and capture; inside a frame
where its Python runs (an eager call, a capture), the refraction census
(rtc.census over rtc.census.prims and rtc.census.mesh,
render/integrator.py); and a root for each compile_scene call, with the
compile's steps inside it (rtc.compile.*, scene/compile.py). Recording is off by default, and then a span is a
shared no-op context. It is on while
set_recording(True) holds or a torch profiler runs (trace() among them):
each span then appends (name, start_ns, end_ns, parent) to a bounded
in-memory record on time.perf_counter_ns, and while a profiler runs it
also opens a record_function of its name, so the span sits in the trace
beside the device operations. take_spans() hands the record over and
clears it; totals() sums it by name. Spans nest in order of entry, so
the record serves one thread's calls.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, List, NamedTuple

import torch
import torch.autograd.profiler as _torch_profiler

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


SPAN_LIMIT = 1 << 17  # spans the record holds; later ones are counted as dropped
_now = time.perf_counter_ns


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int  # the enclosing span's index in the record; -1 for a root


class Record(NamedTuple):
    spans: List[Span]
    dropped: int  # spans not recorded because the record was full


class Total(NamedTuple):
    count: int
    seconds: float
    self_seconds: float  # less what the span's children cover


class _Recorder:
    def __init__(self):
        self.on = False
        self.spans: list = []  # [name, start_ns, end_ns, parent], in order of entry
        self.open: list = []   # record indices of the open spans, innermost last
        self.dropped = 0


_REC = _Recorder()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "entry", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        rec = _REC
        if len(rec.spans) < SPAN_LIMIT:
            self.entry = [self.name, 0, 0, rec.open[-1] if rec.open else -1]
            rec.open.append(len(rec.spans))
            rec.spans.append(self.entry)
        else:
            self.entry = None
            rec.dropped += 1
            rec.open.append(-1)
        self.annotation = None
        if _torch_profiler._is_profiler_enabled:
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        if self.entry is not None:
            self.entry[1] = _now()
        return self

    def __exit__(self, *exc):
        if self.entry is not None:
            self.entry[2] = _now()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _REC.open.pop()
        return False


def span(name: str):
    """A context marking the host work of name. While recording is off
    (neither set_recording(True) nor a torch profiler) it is one shared
    no-op: no clock, no record_function, no allocation."""
    if not (_REC.on or _torch_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name)


def set_recording(on: bool) -> bool:
    """Record spans (on) or not, also while no profiler runs; returns the
    setting it replaced."""
    was, _REC.on = _REC.on, bool(on)
    return was


def take_spans() -> Record:
    """The spans recorded since the last take, and how many were dropped;
    clears the record. Call it between calls, when no span is open."""
    if _REC.open:
        raise RuntimeError(f"take_spans() inside {len(_REC.open)} open span(s)")
    out = Record([Span(*e) for e in _REC.spans], _REC.dropped)
    _REC.spans, _REC.dropped = [], 0
    return out


def totals(spans) -> Dict[str, Total]:
    """Per span name: the count, the seconds, and the self seconds (each
    span's duration less what its children cover)."""
    children = [0] * len(spans)
    for s in spans:
        if s.parent >= 0:
            children[s.parent] += s.end_ns - s.start_ns
    sums: dict = {}
    for s, inner in zip(spans, children):
        n, total, own = sums.get(s.name, (0, 0, 0))
        d = s.end_ns - s.start_ns
        sums[s.name] = (n + 1, total + d, own + d - inner)
    return {k: Total(n, total / 1e9, own / 1e9) for k, (n, total, own) in sums.items()}


def device_ops(events) -> list:
    """The device operations among a torch profiler's events
    (prof.events()): its CUDA events less the device side of
    record_function annotations, the program's spans among them."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def idle_gaps(events, start_us=None, end_us=None) -> list:
    """The stretches of [start_us, end_us) (default: the extent of the
    program's spans in events) in which no device operation ran, longest
    first: [(seconds, the innermost program span at the stretch's
    midpoint or None, the midpoint in us)], on the trace's clock."""
    from torch.autograd import DeviceType

    spans = [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.device_type == DeviceType.CPU and e.name.startswith("rtc.")]
    if start_us is None:
        if not spans:
            return []
        start_us, end_us = min(a for a, _, _ in spans), max(b for _, b, _ in spans)
    ops = sorted((e.time_range.start, e.time_range.end) for e in device_ops(events))
    out, t = [], start_us
    for a, b in ops + [(end_us, end_us)]:
        a = min(max(a, start_us), end_us)
        if a > t:
            mid = (a + t) / 2
            inner = max((s for s in spans if s[0] <= mid < s[1]), default=None)
            out.append(((a - t) / 1e6, inner and inner[2], mid))
        t = max(t, min(b, end_us))
    return sorted(out, key=lambda g: -g[0])


@contextlib.contextmanager
def trace(logdir: str = os.path.join(_ROOT, "build", "profile", "trace")):
    """torch.profiler trace (host and, with a card, device) around a
    render, written to logdir for TensorBoard or a Chrome trace viewer,
    with the program's spans in it: as under any torch profiler, spans
    are recorded while it is open. Usage:

        with profiling.trace(logdir) as prof:
            img = render(scene, cam, cfg)
            torch.cuda.synchronize()
        spans = profiling.take_spans().spans
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        yield prof


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
    kernels at first use) and, on render()'s graphed route, the frame's
    capture as a CUDA graph (render/compiled.py), as rtc_tpu's includes
    the jit compile; per_iter_seconds the mean of iters later calls, each
    forced before the clock stops."""
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
