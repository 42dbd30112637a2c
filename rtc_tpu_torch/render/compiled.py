"""The compiled frame and gradient step: render(), the progressive tile,
loss_and_grad and the train step captured once as CUDA graphs and
replayed (counterpart of jax.jit's compilation cache over
rtc_tpu/render/renderer.py, progressive.py and diff/render_grad.py).

rtc_tpu compiles a frame into one program, once per (scene shape, canvas
shape, config). Here the same work is captured once per (scene, canvas,
config) as a torch.cuda.CUDAGraph and replayed: every kernel of the frame,
the shading glue's included, launches from one graph, with no Python
between them. The graph reads the scene's tensors where they lie, and its
inputs are static tensors that each call fills before the replay: the
camera's values for a frame (camera.camera_values), a tile's rays for a
progressive tile; the parameters' values, the rays and the target for
loss_and_grad. A graph keeps every tensor it reads that is neither the
scene's nor its own (a frame's pixel order), since a replay runs no
Python that would keep it alive. A train step's graph reads and writes
the parameters and the optimizer's state in place: it holds them, and a
call whose parameters or state lie elsewhere captures again.

Which route a call takes (route) is decided before any capture, from the
scene's static shapes, the config and the device alone:

  graphed  a CUDA device, cfg.prim_axis None, and no table that streams
           (integrator.plan's streams);
  eager    the CPU (the tests' route, which gives the bytes it always gave);
           primitive sharding (the collectives of gloo cannot be
           captured); a streamed table (superblock streaming reads its
           block order on the host, mesh_intersect.py closest_hit_blocked
           and any_hit_blocked).

A gradient call (step_route) takes the frame's route, and two more rules
send it eager: triangle rows among the parameters (inject_params rebuilds
the boxes and occlusion tables from them on the host, derived_tables),
and, for a train step, an optimizer with capturable=False (Adam and its
kin then keep their step count on the host). ROUTES counts the route each
gradient call took.

eager() is the counterpart of jax.disable_jit(): inside it every call,
frame or gradient, takes the eager route. A capture never falls back to
eager: one that fails raises CaptureError, chained to the operation that
broke it.

The first call for a key runs the work eagerly on a side stream (which
builds the kernels, mi.library(), and cuBLAS's workspace on that stream)
and returns that result; then it captures the same work on the same
stream, PyTorch's documented recipe. Each graph holds a private memory
pool as large as its work's peak (gigabytes for a prim-only frame at the
whole-frame tile), so the cache keeps at most MAX_GRAPHS graphs, least
recently used first out; clear() drops them all. An entry holds its scene
weakly and dies with it; a scene whose tensor fields were reassigned since
the capture is captured again.

Kernel launches (mi.LAUNCHES) happen at a replay, not at the capture: the
capture's own counts are taken back and recorded as the graph's launches,
which every replay adds, so a frame counts the same launches on either
route. The prims' plain sweeps (intersect.PLAIN_SWEEPS) and the shading
nodes by path (integrator.SHADE_NODES) are counted the same way, as the
graph's sweeps and shades.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import functools
import weakref

import torch

from ..ops import intersect
from ..ops.kernels import mesh_intersect as mi
from ..scene.compile import GEOMETRY_FIELDS
from ..utils.profiling import span
from . import integrator

GRAPHED = "graphed"
EAGER_CONTEXT = "eager: inside compiled.eager()"
MAX_GRAPHS = 4
COUNTS = {"captures": 0}
ROUTES: "collections.Counter[str]" = collections.Counter()  # "<call>: <route>" -> calls

# the counters a capture takes back and a replay repeats: (the kernels'
# launches, the prims' plain sweeps, the shading nodes by path)
_COUNTERS = (mi.LAUNCHES, intersect.PLAIN_SWEEPS, integrator.SHADE_NODES)

_EAGER = contextvars.ContextVar("rtc_tpu_torch_eager", default=False)
_CACHE: "collections.OrderedDict[tuple, Graph]" = collections.OrderedDict()


class CaptureError(RuntimeError):
    """A graphed route's capture failed; __cause__ is the failure."""


@contextlib.contextmanager
def eager():
    """Run render(), render_tiles, loss_and_grad and train steps eagerly
    inside this block, on every route (jax.disable_jit's counterpart)."""
    token = _EAGER.set(True)
    try:
        yield
    finally:
        _EAGER.reset(token)


def route(scene, cfg, device=None) -> str:
    """GRAPHED, or 'eager: <reason>', for a call of scene under cfg on
    device (default: the scene's)."""
    device = torch.device(scene.tri_p1.device if device is None else device)
    if device.type != "cuda":
        return "eager: the CPU"
    if cfg.prim_axis is not None:
        return "eager: primitive sharding (gloo's collectives cannot be captured)"
    if integrator.plan(scene, cfg, device, cfg.torch_dtype()).streams:
        return "eager: a streamed table (its block order is read on the host)"
    return GRAPHED


def graphed(scene, cfg, device) -> bool:
    """Does this call replay a graph: its route, unless inside eager()."""
    return not _EAGER.get() and route(scene, cfg, device) == GRAPHED


def step_route(scene, cfg, names, optimizer=None) -> str:
    """GRAPHED, or 'eager: <reason>', for loss_and_grad (optimizer None)
    or a train step of the parameters named by names, on the scene's
    device."""
    frame = route(scene, cfg)
    if frame != GRAPHED:
        return frame
    rows = [k for k in names if k in GEOMETRY_FIELDS]
    if rows:
        return (f"eager: geometry parameters {', '.join(rows)} (inject_params rebuilds "
                "the boxes and occlusion tables on the host, derived_tables)")
    if optimizer is not None and any(g.get("capturable") is False
                                     for g in optimizer.param_groups):
        return (f"eager: {type(optimizer).__name__} with capturable=False "
                "(its step count lives on the host)")
    return GRAPHED


def step_graphed(call: str, scene, cfg, names, optimizer=None) -> bool:
    """Does this gradient call (call: 'loss_and_grad' or 'train_step')
    replay a graph: its step_route, unless inside eager(). Counts the
    route taken in ROUTES."""
    taken = EAGER_CONTEXT if _EAGER.get() else step_route(scene, cfg, names, optimizer)
    ROUTES[f"{call}: {taken}"] += 1
    return taken == GRAPHED


def clear() -> None:
    """Drop every graph, and with them their memory pools."""
    _CACHE.clear()


def graph_for(scene, key, held=()):
    """The cached graph of scene under key (render: ('frame', (vsize,
    hsize), cfg); render_tiles: ('tile', tile, cfg); loss_and_grad:
    ('grad', ...); a train step: ('step', ...)), or None; held: the
    tensors the call would have it hold (run)."""
    g = _CACHE.get((id(scene),) + key)
    return g if g is not None and g.valid_for(scene, held) else None


def _layout(x: torch.Tensor) -> tuple:
    """Where a tensor lies and how a graph reads it."""
    return x.data_ptr(), tuple(x.shape), x.stride(), x.dtype


def _addresses(scene) -> tuple:
    """Where each tensor the graph may read lies, with its shape, strides
    and dtype: the scene's fields and the tables they hold."""
    out = []
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        tables = isinstance(v, tuple) and all(isinstance(x, torch.Tensor) for x in v)
        out.extend(_layout(x) if isinstance(x, torch.Tensor) else x
                   for x in (v if tables else (v,)))
    return tuple(out)


def tensors(out) -> list:
    """The tensors of an output: a tensor, or a tuple, list or dict of
    outputs; numbers hold none."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (int, float)):
        return []
    items = out.values() if isinstance(out, dict) else out
    return [t for x in items for t in tensors(x)]


@functools.lru_cache(maxsize=None)
def _side_stream(index: int) -> torch.cuda.Stream:
    return torch.cuda.Stream(index)


def _first_error(err: BaseException) -> BaseException:
    while err.__context__ is not None:
        err = err.__context__
    return err


class Graph:
    """fn(*inputs) captured once and replayed: inputs are static tensors
    that the caller fills before each replay; keep, the other tensors fn
    reads beside the scene's, which the graph holds as long as it lives;
    output is the static result (a tensor, or a tuple or dict of them),
    which the next replay overwrites; held, the tensors a replay reads and
    writes in place beside the scene's (hold). counts: what a replay adds
    to each of _COUNTERS: launches, the kernel launches; sweeps, the
    prims' plain sweeps; shades, the shading nodes by path.
    The first call's eager run and its capture are the spans
    rtc.graph.warm and rtc.graph.capture."""

    def __init__(self, scene, key: tuple, fn, inputs: tuple, what: str,
                 keep: tuple = ()):
        # the cache's entry under key dies with the scene
        self.scene = weakref.ref(scene, lambda _: _CACHE.pop(key, None))
        self.addresses = _addresses(scene)
        self.fn, self.inputs, self.what, self.keep = fn, inputs, what, keep
        self.held, self.held_layout = (), ()
        self.graph = self.output = None
        self.counts: tuple = tuple({} for _ in _COUNTERS)
        self.replays = 0

    launches = property(lambda self: self.counts[0])
    sweeps = property(lambda self: self.counts[1])
    shades = property(lambda self: self.counts[2])

    def valid_for(self, scene, held=()) -> bool:
        return (self.scene() is scene and self.addresses == _addresses(scene)
                and self.held_layout == tuple(map(_layout, held)))

    def hold(self, held) -> None:
        """Keep the tensors held, which a replay reads and writes in place,
        alive while the graph lives; a call that would have it hold others
        (or the same at another shape, stride or dtype) is not its own."""
        self.held = tuple(held)
        self.held_layout = tuple(map(_layout, self.held))

    def capture(self):
        """Run fn once eagerly on the side stream and return its result,
        then capture fn on that stream. Raises CaptureError if the capture
        fails."""
        device = self.inputs[0].device
        current = torch.cuda.current_stream(device)
        stream = _side_stream(device.index or 0)
        with span("rtc.graph.warm"):
            stream.wait_stream(current)
            with torch.cuda.stream(stream):
                out = self.fn(*self.inputs)
            current.wait_stream(stream)
            for t in tensors(out):
                t.record_stream(current)
            torch.cuda.synchronize(device)

        with span("rtc.graph.capture"):
            torch.cuda.empty_cache()
            before = tuple(dict(c) for c in _COUNTERS)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.stream(stream):
                    graph.capture_begin()
                    try:
                        self.output = self.fn(*self.inputs)
                    finally:
                        # ends the capture whatever happened; if fn failed, an
                        # error raised here chains to fn's
                        graph.capture_end()
            except Exception as err:
                first = _first_error(err)
                raise CaptureError(f"capturing {self.what} failed: {type(first).__name__}: "
                                   f"{first}") from err
            finally:
                self.counts = tuple({k: n - b[k] for k, n in c.items() if n != b[k]}
                                    for c, b in zip(_COUNTERS, before))
                for c, b in zip(_COUNTERS, before):
                    c.update(b)  # nothing ran: the replays count
            torch.cuda.synchronize(device)
        self.graph, self.fn = graph, None  # fn holds the scene
        COUNTS["captures"] += 1
        return out

    def replay(self):
        self.graph.replay()
        for c, made in zip(_COUNTERS, self.counts):
            for k, n in made.items():
                c[k] += n
        self.replays += 1
        return self.output


def run(scene, key: tuple, fn, values: tuple, what: str, keep: tuple = (),
        held=tuple):
    """fn(*values) through scene's graph under key (graph_for): each value
    is copied into the graph's input of its shape and dtype, on the
    scene's device (from pinned memory where it lies on the host, so the
    copy waits for nothing), and the graph replayed; the first call for a
    key makes the inputs, runs fn eagerly and captures it, and its graph
    holds keep (every tensor fn reads beside the scene's). held() gives
    the tensors fn reads and writes in place (a train step's parameters
    and optimizer state, which its first run may create): the graph holds
    them, and a call whose held() differ captures again. Returns the
    static output on a replay (overwritten by the next one) and the eager
    run's result on the first call. Spans: rtc.graph.lookup,
    rtc.graph.fill, then rtc.graph.replay, or a capture's rtc.graph.warm
    and rtc.graph.capture."""
    full = (id(scene),) + key
    device = scene.tri_p1.device
    with span("rtc.graph.lookup"):
        g = graph_for(scene, key, held())
    if g is None:
        _CACHE.pop(full, None)
        with span("rtc.graph.fill"):
            inputs = tuple(torch.empty(v.shape, dtype=v.dtype, device=device) for v in values)
            _fill(inputs, values)
        g = Graph(scene, full, fn, inputs, what, keep)
        out = g.capture()
        g.hold(held())
        while len(_CACHE) >= MAX_GRAPHS:
            _CACHE.popitem(last=False)
        _CACHE[full] = g
        return out
    _CACHE.move_to_end(full)
    with span("rtc.graph.fill"):
        _fill(g.inputs, values)
    with span("rtc.graph.replay"):
        return g.replay()


@torch.no_grad()  # a value that requires grad (a parameter) leaves the input a leaf
def _fill(inputs, values) -> None:
    for x, v in zip(inputs, values):
        if x.is_cuda and v.device.type == "cpu":
            v = v.pin_memory()
        x.copy_(v, non_blocking=True)
