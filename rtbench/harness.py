"""The benchmark's run: find the cell in BENCHMARK.json and its files by
name, set up and drive the program under the cell's traffic, trace a
steady part where asked, check the answers against the reference, and
print the result.

Files, each found by the name BENCHMARK.json gives:
  configs/<config>.json     the scene as data (the entry's `file`)
  traffic/<traffic>.json    a traffic mix; its `loop` names the generator
                            (loops.LOOPS, or kinds/<loop>.py with run()
                            and numbers())
  workloads/<cell>.json     the cell's check (sizes, limits) and trace
  metrics/<metric>.py       a per-layer metric's reader: read(Readings)
                            returns its value, or None where it finds
                            nothing to read
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "rtc_tpu")  # top-level module names


class Refused(Exception):
    """The run cannot give a result; the message says why."""


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Context:
    """One run of one cell."""
    root: str
    bench: dict
    workload: dict      # the BENCHMARK.json entry
    config: dict
    traffic: dict
    cell: dict          # workloads/<cell>.json
    seed: int
    seconds: float
    trace: bool
    device: str         # "cuda", or "cpu" in a rehearsal
    t0: float           # perf_counter at the harness's first line
    marks: dict = dataclasses.field(default_factory=dict)  # set-up's steps, s from t0

    @property
    def kind(self) -> str:
        return self.traffic["loop"]

    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"]
                if self.workload["name"] in m.get("workloads", [self.workload["name"]])]

    def per_layer(self) -> list:
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.workload["name"] in m["workloads"] if "workloads" in m
                    else m["moves"] in mine)]


def context(root: str, name: str, seed: int, seconds: float, trace: bool, t0: float,
            rehearse: int = 0) -> Context:
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    workload = next((w for w in bench["workloads"] if w["name"] == name), None)
    if workload is None:
        raise Refused(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == workload["config"])
    config = _json(os.path.join(root, entry["file"]))
    if rehearse:
        c = config["canvas"]
        c["height"], c["width"] = rehearse * c["height"] // c["width"], rehearse
    return Context(root, bench, workload, config,
                   _json(os.path.join(HERE, "traffic", workload["traffic"] + ".json")),
                   _json(os.path.join(HERE, "workloads", name + ".json")),
                   seed, seconds, trace, "cpu" if rehearse else "cuda", t0)


def kind(name: str):
    """(run, numbers) of a loop kind."""
    from . import check, loops

    if name in loops.LOOPS:
        return loops.LOOPS[name], check.NUMBERS[name]
    mod = load_module(os.path.join(HERE, "kinds", name + ".py"), f"rtbench_kind_{name}")
    return mod.run, mod.numbers


@dataclasses.dataclass
class Readings:
    """What a per-layer reader may read."""
    ctx: Context
    host: dict       # set-up's host-clock values
    summary: object  # trace.Summary of the traced part, or None
    device_name: str


def read_per_layer(ctx: Context, readings: Readings) -> dict:
    out = {}
    for m in ctx.per_layer():
        mod = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"),
                          "rtbench_metric_" + m["name"].replace(".", "_"))
        value = mod.read(readings)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def run(ctx: Context, control: bool = False) -> dict:
    """Drive the cell once: the result's fields, and under `compared` the
    numbers the check compared, each with its limit."""
    import torch

    from . import accounting
    from .program import PACKAGE, Program
    from .tracing import Tracer, kernel_names

    if ctx.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = ctx.config["render"]["tf32"]
        torch.backends.cudnn.allow_tf32 = ctx.config["render"]["tf32"]
        torch.cuda.reset_peak_memory_stats()
    loop, numbers = kind(ctx.kind)
    tr = ctx.cell["trace"]
    tracer = Tracer(ctx.trace, tr["skip"], tr["iterations"], kernel_names(ctx.root, PACKAGE))
    tracer.warm()
    prog = Program(ctx.config, ctx.root, ctx.device)
    out = loop(ctx, prog, tracer)
    peak = torch.cuda.max_memory_allocated() if ctx.device == "cuda" else 0
    prog.release()
    del prog
    gc.collect()
    if ctx.device == "cuda":
        torch.cuda.empty_cache()
    name = torch.cuda.get_device_name(0) if ctx.device == "cuda" else "cpu"
    device = {"platform": "gpu" if ctx.device == "cuda" else "cpu", "kind": name,
              "count": 1 if ctx.device == "cuda" else 0, "memory_peak_bytes": peak}
    result = {"attempted": out.attempted, "failed": out.failed}
    if ctx.trace:
        s = out.summary
        device.update(busy_s=s.busy_s if s else 0.0, window_s=s.window_s if s else 0.0)
        result["metrics"] = read_per_layer(ctx, Readings(ctx, out.host, s, name))
        if s is not None:
            result["breakdown"] = {"device_ops": s.device_ops, "idle_gaps": s.idle_gaps}
    else:
        result["metrics"] = {m["name"]: {"value": out.metrics[m["name"]], "unit": m["unit"]}
                             for m in ctx.end_to_end()}
    result["device"] = device
    result["host"] = {**ctx.marks, **out.host}
    if "frame_ms" in out.metrics:  # rays/s, for continuity with the port's tools.bench
        casts = accounting.frame_queries(ctx.config, 0)["casts"]
        result["host"]["rays_per_s"] = casts / (out.metrics["frame_ms"] / 1e3)
    t = time.perf_counter()
    got = numbers(ctx, out.answers, ctx.device, control=control)
    result["host"]["check_s"] = time.perf_counter() - t
    limits = ctx.cell["limits"]
    result["correct"] = all(got[k] <= limits[k] for k in limits)
    result["compared"] = {k: {"value": got[k], "limit": limits.get(k)} for k in got}
    return result
