"""Reductions the per-layer readers (metrics/<name>.py) share. Each
returns None where the run has nothing to read: no traced part, or a
trace that recorded no device operation."""

from __future__ import annotations

import os

from . import accounting
from .reference.obj import read_obj


def _traced(r):
    s = r.summary
    return s if s is not None and s.iterations > 0 and s.device_s > 0 else None


def kernel_ms(r):
    """Device ms an iteration in the program's hand-written kernels."""
    s = _traced(r)
    return None if s is None else s.kernel_s / s.iterations * 1e3


def glue_ms(r):
    """Device ms an iteration in every other device operation."""
    s = _traced(r)
    return None if s is None else (s.device_s - s.kernel_s) / s.iterations * 1e3


def device_idle(r):
    """% of the traced window in which no device operation ran."""
    s = _traced(r)
    return None if s is None or s.window_s <= 0 else 100.0 * (1.0 - s.busy_s / s.window_s)


def kernel_roofline(r):
    """% : the least time a frame's ray queries need (accounting.py) over
    the kernels' device time a frame."""
    s, peak = _traced(r), accounting.peaks(r.device_name)
    if s is None or peak is None or s.kernel_s <= 0:
        return None
    config = r.ctx.config
    tris = sum(len(read_obj(os.path.join(r.ctx.root, o["file"]))[1])
               for o in config["objects"] if o["kind"] == "mesh")
    q = accounting.frame_queries(config, tris)
    least = max(q["bytes"] / peak["hbm_bytes_per_s"], q["flop"] / peak["fp32_flop_per_s"])
    return 100.0 * least / (s.kernel_s / s.iterations)
