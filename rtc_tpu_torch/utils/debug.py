"""Debugging and validation utilities (counterpart of rtc_tpu/utils/debug.py).

The reference's only "sanitizer" is Rust's borrow checker plus panics on
invariant violations (src/shape.rs:200-204, obj_file.rs:42). Here:

  * `validate_world` front-loads the host-side checks the reference
    scatters through panics (invertible transforms, sane material ranges,
    exactly one light), with rtc_tpu's messages;
  * `nan_debug` (rtc_tpu's jax_debug_nans) raises at the first operation
    whose floating output holds a NaN, forward or backward;
  * `checked_color_at` (rtc_tpu's checkify) returns an error object beside
    the colours, which raises or reports only when a colour is not finite.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import numpy as np
import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..render import integrator


def validate_world(world) -> List[str]:
    """Return a list of problems (empty == valid). Raises nothing."""
    problems: List[str] = []
    if world.light is None:
        problems.append("world has no light (exactly one point light required)")

    def walk(shape, path):
        if shape.kind == "group":
            for i, c in enumerate(shape.children):
                walk(c, f"{path}.children[{i}]")
            return
        det = np.linalg.det(shape.transform)
        if not np.isfinite(det) or abs(det) < 1e-12:
            problems.append(f"{path}: transform is singular (det={det:g}) "
                            f"(reference panics at src/shape.rs:215)")
        m = shape.material
        for name in ("ambient", "diffuse", "specular", "reflective", "transparency"):
            v = getattr(m, name)
            if not np.isfinite(v) or v < 0:
                problems.append(f"{path}: material.{name}={v} out of range")
        if m.refractive_index <= 0:
            problems.append(f"{path}: refractive_index must be positive")
        if shape.kind in ("cylinder", "cone") and shape.minimum > shape.maximum:
            problems.append(f"{path}: minimum > maximum")
        if shape.kind == "mesh" and shape.v1 is not None:
            if not (len(shape.v1) == len(shape.v2) == len(shape.v3)):
                problems.append(f"{path}: mesh corner arrays disagree in length")

    for i, obj in enumerate(world.objects):
        walk(obj, f"objects[{i}]")
    return problems


class _NanCheck(TorchDispatchMode):
    """Runs every operation, then raises FloatingPointError naming it when
    a floating output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in _pytree.tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def nan_debug():
    """Raise at the first operation that makes a NaN in the enclosed block,
    and have autograd's anomaly mode name the forward operation of a
    backward that does. Every operation waits for its NaN check, so this
    is for debugging only."""
    with torch.autograd.set_detect_anomaly(True), _NanCheck():
        yield


class CheckedError:
    """checkify's error value: get() is the message or None, throw()
    raises FloatingPointError with it, if there is one."""

    def __init__(self, message: Optional[str]):
        self._message = message

    def get(self) -> Optional[str]:
        return self._message

    def throw(self) -> None:
        if self._message is not None:
            raise FloatingPointError(self._message)


def checked_color_at(scene, o, d, cfg):
    """color_at with a check of its output: returns (error, colors);
    error.throw() raises if a colour is NaN or infinite."""
    with torch.no_grad():
        colors = integrator.color_at(scene, o, d, cfg)
        bad = int((~torch.isfinite(colors)).sum())
    message = (f"non-finite color output ({bad} of {colors.numel()} values)"
               if bad else None)
    return CheckedError(message), colors
