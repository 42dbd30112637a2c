"""Axis-aligned bounding boxes for builder shapes (counterpart of
rtc_tpu/scene/bounds.py; reference: src/bounds.rs).

Per-kind object-space boxes; group boxes transform all 8 corners of each
child's box and union (src/bounds.rs:50-125). Two deliberate fixes over the
reference, both rtc_tpu's:

  * a plane's box is infinite in x/z (the reference's +-1 thin box,
    bounds.rs:20-23, could cull visible plane hits when a plane sits in a
    group);
  * the union fold starts EMPTY instead of seeded with the origin
    (bounds.rs:51-54 always contains the origin).

Host-side numpy, for scene inspection and debugging; the cluster boxes of
the mesh tables are built by scene/compile.py from the baked triangles.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .shapes import Shape

_INF = np.inf


def shape_bounds(shape: Shape) -> Tuple[np.ndarray, np.ndarray]:
    """(min, max) of `shape` in its PARENT space: a leaf's object-space box
    (its own transform is the caller's to apply), a group's union of its
    children's boxes transformed by each child's transform (as the
    reference consumes them, src/shape.rs:399-425)."""
    if shape.kind in ("sphere", "cube"):
        return np.full(3, -1.0), np.full(3, 1.0)  # (bounds.rs:16-19)
    if shape.kind == "plane":
        # infinite xz plane (fixes bounds.rs:20-23)
        return np.array([-_INF, 0.0, -_INF]), np.array([_INF, 0.0, _INF])
    if shape.kind in ("cylinder", "cone"):
        lo = shape.minimum if shape.capped else -_INF
        hi = shape.maximum if shape.capped else _INF
        if shape.kind == "cone" and np.isfinite(lo) and np.isfinite(hi):
            r = max(abs(lo), abs(hi))  # cone radius grows with |y|
            return np.array([-r, lo, -r]), np.array([r, hi, r])
        return np.array([-1.0, lo, -1.0]), np.array([1.0, hi, 1.0])
    if shape.kind == "triangle":
        pts = np.stack([shape.p1, shape.p2, shape.p3])
        return pts.min(axis=0), pts.max(axis=0)
    if shape.kind == "mesh":
        if len(shape.v1) == 0:
            return np.full(3, _INF), np.full(3, -_INF)  # empty
        pts = np.concatenate([shape.v1, shape.v2, shape.v3])
        return pts.min(axis=0), pts.max(axis=0)
    if shape.kind == "group":
        lo = np.full(3, _INF)
        hi = np.full(3, -_INF)
        for child in shape.children:
            clo, chi = shape_bounds(child)
            if np.any(clo > chi):
                continue  # empty child
            corners = _box_corners(clo, chi)
            m = child.transform
            # an infinite extent stays infinite along the image of its axis:
            # carried through the transform as +-1e30, then widened to +-inf
            if np.isfinite(corners).all():
                world = corners @ m[:3, :3].T + m[:3, 3]
            else:
                world = np.where(
                    np.isfinite(corners), corners, np.sign(corners) * 1e30
                ) @ m[:3, :3].T + m[:3, 3]
                world = np.where(np.abs(world) >= 1e29, np.sign(world) * _INF, world)
            lo = np.minimum(lo, world.min(axis=0))
            hi = np.maximum(hi, world.max(axis=0))
        return lo, hi
    raise ValueError(f"unknown shape kind {shape.kind!r}")


def _box_corners(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """All 8 corners (reference: src/bounds.rs:69-111)."""
    return np.array([
        [lo[0], lo[1], lo[2]],
        [lo[0], lo[1], hi[2]],
        [lo[0], hi[1], lo[2]],
        [lo[0], hi[1], hi[2]],
        [hi[0], lo[1], lo[2]],
        [hi[0], lo[1], hi[2]],
        [hi[0], hi[1], lo[2]],
        [hi[0], hi[1], hi[2]],
    ])
