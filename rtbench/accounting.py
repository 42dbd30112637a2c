"""The benchmark's own arithmetic of a frame's work: ray casts by the
wavefront integrator's accounting (copied from rtc_tpu_torch's
utils/profiling.py, which rtc_tpu shares, so rays/s stay comparable),
and the least time the frame's ray queries need on a card."""

from __future__ import annotations

import json
import os

# one Moller-Trumbore test: two cross products (18), four dot products
# (20), the reciprocal of det (1), three scalings (3), the vector o - p1 (3)
FLOP_PER_TEST = 45
RAY_BYTES = 24        # origin and direction, float32
CLOSEST_BYTES = 8     # t and the triangle row, float32 and int32
SHADOW_BYTES = 1      # the occlusion flag
TRIANGLE_BYTES = 36   # p1, e1, e2, float32


def bounce_levels(max_depth: int) -> int:
    """Shading levels the budget yields: each secondary ray costs 3."""
    levels, b = 0, max_depth
    while b >= 1:
        levels += 1
        b -= 3
    return levels


def rays_per_pixel(max_depth: int, any_reflective: bool, any_refractive: bool,
                   shadows: bool = True) -> int:
    """Ray casts a pixel: each tree node costs a closest-hit cast and a
    shadow cast; nodes branch 2-way a level where both reflection and
    refraction are live."""
    levels = bounce_levels(max_depth)
    branch = (1 if any_reflective else 0) + (1 if any_refractive else 0)
    nodes, width = 0, 1
    for _ in range(levels):
        nodes += width
        width *= max(branch, 1) if branch else 0
        if width == 0:
            break
    return max(nodes, 1) * (2 if shadows else 1)


def frame_queries(config: dict, n_triangles: int) -> dict:
    """A frame's ray queries: casts, the bytes they must move (each ray
    read once, each result written once, the triangle table read once a
    query) and their FLOP (one ray-triangle test a cast)."""
    mats = [o.get("material", {}) for o in config["objects"]]
    rpp = rays_per_pixel(config["render"]["max_depth"],
                         any(m.get("reflective", 0) > 0 for m in mats),
                         any(m.get("transparency", 0) > 0 for m in mats))
    pixels = config["canvas"]["width"] * config["canvas"]["height"]
    casts = pixels * rpp
    nodes = rpp // 2
    return {"casts": casts, "flop": casts * FLOP_PER_TEST,
            "bytes": (casts * RAY_BYTES + pixels * nodes * (CLOSEST_BYTES + SHADOW_BYTES)
                      + 2 * nodes * n_triangles * TRIANGLE_BYTES)}


def peaks(device_name: str):
    """The card's published peaks from peaks.json, or None."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")) as f:
        return json.load(f).get(device_name)
