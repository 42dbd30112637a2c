"""The benchmark's own arithmetic of a frame's prim queries: the work the
prim kernel (rtc_tpu_torch's prim_sweep_kernel, one thread a ray over
every prim, each tested by its own kind) must do for a frame of a
configuration without meshes, and the least time it needs on a card.

Queries: at each shading node of the ray tree (accounting.rays_per_pixel,
a closest-hit and a shadow cast a node), one closest and one any sweep
of every pixel's ray over every prim. Bytes: each sweep reads its rays
(o and d, float32, 24 B), the any sweep its rays' max_t (4 B), and each
writes its result once (t and the prim, 8 B; the flag, 1 B); the prims'
tables (60 B a prim) are left out, read once a block from the cache.
FLOP: per ray and prim, only the arithmetic the kernel's source does for
that prim's own kind: the 3x4 affine of the origin (18) and the 3x3 of
the direction (15), and the kind's test; an FMA counts 2, a division or
square root 1, and a comparison, min, max, select, abs or negation
none."""

from __future__ import annotations

from . import accounting

RAY_BYTES = 24
MAX_T_BYTES = 4
CLOSEST_BYTES = 8
SHADOW_BYTES = 1
AFFINE_FLOP = 18 + 15
# the kind's test, by the kernel's prim_slots
KIND_FLOP = {
    # a, b, c (5, 6, 6) and the quadratic (disc 4, sqrt 1, 2a 1, roots 4)
    "sphere": 27,
    # -o.y / d.y
    "plane": 1,
    # each axis: -1 - o, 1 - o, and the two divisions
    "cube": 12,
}


def frame_queries(config: dict):
    """A frame's prim queries: {"queries": ray-prim tests, "bytes",
    "flop"}, or None for a configuration with a mesh or a kind the count
    does not hold."""
    kinds = [o["kind"] for o in config["objects"]]
    if not kinds or any(k not in KIND_FLOP for k in kinds):
        return None
    mats = [o.get("material", {}) for o in config["objects"]]
    rpp = accounting.rays_per_pixel(config["render"]["max_depth"],
                                    any(m.get("reflective", 0) > 0 for m in mats),
                                    any(m.get("transparency", 0) > 0 for m in mats))
    rays = config["canvas"]["width"] * config["canvas"]["height"] * (rpp // 2)
    per_ray = sum(AFFINE_FLOP + KIND_FLOP[k] for k in kinds)
    return {"queries": 2 * rays * len(kinds),
            "bytes": rays * (2 * RAY_BYTES + MAX_T_BYTES + CLOSEST_BYTES + SHADOW_BYTES),
            "flop": 2 * rays * per_ray}
