"""Ray accounting (counterpart of rtc_tpu/utils/profiling.py).

Both packages must count ray casts identically, since rays/s is the
metric the two are compared by.
"""

from __future__ import annotations


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
