"""World container (counterpart of rtc_tpu/scene/world.py; reference:
src/world.rs:13-41, src/light.rs:5-17)."""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from .shapes import Shape


@dataclasses.dataclass
class PointLight:
    """The only light kind the reference supports (src/light.rs:5-8);
    exactly one per world."""

    position: Tuple[float, float, float]
    intensity: Tuple[float, float, float]


@dataclasses.dataclass
class World:
    objects: List[Shape] = dataclasses.field(default_factory=list)
    light: PointLight = dataclasses.field(
        default_factory=lambda: PointLight((-10.0, 10.0, -10.0), (1.0, 1.0, 1.0))
    )
