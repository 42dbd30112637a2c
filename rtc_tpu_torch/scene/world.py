"""World container and the canonical default_world fixture (counterpart
of rtc_tpu/scene/world.py; reference: src/world.rs:13-41,
src/light.rs:5-17)."""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .materials import Material
from .shapes import Shape, sphere


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


def default_world() -> World:
    """Two-sphere book fixture (reference: src/world.rs:26-41)."""
    s1 = sphere(material=Material(color=(0.8, 1.0, 0.6), diffuse=0.7, specular=0.2))
    s2 = sphere()
    s2.set_transform(np.diag([0.5, 0.5, 0.5, 1.0]))
    return World(
        objects=[s1, s2],
        light=PointLight((-10.0, 10.0, -10.0), (1.0, 1.0, 1.0)),
    )
