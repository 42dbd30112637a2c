"""Host-side material and pattern descriptions (counterpart of
rtc_tpu/scene/materials.py; reference: src/material.rs:3-29,
src/pattern.rs:14-66).

Plain Python objects used while building a scene; compile_scene packs
them into per-object tables, and ops/patterns.py evaluates the patterns.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

# pattern kind codes, identical to rtc_tpu.ops.patterns
NONE = -1
STRIPE = 0
GRADIENT = 1
RING = 2
CHECKERS = 3
TEST = 4


@dataclasses.dataclass
class Pattern:
    """A procedural pattern with its own transform (reference:
    src/pattern.rs:14-19). kind is one of the codes above."""

    kind: int
    a: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    b: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float64)
    )

    def set_transform(self, m) -> "Pattern":
        """(reference: src/pattern.rs:63-66)"""
        self.transform = np.asarray(m, dtype=np.float64).reshape(4, 4)
        return self


def _color(c) -> Tuple[float, float, float]:
    arr = np.asarray(c, dtype=np.float64).reshape(3)
    return (float(arr[0]), float(arr[1]), float(arr[2]))


def stripe_pattern(a, b) -> Pattern:
    return Pattern(STRIPE, _color(a), _color(b))


def gradient_pattern(a, b) -> Pattern:
    return Pattern(GRADIENT, _color(a), _color(b))


def ring_pattern(a, b) -> Pattern:
    return Pattern(RING, _color(a), _color(b))


def checkers_pattern(a, b) -> Pattern:
    return Pattern(CHECKERS, _color(a), _color(b))


def test_pattern() -> Pattern:
    """(reference: src/pattern.rs:55-61)"""
    return Pattern(TEST)


test_pattern.__test__ = False  # a factory, not a pytest case


@dataclasses.dataclass
class Material:
    """Defaults exactly as the reference (src/material.rs:17-29)."""

    color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    ambient: float = 0.1
    diffuse: float = 0.9
    specular: float = 0.9
    shininess: float = 200.0
    reflective: float = 0.0
    pattern: Optional[Pattern] = None
    transparency: float = 0.0
    refractive_index: float = 1.0
