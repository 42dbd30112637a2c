"""The shipped scenes (counterpart of rtc_tpu/models/scenes.py; reference:
src/main.rs:84-397). Only `cow` is ported; the other scenes need the
features listed in ROADMAP queue 1.

Each builder returns (World, Camera) for a canvas width, with the
reference CLI contract: height = width / 2, fov 0.785 (src/main.rs:77, 329).
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Tuple

from ..io.obj import Parser
from ..ops import transforms as X
from ..render.camera import Camera
from ..scene.materials import Material
from ..scene.world import PointLight, World

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                      "assets")


def _cam(width: int, fr, to, fov: float = 0.785) -> Camera:
    cam = Camera(width, width // 2, fov)
    cam.set_transform(X.view_transform(fr, to, [0, 1, 0]))
    return cam


# --- cow (reference: src/main.rs:328-363) -----------------------------------

def cow_world() -> World:
    cow = Parser.from_obj_file(os.path.join(ASSETS, "cow-nonormals.obj")).obj_to_group()
    cow.set_transform(X.translation(0, 3.5, 0) @ X.scaling(0.5, 0.5, 0.5))
    cow.set_material(Material(color=(1, 1, 1), ambient=0.1, diffuse=0.7, specular=0.9,
                              shininess=300.0, reflective=0.2))
    return World(objects=[cow], light=PointLight((0.0, 6.9, -5.0), (1.0, 1.0, 0.9)))


def cow(width: int = 400) -> Tuple[World, Camera]:
    return cow_world(), _cam(width, [8, 6, -8], [0, 3, 0])


REGISTRY: Dict[str, Callable[[int], Tuple[World, Camera]]] = {
    "cow": cow,
}
