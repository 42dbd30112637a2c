"""The shipped scenes (counterpart of rtc_tpu/models/scenes.py; reference:
src/main.rs:84-397) and the benchmark configs of BASELINE.json: all 14 of
rtc_tpu's registry, under its names and in its order. The prim-only
scenes `hexagon`, `table`, `single_sphere`, `three_spheres`,
`glass_spheres` and `default_world` hold no triangle; the others are the
flat meshes `cow` and `teapot`, the smooth and glass meshes
`teapot_smooth`, `glass_teapot`, `teddy` and `pumpkin`, and the instanced
herds `cow_herd` and `cow_herd_smooth`. `TEST_WORLDS` holds the test
worlds outside the registry: the herd baked into one mesh leaf
(`cow_herd_mesh_world`), whose table streams in superblocks.

Each builder returns (World, Camera) for a canvas width, with the
reference CLI contract: height = width / 2, fov 0.785 (src/main.rs:77,
329); `single_sphere` and `default_world` are square, with fovs of their
own.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, Tuple

import numpy as np

from ..io.obj import Parser
from ..ops import transforms as X
from ..render.camera import Camera
from ..scene.materials import (Material, checkers_pattern, gradient_pattern,
                               stripe_pattern)
from ..scene.shapes import (cube, cylinder, glass_sphere, group, mesh, plane,
                            sphere)
from ..scene.world import PointLight, World, default_world

PI = math.pi

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                      "assets")


def _cam(width: int, fr, to, fov: float = 0.785) -> Camera:
    cam = Camera(width, width // 2, fov)
    cam.set_transform(X.view_transform(fr, to, [0, 1, 0]))
    return cam


def _mm(*ms):
    out = np.asarray(ms[0], dtype=np.float64)
    for m in ms[1:]:
        out = out @ np.asarray(m, dtype=np.float64)
    return out


def _light() -> PointLight:
    return PointLight((0.0, 6.9, -5.0), (1.0, 1.0, 0.9))


# --- hexagon (reference: src/main.rs:84-146) --------------------------------

def hexagon_world() -> World:
    def corner():
        return sphere(transform=_mm(X.translation(0, 0, -1), X.scaling(0.25, 0.25, 0.25)))

    def edge():
        return cylinder(
            0.0, 1.0, True,
            transform=_mm(
                X.translation(0, 0, -1),
                X.rotation_y(-PI / 6),
                X.rotation_z(-PI / 2),
                X.scaling(0.25, 1.0, 0.25),
            ),
        )

    sides = []
    for i in range(6):
        side = group([corner(), edge()])
        side.set_transform(X.rotation_y(i * PI / 3))
        sides.append(side)
    hexagon = group(sides)
    hexagon.set_transform(X.scaling(2.5, 2.5, 2.5))
    return World(objects=[hexagon], light=_light())


def hexagon(width: int = 400) -> Tuple[World, Camera]:
    return hexagon_world(), _cam(width, [8, 6, -8], [0, 0, 0])


# --- table (reference: src/main.rs:151-323) ---------------------------------

def table_world() -> World:
    objects = []

    floor_ceiling = cube(transform=_mm(X.scaling(20, 7, 20), X.translation(0, 1, 0.1)))
    pat = checkers_pattern((0, 0, 0), (0.25, 0.25, 0.25)).set_transform(
        X.scaling(0.07, 0.07, 0.07))
    floor_ceiling.material = Material(
        pattern=pat, ambient=0.25, diffuse=0.7, specular=0.9, shininess=300.0,
        reflective=0.1)
    objects.append(floor_ceiling)

    walls = cube(transform=X.scaling(10, 10, 10))
    pat = checkers_pattern(
        (0.4863, 0.3765, 0.2941), (0.3725, 0.2902, 0.2275)
    ).set_transform(X.scaling(0.05, 20.0, 0.05))
    walls.material = Material(pattern=pat, ambient=0.1, diffuse=0.7, specular=0.9,
                              shininess=300.0, reflective=0.1)
    objects.append(walls)

    table_top = cube(transform=_mm(X.translation(0, 3.1, 0), X.scaling(3, 0.1, 2)))
    pat = stripe_pattern((0.5529, 0.4235, 0.3255), (0.6588, 0.5098, 0.4000)).set_transform(
        _mm(X.scaling(0.05, 0.05, 0.05), X.rotation_y(0.1)))
    table_top.material = Material(pattern=pat, ambient=0.1, diffuse=0.7, specular=0.9,
                                  shininess=300.0, reflective=0.2)
    objects.append(table_top)

    for sx, sz in ((2.7, -1.7), (2.7, 1.7), (-2.7, -1.7), (-2.7, 1.7)):
        leg = cube(transform=_mm(X.translation(sx, 1.5, sz), X.scaling(0.1, 1.5, 0.1)))
        leg.material = Material(color=(0.5529, 0.4235, 0.3255), ambient=0.2, diffuse=0.7)
        objects.append(leg)

    glass_cube = cube(transform=_mm(
        X.translation(0, 3.45001, 0), X.rotation_y(0.2), X.scaling(0.25, 0.25, 0.25)))
    glass_cube.material = Material(
        color=(1, 1, 0.8), ambient=0.0, diffuse=0.3, specular=0.9, shininess=300.0,
        reflective=0.1, transparency=0.7, refractive_index=1.5)
    objects.append(glass_cube)

    little = [
        ((1.0, 3.35, -0.9), -0.4, (0.15, 0.15, 0.15), (1.0, 0.5, 0.5), 0.6, 0.4),
        ((-1.5, 3.27, 0.3), 0.4, (0.15, 0.7, 0.15), (1.0, 1.0, 0.5), None, None),
        ((0.0, 3.25, 1.0), 0.4, (0.2, 0.05, 0.05), (0.5, 1.0, 0.5), None, None),
        ((-0.6, 3.4, -1.0), 0.8, (0.05, 0.2, 0.05), (0.5, 0.5, 1.0), None, None),
        ((2.0, 3.4, 1.0), 0.8, (0.05, 0.2, 0.05), (0.5, 1.0, 1.0), None, None),
    ]
    for pos, ry, scale, color, refl, diff in little:
        c = cube(transform=_mm(X.translation(*pos), X.rotation_y(ry), X.scaling(*scale)))
        kw = dict(color=color)
        if refl is not None:
            kw["reflective"] = refl
        if diff is not None:
            kw["diffuse"] = diff
        c.material = Material(**kw)
        objects.append(c)

    frames = [
        ((-10.0, 4.0, 1.0), (0.05, 1.0, 1.0), (0.7098, 0.2471, 0.2196)),
        ((-10.0, 3.4, 2.7), (0.05, 0.4, 0.4), (0.2667, 0.2706, 0.6902)),
        ((-10.0, 4.6, 2.7), (0.05, 0.4, 0.4), (0.3098, 0.5961, 0.3098)),
    ]
    for pos, scale, color in frames:
        f = cube(transform=_mm(X.translation(*pos), X.scaling(*scale)))
        f.material = Material(color=color, diffuse=0.6)
        objects.append(f)

    mirror_frame = cube(transform=_mm(X.translation(-2, 3.5, 9.95), X.scaling(5, 1.5, 0.05)))
    mirror_frame.material = Material(color=(0.3882, 0.2627, 0.1882), diffuse=0.7)
    objects.append(mirror_frame)

    mirror = cube(transform=_mm(X.translation(-2, 3.5, 9.95), X.scaling(4.8, 1.4, 0.06)))
    mirror.material = Material(color=(0, 0, 0), diffuse=0.0, ambient=0.0, specular=0.0,
                               shininess=300.0, reflective=1.0)
    objects.append(mirror)

    return World(objects=objects, light=_light())


def table(width: int = 400) -> Tuple[World, Camera]:
    return table_world(), _cam(width, [8, 6, -8], [0, 3, 0])


# --- cow (reference: src/main.rs:328-363) -----------------------------------

def cow_world() -> World:
    cow = Parser.from_obj_file(os.path.join(ASSETS, "cow-nonormals.obj")).obj_to_group()
    cow.set_transform(X.translation(0, 3.5, 0) @ X.scaling(0.5, 0.5, 0.5))
    cow.set_material(Material(color=(1, 1, 1), ambient=0.1, diffuse=0.7, specular=0.9,
                              shininess=300.0, reflective=0.2))
    return World(objects=[cow], light=_light())


def cow(width: int = 400) -> Tuple[World, Camera]:
    return cow_world(), _cam(width, [8, 6, -8], [0, 3, 0])


# --- smooth and glass meshes (rtc_tpu/models/scenes.py:193-237, 332-340) -----

def _teapot(smooth: bool = True):
    return Parser.from_obj_file(os.path.join(ASSETS, "teapot.obj")).obj_to_group(
        smooth=smooth)


def teapot_world() -> World:
    """The reference's teapot, flat-shaded (src/main.rs:368-397; rtc_tpu
    scenes.py:181-190)."""
    t = _teapot(smooth=False)
    t.set_transform(X.translation(0, -1.5, 0))
    t.set_material(Material(pattern=gradient_pattern((0, 1, 0), (0, 0, 1))))
    return World(objects=[t], light=_light())


def teapot(width: int = 400) -> Tuple[World, Camera]:
    return teapot_world(), _cam(width, [0, 4, -12], [0, 0, 0])


def pumpkin(width: int = 400) -> Tuple[World, Camera]:
    """pumpkin_tall_10k.obj, smooth-shaded (rtc_tpu scenes.py:240-259): the
    mesh sits near (-3, 1, -110) at radius ~40, so it is recentred and
    scaled."""
    shape = Parser.from_obj_file(
        os.path.join(ASSETS, "pumpkin_tall_10k.obj")).obj_to_group(smooth=True)
    shape.set_transform(_mm(X.translation(0, 3.0, 0), X.scaling(0.06, 0.06, 0.06),
                            X.translation(2.6, -0.9, 110.0)))
    shape.set_material(Material(color=(0.95, 0.55, 0.12), ambient=0.1,
                                diffuse=0.8, specular=0.4, shininess=50.0))
    return World(objects=[shape], light=_light()), _cam(width, [8, 6, -8], [0, 3, 0])


def teapot_smooth_world() -> World:
    """The teapot with per-vertex normals and Phong-interpolated shading,
    the capability the reference stubs out (src/obj_file.rs:295-335)."""
    t = _teapot()
    t.set_transform(X.translation(0, -1.5, 0))
    t.set_material(Material(pattern=gradient_pattern((0, 1, 0), (0, 0, 1))))
    return World(objects=[t], light=_light())


def teapot_smooth(width: int = 400) -> Tuple[World, Camera]:
    return teapot_smooth_world(), _cam(width, [0, 4, -12], [0, 0, 0])


def glass_teapot_world() -> World:
    """The smooth teapot in glass (transparency 0.9, ior 1.5) over a
    checkered plane: a closed transparent mesh is an n1/n2 container."""
    t = _teapot()
    t.set_transform(X.translation(0, -1.0, 0))
    t.set_material(Material(
        color=(0.05, 0.08, 0.05), ambient=0.02, diffuse=0.15, specular=0.9,
        shininess=300.0, reflective=0.1, transparency=0.9,
        refractive_index=1.5))
    floor = plane(
        transform=X.translation(0, -1.0, 0),
        material=Material(
            pattern=checkers_pattern(
                (0.85, 0.85, 0.85), (0.15, 0.15, 0.15)
            ).set_transform(_mm(X.scaling(4.0, 4.0, 4.0),
                                X.translation(0.0, 0.5, 0.0))),
            specular=0.0, reflective=0.05))
    return World(objects=[floor, t], light=_light())


def glass_teapot(width: int = 400) -> Tuple[World, Camera]:
    return glass_teapot_world(), _cam(width, [0, 4, -12], [0, 0, 0])


def teddy(width: int = 400) -> Tuple[World, Camera]:
    """teddy.obj with smooth shading."""
    shape = Parser.from_obj_file(os.path.join(ASSETS, "teddy.obj")).obj_to_group(
        smooth=True)
    shape.set_transform(_mm(X.translation(0, 3.0, 0), X.scaling(0.15, 0.15, 0.15),
                            X.rotation_y(math.pi)))
    shape.set_material(Material(color=(0.6, 0.4, 0.2), diffuse=0.8, specular=0.3))
    return World(objects=[shape], light=_light()), _cam(width, [8, 6, -8], [0, 3, 0])


# --- instanced herds (rtc_tpu/models/scenes.py:262-301) ---------------------

def cow_herd_world(nx: int = 10, nz: int = 9, smooth: bool = False) -> World:
    """An nx x nz grid of cows (default 90 cows, 522,360 triangles), each
    its own mesh leaf sharing one object-space mesh: the world compiles to
    instanced (TLAS) tables. Spacing and heading vary so that the
    instances' boxes do not line up."""
    parser = Parser.from_obj_file(os.path.join(ASSETS, "cow-nonormals.obj"))
    cows = []
    for i in range(nx):
        for j in range(nz):
            c = parser.obj_to_group(smooth=smooth)
            c.set_transform(_mm(
                X.translation(3.0 * (i - (nx - 1) / 2.0), 3.5,
                              3.0 * j + 0.7 * ((i * 7 + j * 3) % 5)),
                X.rotation_y(0.6 * ((i * 5 + j) % 7)),
                X.scaling(0.5, 0.5, 0.5)))
            c.set_material(Material(
                color=(0.9, 0.85 - 0.04 * (j % 3), 0.8 - 0.05 * (i % 4)),
                ambient=0.1, diffuse=0.8, specular=0.3, shininess=50.0))
            cows.append(c)
    return World(objects=cows, light=PointLight((0.0, 30.0, -20.0),
                                                (1.0, 1.0, 0.9)))


def _herd_cam(width: int) -> Camera:
    return _cam(width, [0, 14, -24], [0, 3, 10])


def cow_herd(width: int = 400) -> Tuple[World, Camera]:
    return cow_herd_world(), _herd_cam(width)


def cow_herd_smooth_world(nx: int = 10, nz: int = 9) -> World:
    """cow_herd with per-vertex normals: smooth shading through the
    instanced path."""
    return cow_herd_world(nx, nz, smooth=True)


def cow_herd_smooth(width: int = 400) -> Tuple[World, Camera]:
    return cow_herd_smooth_world(), _herd_cam(width)


# --- benchmark extras (BASELINE.json configs; rtc_tpu scenes.py:316-380) ----

def _square_cam(width: int, fr, fov: float) -> Camera:
    cam = Camera(width, width, fov)
    cam.set_transform(X.view_transform(fr, [0, 0, 0], [0, 1, 0]))
    return cam


def single_sphere_world() -> World:
    s = sphere(material=Material(color=(1.0, 0.2, 1.0)))
    return World(objects=[s], light=PointLight((-10, 10, -10), (1, 1, 1)))


def single_sphere(width: int = 256) -> Tuple[World, Camera]:
    return single_sphere_world(), _square_cam(width, [0, 0, -3], PI / 3)


def three_spheres_world() -> World:
    """Multi-sphere world with floor plane, shadows, patterns (BASELINE
    config 2)."""
    # checkers shifted off y=0 so the floor doesn't sit on a parity knife-edge
    floor = plane(material=Material(
        color=(1, 0.9, 0.9), specular=0.0,
        pattern=checkers_pattern((1, 0.9, 0.9), (0.2, 0.2, 0.25)).set_transform(
            X.translation(0.0, 0.5, 0.0))))
    middle = sphere(transform=X.translation(-0.5, 1, 0.5), material=Material(
        color=(0.1, 1, 0.5), diffuse=0.7, specular=0.3,
        pattern=stripe_pattern((0.1, 1, 0.5), (0.9, 0.2, 0.2))))
    right = sphere(transform=_mm(X.translation(1.5, 0.5, -0.5), X.scaling(0.5, 0.5, 0.5)),
                   material=Material(color=(0.5, 1, 0.1), diffuse=0.7, specular=0.3))
    left = sphere(transform=_mm(X.translation(-1.5, 0.33, -0.75), X.scaling(0.33, 0.33, 0.33)),
                  material=Material(color=(1, 0.8, 0.1), diffuse=0.7, specular=0.3))
    return World(objects=[floor, middle, right, left],
                 light=PointLight((-10, 10, -10), (1, 1, 1)))


def three_spheres(width: int = 400) -> Tuple[World, Camera]:
    return three_spheres_world(), _cam(width, [0, 1.5, -5], [0, 1, 0], fov=PI / 3)


def glass_spheres_world() -> World:
    """Reflective+refractive stress scene (BASELINE config 3)."""
    floor = plane(material=Material(
        pattern=checkers_pattern((0.8, 0.8, 0.8), (0.2, 0.2, 0.2)).set_transform(
            X.translation(0.0, 0.5, 0.0)),
        reflective=0.2))
    outer = glass_sphere(transform=X.translation(0, 1, 0))
    outer.material.reflective = 0.9
    outer.material.color = (0.1, 0.1, 0.1)
    outer.material.diffuse = 0.1
    inner = sphere(transform=_mm(X.translation(0, 1, 0), X.scaling(0.5, 0.5, 0.5)),
                   material=Material(transparency=1.0, refractive_index=1.0,
                                     diffuse=0.1, color=(0.1, 0.1, 0.1)))
    return World(objects=[floor, outer, inner],
                 light=PointLight((-10, 10, -10), (1, 1, 1)))


def glass_spheres(width: int = 400) -> Tuple[World, Camera]:
    return glass_spheres_world(), _cam(width, [0, 1.5, -5], [0, 1, 0], fov=PI / 3)


def default_world_scene(width: int = 400) -> Tuple[World, Camera]:
    return default_world(), _square_cam(width, [0, 0, -5], PI / 2)


def baked_meshes(world: World):
    """Every mesh leaf of a world baked into world space, concatenated:
    (v1, v2, v3, vn1, vn2, vn3) as (T, 3) float64 arrays, the normals None
    unless the meshes are smooth. Vertices are pushed through each leaf's
    transform as the compiler bakes them; corner normals through its
    inverse-transpose (row-vector form), then made unit."""
    leaves = []

    def walk(s):
        if s.kind == "group":
            for c in s.children:
                walk(c)
        elif s.kind == "mesh":
            leaves.append(s)

    for obj in world.objects:
        walk(obj)
    smooth = leaves[0].vn1 is not None
    out = [[] for _ in range(6 if smooth else 3)]
    for s in leaves:
        m = s.transform
        inv = np.linalg.inv(m)
        for k, v in enumerate((s.v1, s.v2, s.v3)):
            out[k].append(v @ m[:3, :3].T + m[:3, 3])
        if smooth:
            for k, vn in enumerate((s.vn1, s.vn2, s.vn3)):
                n = vn @ inv[:3, :3]
                out[3 + k].append(n / np.linalg.norm(n, axis=1, keepdims=True))
    arrays = [np.concatenate(a) for a in out]
    return tuple(arrays) + (() if smooth else (None, None, None))


def cow_herd_mesh_world(nx: int = 10, nz: int = 9, smooth: bool = False) -> World:
    """cow_herd's geometry baked into ONE mesh leaf (a test world, not in
    the registry): a single leaf is never instanced, so its table (the
    90-cow herd: 522,360 triangles, 4,088 clusters, 11 superblocks of
    rtc_tpu's VMEM budget) streams through the superblock drivers, as
    rtc_tpu streams it. The herd's light; one material, the first cow's."""
    herd = cow_herd_world(nx, nz, smooth)
    first = herd.objects[0]
    while first.kind == "group":
        first = first.children[0]
    return World(objects=[mesh(*baked_meshes(herd), material=first.material)],
                 light=herd.light)


# test worlds outside the registry, under cow_herd's camera
TEST_WORLDS: Dict[str, Callable[[int], Tuple[World, Camera]]] = {
    "cow_herd_mesh": lambda width: (cow_herd_mesh_world(), _herd_cam(width)),
    "cow_herd_mesh_smooth": lambda width: (cow_herd_mesh_world(smooth=True),
                                           _herd_cam(width)),
}


REGISTRY: Dict[str, Callable[[int], Tuple[World, Camera]]] = {
    "hexagon": hexagon,
    "table": table,
    "cow": cow,
    "teapot": teapot,
    "teapot_smooth": teapot_smooth,
    "glass_teapot": glass_teapot,
    "pumpkin": pumpkin,
    "teddy": teddy,
    "cow_herd": cow_herd,
    "cow_herd_smooth": cow_herd_smooth,
    "single_sphere": single_sphere,
    "three_spheres": three_spheres,
    "glass_spheres": glass_spheres,
    "default_world": default_world_scene,
}
