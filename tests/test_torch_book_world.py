"""The book's scene tables against rtc_tpu_torch on the CPU in float64:
intersections and prepare_computations, shapes, the world's shading,
the camera, the light and the OBJ parser (the expectations of
tests/test_intersections.py, test_shapes.py, test_world.py,
test_camera.py, test_canvas.py's light case and test_obj.py, with their
numbers and the book's 1e-5), through rtc_tpu_torch.testing and the
public intersect_all/hit_index; each testing helper against rtc_tpu's on
the book's cases; and camera_rays on the camera matrix's device."""

import dataclasses
import math
import os
import textwrap

import numpy as np
import pytest
import torch

from conftest import assert_almost_eq
from rtc_tpu import testing as jax_testing
from rtc_tpu.scene import shapes as JS
from rtc_tpu.scene.compile import compile_scene as jax_compile_scene
from rtc_tpu.scene.materials import Material as JaxMaterial
from rtc_tpu.scene.materials import test_pattern as jax_test_pattern
from rtc_tpu.scene.world import PointLight as JaxPointLight
from rtc_tpu.scene.world import default_world as jax_default_world
from rtc_tpu_torch import (Camera, Intersections, default_world, hit_index,
                           intersect_all, render, testing)
from rtc_tpu_torch.io.obj import Parser, load_obj
from rtc_tpu_torch.ops import transforms as X
from rtc_tpu_torch.render import integrator
from rtc_tpu_torch.render.camera import camera_rays, camera_rays_for_pixels
from rtc_tpu_torch.scene import shapes as S
from rtc_tpu_torch.scene.compile import compile_scene
from rtc_tpu_torch.scene.materials import Material, test_pattern
from rtc_tpu_torch.scene.world import PointLight, World
from rtc_tpu_torch.utils.config import RenderConfig
from rtc_tpu_torch.utils.constants import EPSILON, is_almost_equal

torch.set_num_threads(2)

PI = math.pi
S2 = math.sqrt(2.0)
S3 = math.sqrt(3.0)
CPU = dict(device="cpu")
F64 = torch.float64
CFG = RenderConfig(dtype="float64")
RECURSION_LIMIT = 5
WHITE = (1.0, 1.0, 1.0)
FILES = os.path.join(os.path.dirname(__file__), "files")
ASSETS = os.path.join(os.path.dirname(__file__), "..", "assets")


def compiled(w, **kw):
    return compile_scene(w, dtype=F64, **CPU, **kw)


def rays(o, d):
    return torch.tensor([o], dtype=F64), torch.tensor([d], dtype=F64)


def xs_of(shape, origin, direction):
    return testing.intersect_shape(shape, origin, direction, **CPU)


def normal_at(shape, point):
    return testing.normal_at(shape, point, **CPU)


# --- hit() (tests/test_intersections.py; src/intersection.rs:158-200) ---------

@pytest.mark.parametrize("ts,expected", [
    ([1.0, 2.0], 0), ([-1.0, 1.0], 1), ([-2.0, -1.0], None), ([5.0, 7.0, -3.0, 2.0], 3),
], ids=["all_positive", "some_negative", "all_negative", "lowest_nonnegative"])
def test_the_hit(ts, expected):
    assert testing.hit(ts) == expected


# --- prepare_computations -----------------------------------------------------

def test_precomputing_the_state_of_an_intersection():
    c = testing.comps_at(compiled(World(objects=[S.sphere()])), [0, 0, -5], [0, 0, 1],
                         4.0, **CPU)
    assert_almost_eq(c.point, [0, 0, -1])
    assert_almost_eq(c.eyev, [0, 0, -1])
    assert_almost_eq(c.normalv, [0, 0, -1])
    assert not bool(c.inside)


def test_precomputing_the_reflection_vector():
    c = testing.comps_at(compiled(World(objects=[S.plane()])), [0, 1, -1],
                         [0, -S2 / 2, S2 / 2], S2, **CPU)
    assert_almost_eq(c.reflectv, [0, S2 / 2, S2 / 2])


def test_the_hit_when_an_intersection_occurs_on_the_inside():
    c = testing.comps_at(compiled(World(objects=[S.sphere()])), [0, 0, 0], [0, 0, 1],
                         1.0, **CPU)
    assert_almost_eq(c.point, [0, 0, 1])
    assert_almost_eq(c.eyev, [0, 0, -1])
    assert bool(c.inside)
    assert_almost_eq(c.normalv, [0, 0, -1])  # (0, 0, 1), inverted


def test_the_hit_should_offset_the_point():
    s = S.sphere()
    s.set_transform(X.translation(0, 0, 1))
    c = testing.comps_at(compiled(World(objects=[s])), [0, 0, -5], [0, 0, 1], 5.0, **CPU)
    assert c.over_point[2] < -EPSILON / 2
    assert c.point[2] > c.over_point[2]


def test_the_under_point_is_offset_below_the_surface():
    s = S.glass_sphere()
    s.set_transform(X.translation(0, 0, 1))
    c = testing.comps_at(compiled(World(objects=[s])), [0, 0, -5], [0, 0, 1], 5.0, **CPU)
    assert c.under_point[2] > EPSILON / 2
    assert c.point[2] < c.under_point[2]


def _glass_ladder(mode="refractive"):
    """Three nested glass spheres (src/intersection.rs:287-325)."""
    a = S.glass_sphere(transform=X.scaling(2, 2, 2))
    a.material = dataclasses.replace(a.material, refractive_index=1.5)
    b = S.glass_sphere(transform=X.translation(0, 0, -0.25))
    b.material = dataclasses.replace(b.material, refractive_index=2.0)
    c = S.glass_sphere(transform=X.translation(0, 0, 0.25))
    c.material = dataclasses.replace(c.material, refractive_index=2.5)
    return compiled(World(objects=[a, b, c]), containers=mode)


LADDER = [((2.0, 0), (1.0, 1.5)), ((2.75, 1), (1.5, 2.0)), ((3.25, 2), (2.0, 2.5)),
          ((4.75, 1), (2.5, 2.5)), ((5.25, 2), (2.5, 1.5)), ((6.0, 0), (1.5, 1.0))]


def test_finding_n1_and_n2_at_various_intersections():
    scene = _glass_ladder()
    for (t, prim), (n1, n2) in LADDER:
        c = testing.comps_at(scene, [0, 0, -4], [0, 0, 1], t, prim_id=prim, **CPU)
        assert_almost_eq(c.n1, n1)
        assert_almost_eq(c.n2, n2)


# --- Schlick (src/intersection.rs:340-379) ------------------------------------

def _schlick(c):
    cos, n1, n2 = (torch.tensor([v], dtype=F64) for v in (np.dot(c.eyev, c.normalv),
                                                          c.n1, c.n2))
    return float(integrator.schlick(cos, n1, n2)[0])


SCHLICK = [([0, 0, S2 / 2], [0, 1, 0], S2 / 2, 1.0, 0.0),
           ([0, 0, 0], [0, 1, 0], 1.0, 0.04, 1e-5),
           ([0, 0.99, -2], [0, 0, 1], 1.8589, 0.48873, 1e-5)]


@pytest.mark.parametrize("origin,direction,t,expected,eps", SCHLICK,
                         ids=["total_internal_reflection", "perpendicular",
                              "small_angle_n2_gt_n1"])
def test_the_schlick_approximation(origin, direction, t, expected, eps):
    c = testing.comps_at(compiled(World(objects=[S.glass_sphere()])), origin, direction, t,
                         **CPU)
    if eps == 0.0:
        assert _schlick(c) == expected
    else:
        assert_almost_eq(_schlick(c), expected, eps=eps)


# --- the public intersection-list API (src/world.rs:43-54) --------------------

def test_intersect_all_world_sorted():
    xs = intersect_all(compiled(default_world()), *rays([0.0, 0.0, -5.0], [0.0, 0.0, 1.0]),
                       CFG)
    v = xs.valid[0].numpy()
    assert int(v.sum()) == 4
    assert_almost_eq(xs.t[0].numpy()[v], [4.0, 4.5, 5.5, 6.0])
    assert list(xs.obj[0].numpy()[v]) == [0, 1, 1, 0]


def test_intersect_all_k_truncates():
    xs = intersect_all(compiled(default_world()), *rays([0.0, 0.0, -5.0], [0.0, 0.0, 1.0]),
                       CFG, k=2)
    assert xs.t.shape == (1, 2)
    assert_almost_eq(xs.t[0].numpy(), [4.0, 4.5])


def _sphere_and_triangle():
    tri = S.triangle([-1, -1, 1], [1, -1, 1], [0, 1, 1])  # the plane z = 1
    return compiled(World(objects=[S.sphere(transform=X.translation(0, 0, 4)), tri]))


def test_intersect_all_merges_prims_and_triangles():
    xs = intersect_all(_sphere_and_triangle(), *rays([0.0, 0.0, -2.0], [0.0, 0.0, 1.0]), CFG)
    v = xs.valid[0].numpy()
    assert_almost_eq(xs.t[0].numpy()[v], [3.0, 5.0, 7.0])
    assert list(xs.obj[0].numpy()[v]) == [1, 0, 0]  # the triangle is object 1


def test_hit_index_semantics():
    t = torch.tensor([[1.0, 2.0], [-1.0, 1.0], [-2.0, -1.0], [-3.0, 2.0]], dtype=F64)
    xs = Intersections(t=t, obj=torch.zeros_like(t, dtype=torch.int32),
                       valid=torch.ones_like(t, dtype=torch.bool))
    assert xs.u is None and xs.v is None
    assert hit_index(xs).tolist() == [0, 1, -1, 1]


def test_intersect_all_keeps_negative_ts():
    xs = intersect_all(compiled(World(objects=[S.sphere()])),
                       *rays([0.0, 0.0, 0.0], [0.0, 0.0, 1.0]), CFG)
    assert_almost_eq(xs.t[0].numpy()[xs.valid[0].numpy()], [-1.0, 1.0])
    assert int(hit_index(xs)[0]) == 1


def test_intersect_all_surfaces_triangle_uv():
    tri = S.triangle([0, 1, 0], [-1, 0, 0], [1, 0, 0])
    xs = intersect_all(compiled(World(objects=[tri])), *rays([-0.2, 0.3, -2.0], [0.0, 0.0, 1.0]),
                       CFG)
    i = int(hit_index(xs)[0])
    assert i >= 0
    assert_almost_eq(float(xs.u[0, i]), 0.45)
    assert_almost_eq(float(xs.v[0, i]), 0.25)


def test_intersect_all_uv_zero_on_analytic_prims():
    xs = intersect_all(_sphere_and_triangle(), *rays([0.0, -0.5, -2.0], [0.0, 0.0, 1.0]), CFG)
    v = xs.valid[0].numpy()
    objs, us, vs = (a[0].numpy()[v] for a in (xs.obj, xs.u, xs.v))
    tri_rows = objs == 1
    assert tri_rows.any() and (~tri_rows).any()
    assert (us[~tri_rows] == 0.0).all() and (vs[~tri_rows] == 0.0).all()
    assert (us[tri_rows] > 0).all() and (vs[tri_rows] > 0).all()
    p = (np.array([-1.0, -1.0, 1.0]) + us[tri_rows][0] * np.array([2.0, 0, 0])
         + vs[tri_rows][0] * np.array([1.0, 2.0, 0]))
    assert_almost_eq(p, [0.0, -0.5, 1.0])


# --- the containers modes (src/intersection.rs:29-62) -------------------------

def _containers_fixture(mode):
    outer = S.sphere(transform=X.scaling(2, 2, 2))
    outer.material = Material(transparency=1.0, refractive_index=1.5)
    inner = S.sphere(transform=X.scaling(0.5, 0.5, 0.5))
    inner.material = Material(transparency=0.0, refractive_index=1.0)
    scene = compiled(World(objects=[outer, inner]), containers=mode)
    o, d = rays([0.0, 0.0, 0.0], [0.0, 0.0, 1.0])
    hit = integrator.closest_hit(scene, o, d, CFG)
    assert_almost_eq(float(hit.t[0]), 0.5)  # the inner sphere's far wall
    n1, n2 = integrator.refraction_indices(scene, o, d, hit, CFG)
    return float(n1[0]), float(n2[0])


@pytest.mark.parametrize("mode,expected", [("all", (1.0, 1.5)), ("refractive", (1.5, 1.0))],
                         ids=["all_matches_reference_walk", "refractive_default_diverges"])
def test_containers_modes(mode, expected):
    assert _containers_fixture(mode) == expected


def test_containers_all_matches_default_on_refractive_only_scene():
    o, d = rays([0.0, 0.0, -4.0], [0.0, 0.0, 1.0])
    for mode in ("refractive", "all"):
        scene = _glass_ladder(mode)
        hit = integrator.closest_hit(scene, o, d, CFG)
        n1, n2 = integrator.refraction_indices(scene, o, d, hit, CFG)
        assert_almost_eq(float(n1[0]), 1.0)
        assert_almost_eq(float(n2[0]), 1.5)


# --- shapes: spheres (tests/test_shapes.py; src/shape.rs:648-1653) ------------

def test_the_default_transformation():
    assert_almost_eq(S.sphere().transform, np.eye(4))


def test_assigning_a_transformation():
    s = S.sphere()
    s.set_transform(X.translation(2, 3, 4))
    assert_almost_eq(s.transform, X.translation(2, 3, 4))


def test_the_default_material():
    assert S.sphere().material == Material()


def test_assigning_a_material():
    s = S.sphere()
    s.material = Material(ambient=1.0)
    assert s.material == Material(ambient=1.0)


@pytest.mark.parametrize("origin,expected", [
    ([0, 0, -5], [4.0, 6.0]), ([0, 1, -5], [5.0, 5.0]), ([0, 2, -5], []),
    ([0, 0, 0], [-1.0, 1.0]), ([0, 0, 5], [-6.0, -4.0]),
], ids=["two_points", "tangent", "misses", "originates_inside", "behind_the_ray"])
def test_a_ray_intersects_a_sphere(origin, expected):
    ts, _ = xs_of(S.sphere(), origin, [0, 0, 1])
    assert len(ts) == len(expected)
    assert_almost_eq(ts, expected)


def test_intersect_sets_the_object_on_the_intersection():
    _, objs = xs_of(S.sphere(), [0, 0, -5], [0, 0, 1])
    assert list(objs) == [0, 0]


@pytest.mark.parametrize("m,expected", [
    (X.scaling(2, 2, 2), [3.0, 7.0]), (X.translation(5, 0, 0), []),
], ids=["scaled", "translated"])
def test_intersecting_a_transformed_sphere_with_a_ray(m, expected):
    s = S.sphere()
    s.set_transform(m)
    ts, _ = xs_of(s, [0, 0, -5], [0, 0, 1])
    assert len(ts) == len(expected)
    assert_almost_eq(ts, expected)


@pytest.mark.parametrize("point,normal", [
    ([1, 0, 0], [1, 0, 0]), ([0, 1, 0], [0, 1, 0]), ([0, 0, 1], [0, 0, 1]),
    ([S3 / 3, S3 / 3, S3 / 3], [S3 / 3, S3 / 3, S3 / 3]),
])
def test_the_normal_on_a_sphere(point, normal):
    assert_almost_eq(normal_at(S.sphere(), point), normal)


def test_the_normal_is_a_normalized_vector():
    assert_almost_eq(np.linalg.norm(normal_at(S.sphere(), [S3 / 3, S3 / 3, S3 / 3])), 1.0)


@pytest.mark.parametrize("m,point,normal", [
    (X.translation(0, 1, 0), [0, 1.70711, -0.70711], [0, 0.70711, -0.70711]),
    (X.scaling(1, 0.5, 1) @ X.rotation_z(PI / 5), [0, S2 / 2, -S2 / 2],
     [0, 0.97014, -0.24254]),
], ids=["translated", "transformed"])
def test_computing_the_normal_on_a_transformed_sphere(m, point, normal):
    s = S.sphere()
    s.set_transform(m)
    assert_almost_eq(normal_at(s, point), normal)


def test_a_helper_for_producing_a_sphere_with_a_glassy_material():
    s = S.glass_sphere()
    assert_almost_eq(s.transform, np.eye(4))
    assert s.material.transparency == 1.0
    assert s.material.refractive_index == 1.5


# --- shapes: group space ------------------------------------------------------

def _nested_sphere(scale):
    """g1(rotY(pi/2)) > g2(scale) > sphere(translate(5, 0, 0)); the
    transforms are pushed into the leaf as the reference does
    (src/shape.rs:207-218)."""
    s = S.sphere()
    s.set_transform(X.translation(5, 0, 0))
    g2 = S.group([s])
    g2.set_transform(scale)
    g1 = S.group([g2])
    g1.set_transform(X.rotation_y(PI / 2))
    return g1


def test_converting_a_point_from_world_to_object_space():
    inv = compiled(World(objects=[_nested_sphere(X.scaling(2, 2, 2))])).prim_inv[0].numpy()
    assert_almost_eq(inv[:, :3] @ np.array([-2.0, 0.0, -10.0]) + inv[:, 3], [0.0, 0.0, -1.0])


def test_converting_a_normal_from_object_to_world_space():
    invT = compiled(World(objects=[_nested_sphere(X.scaling(1, 2, 3))])).prim_invT[0].numpy()
    n = invT @ np.array([S3 / 3, S3 / 3, S3 / 3])
    assert_almost_eq(n / np.linalg.norm(n), [0.28571, 0.42857, -0.85714])


def test_finding_the_normal_on_a_child_object():
    n = normal_at(_nested_sphere(X.scaling(1, 2, 3)), [1.7321, 1.1547, -5.5774])
    assert_almost_eq(n, [0.28570, 0.42854, -0.85716])


# --- shapes: planes -----------------------------------------------------------

def test_the_normal_of_a_plane_is_constant_everywhere():
    for p in ([0, 0, 0], [10, 0, -10], [-5, 0, 150]):
        assert_almost_eq(normal_at(S.plane(), p), [0, 1, 0])


@pytest.mark.parametrize("origin,direction,expected", [
    ([0, 10, 0], [0, 0, 1], []), ([0, 0, 0], [0, 0, 1], []),
    ([0, 1, 0], [0, -1, 0], [1.0]), ([0, -1, 0], [0, 1, 0], [1.0]),
], ids=["parallel", "coplanar", "from_above", "from_below"])
def test_intersecting_a_plane(origin, direction, expected):
    ts, objs = xs_of(S.plane(), origin, direction)
    assert len(ts) == len(expected)
    assert_almost_eq(ts, expected)
    assert all(o == 0 for o in objs)


# --- shapes: cubes ------------------------------------------------------------

@pytest.mark.parametrize("origin,direction,t1,t2", [
    ([5, 0.5, 0], [-1, 0, 0], 4, 6), ([-5, 0.5, 0], [1, 0, 0], 4, 6),
    ([0.5, 5, 0], [0, -1, 0], 4, 6), ([0.5, -5, 0], [0, 1, 0], 4, 6),
    ([0.5, 0, 5], [0, 0, -1], 4, 6), ([0.5, 0, -5], [0, 0, 1], 4, 6),
    ([0, 0.5, 0], [0, 0, 1], -1, 1),
])
def test_a_ray_intersects_a_cube(origin, direction, t1, t2):
    ts, _ = xs_of(S.cube(), origin, direction)
    assert_almost_eq(ts, [t1, t2])


@pytest.mark.parametrize("origin,direction", [
    ([-2, 0, 0], [0.2673, 0.5345, 0.8018]), ([0, -2, 0], [0.8018, 0.2673, 0.5345]),
    ([0, 0, -2], [0.5345, 0.8018, 0.2673]), ([2, 0, 2], [0, 0, -1]),
    ([0, 2, 2], [0, -1, 0]), ([2, 2, 0], [-1, 0, 0]),
])
def test_a_ray_misses_a_cube(origin, direction):
    ts, _ = xs_of(S.cube(), origin, direction)
    assert len(ts) == 0


@pytest.mark.parametrize("point,normal", [
    ([1, 0.5, -0.8], [1, 0, 0]), ([-1, -0.2, 0.9], [-1, 0, 0]), ([-0.4, 1, -0.1], [0, 1, 0]),
    ([0.3, -1, -0.7], [0, -1, 0]), ([-0.6, 0.3, 1], [0, 0, 1]), ([0.4, 0.4, -1], [0, 0, -1]),
    ([1, 1, 1], [1, 0, 0]), ([-1, -1, -1], [-1, 0, 0]),
])
def test_the_normal_on_the_surface_of_a_cube(point, normal):
    assert_almost_eq(normal_at(S.cube(), point), normal)


# --- shapes: cylinders --------------------------------------------------------

def norm(v):
    v = np.asarray(v, dtype=np.float64)
    return v / np.linalg.norm(v)


@pytest.mark.parametrize("origin,direction", [
    ([1, 0, 0], [0, 1, 0]), ([0, 0, 0], [0, 1, 0]), ([0, 0, -5], [1, 1, 1]),
])
def test_a_ray_misses_a_cylinder(origin, direction):
    ts, _ = xs_of(S.infinite_cylinder(), origin, norm(direction))
    assert len(ts) == 0


@pytest.mark.parametrize("origin,direction,t0,t1", [
    ([1, 0, -5], [0, 0, 1], 5, 5), ([0, 0, -5], [0, 0, 1], 4, 6),
    ([0.5, 0, -5], [0.1, 1, 1], 6.80798, 7.08872),
])
def test_a_ray_strikes_a_cylinder(origin, direction, t0, t1):
    ts, _ = xs_of(S.infinite_cylinder(), origin, norm(direction))
    assert_almost_eq(ts, [t0, t1])


@pytest.mark.parametrize("point,normal", [
    ([1, 0, 0], [1, 0, 0]), ([0, 5, -1], [0, 0, -1]), ([0, -2, 1], [0, 0, 1]),
    ([-1, 1, 0], [-1, 0, 0]),
])
def test_normal_vector_on_a_cylinder(point, normal):
    assert_almost_eq(normal_at(S.infinite_cylinder(), point), normal)


def test_the_default_minimum_and_maximum_for_a_cylinder():
    c = S.infinite_cylinder()
    assert c.minimum == -np.inf and c.maximum == np.inf


def test_the_default_closed_value_for_a_cylinder():
    assert not S.infinite_cylinder().capped


@pytest.mark.parametrize("origin,direction,count", [
    ([0, 1.5, 0], [0.1, 1, 0], 0), ([0, 3, -5], [0, 0, 1], 0), ([0, 0, -5], [0, 0, 1], 0),
    ([0, 2, -5], [0, 0, 1], 0), ([0, 1, -5], [0, 0, 1], 0), ([0, 1.5, -2], [0, 0, 1], 2),
])
def test_intersecting_a_constrained_cylinder(origin, direction, count):
    ts, _ = xs_of(S.cylinder(1.0, 2.0, False), origin, direction)
    assert len(ts) == count


@pytest.mark.parametrize("origin,direction,count", [
    ([0, 3, 0], [0, -1, 0], 2), ([0, 3, -2], [0, -1, 2], 2),
    ([0, 4, -2], [0, -1, 1], 2),  # corner case
    ([0, 0, -2], [0, 1, 2], 2),
    ([0, -1, -2], [0, 1, 1], 2),  # corner case
])
def test_intersecting_the_caps_of_a_closed_cylinder(origin, direction, count):
    ts, _ = xs_of(S.cylinder(1.0, 2.0, True), origin, norm(direction))
    assert len(ts) == count


@pytest.mark.parametrize("point,normal", [
    ([0, 1, 0], [0, -1, 0]), ([0.5, 1, 0], [0, -1, 0]), ([0, 1, 0.5], [0, -1, 0]),
    ([0, 2, 0], [0, 1, 0]), ([0.5, 2, 0], [0, 1, 0]), ([0, 2, 0.5], [0, 1, 0]),
])
def test_the_normal_vector_on_a_cylinder_s_end_caps(point, normal):
    assert_almost_eq(normal_at(S.cylinder(1.0, 2.0, True), point), normal)


# --- shapes: cones ------------------------------------------------------------

@pytest.mark.parametrize("origin,direction,t0,t1", [
    ([0, 0, -5], [0, 0, 1], 5, 5), ([0, 0, -5], [1, 1, 1], 8.66025, 8.66025),
    ([1, 1, -5], [-0.5, -1, 1], 4.55006, 49.44994),
])
def test_intersecting_a_cone_with_a_ray(origin, direction, t0, t1):
    ts, _ = xs_of(S.infinite_cone(), origin, norm(direction))
    assert_almost_eq(ts, [t0, t1])


def test_intersecting_a_cone_with_a_ray_parallel_to_one_of_its_halves():
    ts, _ = xs_of(S.infinite_cone(), [0, 0, -1], norm([0, 1, 1]))
    assert_almost_eq(ts, [0.35355])


@pytest.mark.parametrize("origin,direction,count", [
    ([0, 0, -5], [0, 1, 0], 0), ([0, 0, -0.25], [0, 1, 1], 2), ([0, 0, -0.25], [0, 1, 0], 4),
])
def test_intersecting_a_cone_s_end_caps(origin, direction, count):
    ts, _ = xs_of(S.cone(-0.5, 0.5, True), origin, norm(direction))
    assert len(ts) == count


@pytest.mark.parametrize("point,normal", [
    ([0, 0, 0], [0, 0, 0]), ([1, 1, 1], [1, -S2, 1]), ([-1, -1, 0], [-1, 1, 0]),
])
def test_computing_the_normal_vector_on_a_cone(point, normal):
    expected = np.asarray(normal, dtype=np.float64)
    if np.linalg.norm(expected) > 0:
        expected = expected / np.linalg.norm(expected)
    assert_almost_eq(normal_at(S.infinite_cone(), point), expected)


# --- shapes: groups -----------------------------------------------------------

def test_creating_a_new_group():
    g = S.group()
    assert_almost_eq(g.transform, np.eye(4))
    assert g.children == []


def test_adding_a_child_to_a_group():
    g, s = S.group(), S.sphere()
    g.push_shape(s)
    assert g.children[0] is s


def test_intersecting_a_ray_with_an_empty_group():
    scene = compiled(World(objects=[S.group()]))
    assert scene.static.n_prims == 0 and scene.static.n_tris == 0
    xs = intersect_all(scene, *rays([0.0, 0.0, -5.0], [0.0, 0.0, 1.0]), CFG)
    assert xs.t.shape == (1, 0) and hit_index(xs).tolist() == [-1]


def test_intersecting_a_ray_with_a_nonempty_group():
    s2, s3 = S.sphere(), S.sphere()
    s2.set_transform(X.translation(0, 0, -3))
    s3.set_transform(X.translation(5, 0, 0))
    ts, objs = xs_of(S.group([S.sphere(), s2, s3]), [0, 0, -5], [0, 0, 1])
    assert len(ts) == 4
    assert list(objs) == [1, 1, 0, 0]  # sorted by t: s2, s2, s1, s1


def test_intersecting_a_transformed_group():
    s = S.sphere()
    s.set_transform(X.translation(5, 0, 0))
    g = S.group([s])
    g.set_transform(X.scaling(2, 2, 2))
    ts, _ = xs_of(g, [10, 0, -10], [0, 0, 1])
    assert len(ts) == 2


def test_set_transform_twice_raises():
    g = S.sphere()
    g.set_transform(X.translation(1, 0, 0))
    with pytest.raises(RuntimeError):
        g.set_transform(X.translation(1, 0, 0))


# --- shapes: triangles --------------------------------------------------------

def _tri():
    return S.triangle([0, 1, 0], [-1, 0, 0], [1, 0, 0])


def test_constructing_a_triangle():
    t = _tri()
    e1, e2, n = S.triangle_edges(t.p1[None], t.p2[None], t.p3[None])
    assert_almost_eq(e1[0], [-1, -1, 0])
    assert_almost_eq(e2[0], [1, -1, 0])
    assert_almost_eq(n[0], [0, 0, -1])


@pytest.mark.parametrize("origin,direction,expected", [
    ([0, -1, -2], [0, 1, 0], []), ([1, 1, -2], [0, 0, 1], []), ([-1, 1, -2], [0, 0, 1], []),
    ([0, -1, -2], [0, 0, 1], []), ([0, 0.5, -2], [0, 0, 1], [2.0]),
], ids=["parallel", "misses_p1_p3", "misses_p1_p2", "misses_p2_p3", "strikes"])
def test_intersecting_a_triangle(origin, direction, expected):
    ts, _ = xs_of(_tri(), origin, direction)
    assert len(ts) == len(expected)
    assert_almost_eq(ts, expected)


def test_finding_the_normal_on_a_triangle():
    for p in ([0, 0.5, 0], [-0.5, 0.75, 0], [0.5, 0.25, 0]):
        assert_almost_eq(normal_at(_tri(), p), [0, 0, -1])


# --- the world (tests/test_world.py; src/world.rs:166-547) --------------------

def test_creating_a_world():
    w = World(light=PointLight((0, 0, 0), WHITE))
    assert w.objects == []
    assert w.light.position == (0, 0, 0)


def test_the_default_world():
    w = default_world()
    assert w.light.position == (-10.0, 10.0, -10.0)
    assert w.objects[0].material.color == (0.8, 1.0, 0.6)
    assert w.objects[0].material.diffuse == 0.7
    assert w.objects[0].material.specular == 0.2
    assert_almost_eq(w.objects[1].transform, np.diag([0.5, 0.5, 0.5, 1.0]))


def test_intersect_a_world_with_a_ray():
    ts, _ = xs_of(S.group(default_world().objects), [0, 0, -5], [0, 0, 1])
    assert_almost_eq(ts, [4.0, 4.5, 5.5, 6.0])


def _inside_light_world():
    w = default_world()
    w.light = PointLight((0.0, 0.25, 0.0), WHITE)
    return w


def _shadowed_pair_world():
    return World(objects=[S.sphere(), S.sphere(transform=X.translation(0, 0, 10))],
                 light=PointLight((0, 0, -10), WHITE))


def _reflective_floor_world():
    w = default_world()
    w.objects.append(S.plane(transform=X.translation(0, -1, 0),
                             material=Material(reflective=0.5)))
    return w


def _transparent_floor_world(reflective=0.0):
    w = default_world()
    w.objects.append(S.plane(transform=X.translation(0, -1, 0), material=Material(
        transparency=0.5, refractive_index=1.5, reflective=reflective)))
    w.objects.append(S.sphere(transform=X.translation(0, -3.5, -0.5),
                              material=Material(color=(1.0, 0.0, 0.0), ambient=0.5)))
    return w


SHADE_HIT = {
    "an_intersection": (default_world, [0, 0, -5], [0, 0, 1], 4.0, 0,
                        [0.38066, 0.47583, 0.2855]),
    "from_the_inside": (_inside_light_world, [0, 0, 0], [0, 0, 1], 0.5, 1,
                        [0.90498, 0.90498, 0.90498]),
    "in_shadow": (_shadowed_pair_world, [0, 0, 5], [0, 0, 1], 4.0, 1, [0.1, 0.1, 0.1]),
    "reflective": (_reflective_floor_world, [0, 0, -3], [0, -S2 / 2, S2 / 2], S2, 2,
                   [0.87675, 0.92434, 0.82918]),
    "transparent": (_transparent_floor_world, [0, 0, -3], [0, -S2 / 2, S2 / 2], S2, 2,
                    [0.93642, 0.68642, 0.68642]),
    "reflective_transparent": (lambda: _transparent_floor_world(reflective=0.5), [0, 0, -3],
                               [0, -S2 / 2, S2 / 2], S2, 2, [0.93391, 0.69643, 0.69243]),
}


@pytest.mark.parametrize("case", sorted(SHADE_HIT))
def test_shade_hit(case):
    world, origin, direction, t, prim, expected = SHADE_HIT[case]
    c = testing.shade_hit(compiled(world()), origin, direction, t, prim_id=prim,
                          remaining=RECURSION_LIMIT, **CPU)
    assert_almost_eq(c, expected)


@pytest.mark.parametrize("direction,expected", [
    ([0, 1, 0], [0, 0, 0]), ([0, 0, 1], [0.38066, 0.47583, 0.2855]),
], ids=["misses", "hits"])
def test_the_color_when_a_ray(direction, expected):
    c = testing.color_at_single(compiled(default_world()), [0, 0, -5], direction, **CPU)
    assert_almost_eq(c, expected)


def test_the_color_with_an_intersection_behind_the_ray():
    w = default_world()
    w.objects[0].material.ambient = 1.0
    w.objects[1].material.ambient = 1.0
    c = testing.color_at_single(compiled(w), [0, 0, 0.75], [0, 0, -1], **CPU)
    assert_almost_eq(c, w.objects[1].material.color)


@pytest.mark.parametrize("point,expected", [
    ([0, 10, 0], False), ([10, -10, 10], True), ([-20, 20, -20], False), ([-2, 2, -2], False),
], ids=["nothing_collinear", "object_between", "object_behind_the_light",
        "object_behind_the_point"])
def test_the_shadow(point, expected):
    assert testing.is_shadowed(compiled(default_world()), point, **CPU) is expected


def test_color_at_with_mutually_reflective_surfaces():
    lower = S.plane(transform=X.translation(0, -1, 0), material=Material(reflective=1.0))
    upper = S.plane(transform=X.translation(0, 1, 0), material=Material(reflective=1.0))
    w = World(objects=[lower, upper], light=PointLight((0, 0, 0), WHITE))
    c = testing.color_at_single(compiled(w), [0, 0, 0], [0, 1, 0], **CPU)
    assert np.all(np.isfinite(c))  # terminates, no NaN or inf


def _nonreflective_inner_world():
    w = default_world()
    w.objects[1].material.ambient = 1.0
    return w


REFLECTED = {
    "nonreflective": (_nonreflective_inner_world, [0, 0, 5], [0, 0, 1], 1.0, 1,
                      RECURSION_LIMIT, [0, 0, 0]),
    "reflective": (_reflective_floor_world, [0, 0, -3], [0, -S2 / 2, S2 / 2], S2, 2,
                   RECURSION_LIMIT, [0.19033, 0.23791, 0.14274]),
    "maximum_depth": (_reflective_floor_world, [0, 0, -3], [0, -S2 / 2, S2 / 2], S2, 2, 0,
                      [0, 0, 0]),
}


@pytest.mark.parametrize("case", sorted(REFLECTED))
def test_the_reflected_color(case):
    world, origin, direction, t, prim, remaining, expected = REFLECTED[case]
    c = testing.reflected_color(compiled(world()), origin, direction, t, prim_id=prim,
                                remaining=remaining, **CPU)
    assert_almost_eq(c, expected)


def _glassy_outer_world():
    w = default_world()
    w.objects[0].material.transparency = 1.0
    w.objects[0].material.refractive_index = 1.5
    return w


def _refracted_ray_world():
    w = default_world()
    w.objects[0].material.ambient = 1.0
    w.objects[0].material.pattern = test_pattern()
    w.objects[1].material.transparency = 1.0
    w.objects[1].material.refractive_index = 1.5
    return w


REFRACTED = {
    "opaque_surface": (default_world, [0, 0, -5], [0, 0, 1], 4.0, 0, RECURSION_LIMIT,
                       [0, 0, 0], 1e-5),
    "maximum_depth": (_glassy_outer_world, [0, 0, -5], [0, 0, 1], 4.0, 0, 0, [0, 0, 0],
                      1e-5),
    "total_internal_reflection": (_glassy_outer_world, [0, 0, S2 / 2], [0, 1, 0], S2 / 2, 0,
                                  RECURSION_LIMIT, [0, 0, 0], 1e-5),
    "refracted_ray": (_refracted_ray_world, [0, 0, 0.1], [0, 1, 0], 0.4899, 1,
                      RECURSION_LIMIT, [0.0, 0.99888, 0.04721], 1e-4),
}


@pytest.mark.parametrize("case", sorted(REFRACTED))
def test_the_refracted_color(case):
    world, origin, direction, t, prim, remaining, expected, eps = REFRACTED[case]
    c = testing.refracted_color(compiled(world()), origin, direction, t, prim_id=prim,
                                remaining=remaining, **CPU)
    assert_almost_eq(c, expected, eps=eps)


# --- the camera (tests/test_camera.py; src/camera.rs:82-156) -----------------

def ray_for_pixel(cam: Camera, px: int, py: int):
    o, d = camera_rays(torch.tensor(cam.transform_inverse, dtype=F64), cam.hsize, cam.vsize,
                       cam.half_width, cam.half_height, cam.pixel_size, dtype=F64)
    idx = py * cam.hsize + px
    return o[idx].numpy(), d[idx].numpy()


def test_constructing_a_camera():
    c = Camera(160, 120, PI / 2)
    assert c.hsize == 160 and c.vsize == 120
    assert c.field_of_view == PI / 2
    assert_almost_eq(c.transform, np.eye(4))


@pytest.mark.parametrize("hsize,vsize", [(200, 125), (125, 200)], ids=["horizontal", "vertical"])
def test_the_pixel_size_for_a_canvas(hsize, vsize):
    assert_almost_eq(Camera(hsize, vsize, PI / 2).pixel_size, 0.01)


@pytest.mark.parametrize("transform,px,py,origin,direction", [
    (np.eye(4), 100, 50, [0, 0, 0], [0, 0, -1]),
    (np.eye(4), 0, 0, [0, 0, 0], [0.66519, 0.33259, -0.66851]),
    (X.rotation_y(PI / 4) @ X.translation(0, -2, 5), 100, 50, [0, 2, -5],
     [S2 / 2, 0, -S2 / 2]),
], ids=["center", "corner", "transformed"])
def test_constructing_a_ray_through_the_canvas(transform, px, py, origin, direction):
    c = Camera(201, 101, PI / 2)
    c.set_transform(transform)
    o, d = ray_for_pixel(c, px, py)
    assert_almost_eq(o, origin)
    assert_almost_eq(d, direction)


def test_rendering_a_world_with_a_camera():
    c = Camera(11, 11, PI / 2)
    c.set_transform(X.view_transform([0, 0, -5], [0, 0, 0], [0, 1, 0]))
    image = render(compiled(default_world()), c, CFG)
    assert_almost_eq(image[5, 5].numpy(), [0.38066, 0.47583, 0.2855])


def test_rendering_f32_matches_f64_within_quantization():
    c = Camera(24, 12, PI / 3)
    c.set_transform(X.view_transform([0, 1.5, -5], [0, 1, 0], [0, 1, 0]))
    img64 = render(compiled(default_world()), c, CFG).numpy()
    scene32 = compile_scene(default_world(), dtype=torch.float32, **CPU)
    img32 = render(scene32, c, RenderConfig(dtype="float32")).numpy()
    assert np.max(np.abs(img64 - img32)) < 2e-3


def test_camera_rays_follow_the_camera_matrix():
    """A tensor matrix puts the rays on its device, a numpy matrix on the
    host; both equal camera_rays_for_pixels' rays bit for bit."""
    cam = Camera(9, 5, PI / 3)
    cam.set_transform(X.view_transform([1, 2, -5], [0, 1, 0], [0, 1, 0]))
    args = (cam.hsize, cam.vsize, cam.half_width, cam.half_height, cam.pixel_size)
    inv = torch.tensor(cam.transform_inverse, dtype=F64)
    o, d = camera_rays(inv, *args, dtype=F64)
    assert o.device == inv.device and d.device == inv.device
    idx = torch.arange(cam.hsize * cam.vsize)
    po, pd = camera_rays_for_pixels(inv, idx % cam.hsize, idx // cam.hsize,
                                    *args[2:], dtype=F64)
    assert torch.equal(o, po) and torch.equal(d, pd)
    no, nd = camera_rays(cam.transform_inverse, *args, dtype=F64)
    assert no.device.type == "cpu" and torch.equal(no, o) and torch.equal(nd, d)


# --- the light (tests/test_canvas.py; src/light.rs:24-31) ---------------------

def test_light_has_position_and_intensity():
    light = PointLight((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    assert light.position == (0.0, 0.0, 0.0)
    assert light.intensity == (1.0, 1.0, 1.0)


# --- OBJ (tests/test_obj.py; src/obj_file.rs:131-336) -------------------------

def test_ignoring_unrecognized_lines():
    gibberish = textwrap.dedent("""
        There was a young lady named Bright
        who traveled much faster than light.
        She set out one day
        in a relative way,
        and came back the previous night.
        """)
    assert Parser.from_obj_str(gibberish).ignored_lines == 5


def test_vertex_records():
    parser = Parser.from_obj_str("\nv -1 1 0\nv -1.0000 0.5000 0.0000\nv 1 0 0\nv 1 1 0\n")
    for i, want in enumerate([[-1, 1, 0], [-1.0, 0.5, 0.0], [1, 0, 0], [1, 1, 0]], 1):
        assert_almost_eq(parser.vertices(i), want)


@pytest.mark.parametrize("text,faces", [
    ("\nv -1 1 0\nv -1 0 0\nv 1 0 0\nv 1 1 0\n\nf 1 2 3\nf 1 3 4\n",
     [(1, 2, 3), (1, 3, 4)]),
    ("\nv -1 1 0\nv -1 0 0\nv 1 0 0\nv 1 1 0\nv 0 2 0\n\nf 1 2 3 4 5\n",
     [(1, 2, 3), (1, 3, 4), (1, 4, 5)]),
], ids=["triangle_faces", "triangulating_polygons"])
def test_parsing_faces(text, faces):
    parser = Parser.from_obj_str(text)
    m = parser.group_mesh(None)
    assert m.v1.shape == (len(faces), 3)
    for i, (a, b, c) in enumerate(faces):
        assert_almost_eq(m.v1[i], parser.vertices(a))
        assert_almost_eq(m.v2[i], parser.vertices(b))
        assert_almost_eq(m.v3[i], parser.vertices(c))


def test_triangles_in_groups():
    parser = Parser.from_obj_file(os.path.join(FILES, "triangles.obj"))
    for name, (a, b, c) in [("FirstGroup", (1, 2, 3)), ("SecondGroup", (1, 3, 4))]:
        g = parser.group_mesh(name)
        assert_almost_eq(g.v1[0], parser.vertices(a))
        assert_almost_eq(g.v2[0], parser.vertices(b))
        assert_almost_eq(g.v3[0], parser.vertices(c))


def test_converting_an_obj_file_to_a_group():
    path = os.path.join(FILES, "triangles.obj")
    for g in (Parser.from_obj_file(path).obj_to_group(), load_obj(path)):
        assert len(g.children) == 3  # default + FirstGroup + SecondGroup
        assert g.children[0].v1.shape == (0, 3)  # the default group is empty
        assert g.children[1].v1.shape == (1, 3)
        assert g.children[2].v1.shape == (1, 3)


def test_face_index_forms_with_slashes_are_rejected():
    # the reference panics on `v/vt/vn` indices (src/obj_file.rs:58-76)
    with pytest.raises(ValueError):
        Parser.from_obj_str("v 0 1 0\nv -1 0 0\nv 1 0 0\nf 1//3 2//1 3//2\n")


def test_shipped_assets_parse():
    cow = Parser.from_obj_file(os.path.join(ASSETS, "cow-nonormals.obj"))
    assert len(cow.vertices_list) == 4583
    assert len(cow.default_faces) + sum(map(len, cow.named_faces.values())) == 5804
    teapot = Parser.from_obj_file(os.path.join(ASSETS, "teapot.obj"))
    assert len(teapot.default_faces) + sum(map(len, teapot.named_faces.values())) == 6320


def test_native_morton_order_matches_rtc_tpu():
    """native.available and morton_order, against rtc_tpu's on the same
    library: None for both without it."""
    from rtc_tpu import native as jax_native
    from rtc_tpu_torch import native

    pts = np.random.default_rng(5).normal(size=(257, 3))
    assert native.available() == jax_native.available()
    got, want = native.morton_order(pts), jax_native.morton_order(pts)
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)
        assert sorted(got.tolist()) == list(range(len(pts)))
        with pytest.raises(ValueError):
            native.morton_order(pts[:, :2])


def test_is_almost_equal():
    """The reference's float comparison (src/utils.rs:4-6)."""
    assert is_almost_equal(1.0, 1.0 + 0.5 * EPSILON)
    assert not is_almost_equal(1.0, 1.0 + 2.0 * EPSILON)
    got = is_almost_equal(torch.tensor([0.0, 1.0], dtype=F64), torch.tensor([0.0, 1.1],
                                                                            dtype=F64))
    assert got.tolist() == [True, False]


# --- each testing helper against rtc_tpu's on the book's cases ----------------

def _both(port_world, jax_world):
    return compiled(port_world), jax_compile_scene(jax_world, dtype=np.float64)


def _jax_worlds():
    """The book worlds of the helper cases, built with rtc_tpu's classes."""
    inside = jax_default_world()
    inside.light = JaxPointLight((0.0, 0.25, 0.0), WHITE)
    glassy = jax_default_world()
    glassy.objects[0].material.transparency = 1.0
    glassy.objects[0].material.refractive_index = 1.5
    refr = jax_default_world()
    refr.objects[0].material.ambient = 1.0
    refr.objects[0].material.pattern = jax_test_pattern()
    refr.objects[1].material.transparency = 1.0
    refr.objects[1].material.refractive_index = 1.5
    floor = jax_default_world()
    floor.objects.append(JS.plane(transform=X.translation(0, -1, 0), material=JaxMaterial(
        transparency=0.5, refractive_index=1.5, reflective=0.5)))
    floor.objects.append(JS.sphere(transform=X.translation(0, -3.5, -0.5),
                                   material=JaxMaterial(color=(1.0, 0.0, 0.0), ambient=0.5)))
    return {"default": jax_default_world(), "inside": inside, "glassy": glassy,
            "refracted": refr, "floor": floor}


PORT_WORLDS = {"default": default_world, "inside": _inside_light_world,
               "glassy": _glassy_outer_world, "refracted": _refracted_ray_world,
               "floor": lambda: _transparent_floor_world(reflective=0.5)}

# (world, origin, direction, t, prim) of the book's shading cases
HELPER_CASES = [("default", [0, 0, -5], [0, 0, 1], 4.0, 0),
                ("inside", [0, 0, 0], [0, 0, 1], 0.5, 1),
                ("glassy", [0, 0, S2 / 2], [0, 1, 0], S2 / 2, 0),
                ("refracted", [0, 0, 0.1], [0, 1, 0], 0.4899, 1),
                ("floor", [0, 0, -3], [0, -S2 / 2, S2 / 2], S2, 2)]


@pytest.fixture(scope="module")
def helper_scenes():
    jw = _jax_worlds()
    return {k: _both(PORT_WORLDS[k](), jw[k]) for k in PORT_WORLDS}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=1e-12, rtol=0)


@pytest.mark.parametrize("helper", ["comps_at", "color_at_single", "is_shadowed",
                                    "reflected_color", "refracted_color", "shade_hit"])
def test_helpers_match_rtc_tpu(helper_scenes, helper):
    for world, origin, direction, t, prim in HELPER_CASES:
        scene, jscene = helper_scenes[world]
        if helper == "comps_at":
            got = testing.comps_at(scene, origin, direction, t, prim_id=prim, **CPU)
            want = jax_testing.comps_at(jscene, origin, direction, t, prim_id=prim)
            for g, w in zip(got, want):
                _close(g, w)
        elif helper == "color_at_single":
            _close(testing.color_at_single(scene, origin, direction, **CPU),
                   jax_testing.color_at_single(jscene, origin, direction))
        elif helper == "is_shadowed":
            for p in ([0, 10, 0], [10, -10, 10], [-20, 20, -20], [-2, 2, -2], origin):
                assert (testing.is_shadowed(scene, p, **CPU)
                        == jax_testing.is_shadowed(jscene, p))
        else:
            for remaining in (0, 1, RECURSION_LIMIT):
                _close(getattr(testing, helper)(scene, origin, direction, t, prim,
                                                remaining, **CPU),
                       getattr(jax_testing, helper)(jscene, origin, direction, t, prim,
                                                    remaining))


SHAPES = {
    "sphere": (lambda m: m.sphere(transform=X.scaling(1, 0.5, 1) @ X.rotation_z(PI / 5)),
               [0, S2 / 2, -S2 / 2]),
    "plane": (lambda m: m.plane(), [10, 0, -10]),
    "cube": (lambda m: m.cube(), [-0.6, 0.3, 1]),
    "cylinder": (lambda m: m.cylinder(1.0, 2.0, True), [0.5, 2, 0]),
    "cone": (lambda m: m.infinite_cone(), [1, 1, 1]),
    "triangle": (lambda m: m.triangle([0, 1, 0], [-1, 0, 0], [1, 0, 0]), [0, 0.5, 0]),
}


@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_shape_helpers_match_rtc_tpu(kind):
    """intersect_shape and normal_at of each kind, and of a group of
    them, through both packages."""
    make, point = SHAPES[kind]
    _close(testing.normal_at(make(S), point, **CPU), jax_testing.normal_at(make(JS), point))
    for origin, direction in (([0.1, 0.2, -5], [0, 0, 1]), ([0.3, 3, 0.2], norm([0.1, -1, 0])),
                              ([0, 0, 0], norm([1, 1, 1]))):
        ts, objs = testing.intersect_shape(make(S), origin, direction, **CPU)
        jts, jobjs = jax_testing.intersect_shape(make(JS), origin, direction)
        _close(ts, jts)
        np.testing.assert_array_equal(objs, jobjs)
    group = lambda m: m.group([SHAPES[k][0](m) for k in sorted(SHAPES)])
    ts, objs = testing.intersect_shape(group(S), [0.1, 0.2, -5], [0, 0, 1], **CPU)
    jts, jobjs = jax_testing.intersect_shape(group(JS), [0.1, 0.2, -5], [0, 0, 1])
    _close(ts, jts)
    np.testing.assert_array_equal(objs, jobjs)
    assert testing.hit(ts) == jax_testing.hit(jts)
