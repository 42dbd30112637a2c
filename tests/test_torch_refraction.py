"""Refraction, analytic prims and patterns in rtc_tpu_torch against rtc_tpu:
the plain crossing census against rtc_tpu's interpret-mode K4, the n1/n2
container semantics through the port's prepare_hit, the five analytic
kinds and their normals, pattern evaluation, and glass_teapot rendered
through render() against rtc_tpu's render and tests/golden. The CUDA
census kernel is held against its plain version on the GPU
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rtc_tpu.models.scenes import REGISTRY as JAX_REGISTRY
from rtc_tpu.ops import intersect as jax_intersect
from rtc_tpu.ops import normals as jax_normals
from rtc_tpu.ops import patterns as jax_patterns
from rtc_tpu.ops.pallas.mesh_intersect import mesh_crossing_count_mxu
from rtc_tpu.render.camera import camera_rays as jax_camera_rays
from rtc_tpu.render.renderer import render as jax_render
from rtc_tpu.scene.compile import compile_scene as jax_compile_scene
from rtc_tpu.utils.config import RenderConfig as JaxRenderConfig
from rtc_tpu_torch.models.scenes import REGISTRY
from rtc_tpu_torch.ops import intersect, normals, patterns
from rtc_tpu_torch.ops import transforms as X
from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
from rtc_tpu_torch.render import integrator
from rtc_tpu_torch.render.renderer import render
from rtc_tpu_torch.scene.compile import (TENSOR_FIELDS, compile_scene,
                                         scene_from_numpy)
from rtc_tpu_torch.scene.materials import Material, gradient_pattern
from rtc_tpu_torch.scene.shapes import mesh, plane, sphere
from rtc_tpu_torch.scene.world import PointLight, World
from rtc_tpu_torch.utils.config import RenderConfig
from rtc_tpu_torch.utils.constants import BIG

torch.set_num_threads(2)


def _compile(world, **kw):
    """The port's compile_scene on the CPU: its default device is the card."""
    return compile_scene(world, device="cpu", **kw)


GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CFG64 = RenderConfig(dtype="float64")


def _quantize(img):
    return np.clip(np.asarray(img, np.float64) * 255.0 + 0.5, 0, 255).astype(np.uint8)


# --- the crossing census --------------------------------------------------------

@pytest.fixture(scope="module")
def glass32():
    """rtc_tpu's f32 glass_teapot tables and width-32 camera rays, and the
    port's scene from the same tables."""
    world, cam = JAX_REGISTRY["glass_teapot"](32)
    js = jax_compile_scene(world, dtype=np.float32)
    dt = jnp.float32
    o, d = jax_camera_rays(jnp.asarray(cam.transform_inverse, dt), cam.hsize,
                           cam.vsize, jnp.asarray(cam.half_width, dt),
                           jnp.asarray(cam.half_height, dt),
                           jnp.asarray(cam.pixel_size, dt), dt)
    arrays = {f: np.asarray(getattr(js, f)) for f in TENSOR_FIELDS}
    scene = scene_from_numpy(arrays, js.static._asdict(), device="cpu")
    return js, scene, np.asarray(o), np.asarray(d)


def _census_rays(scene, o, d):
    """tests/test_pallas_mesh.py's two ray sets: the primary rays with
    their hits (t_hit, hit_gid), and the same rays re-seated inside the
    glass (origins 1e-3 past the first hit, t_hit = BIG), so negative-t
    crossings and parity from inside are exercised."""
    t, idx, _ = mi.closest_hit_plain(torch.from_numpy(o), torch.from_numpy(d),
                                     scene.tri_p1, scene.tri_e1, scene.tri_e2,
                                     scene.tri_n)
    t, idx = t.numpy(), idx.numpy()
    hit = idx >= 0
    gid = np.where(hit, idx, -2).astype(np.int32)
    o2 = (o + d * (np.where(hit, t, 0.0)[:, None] + 1e-3)).astype(np.float32)
    R = len(o)
    return ((o, d, t.astype(np.float32), gid),
            (o2, d, np.full(R, BIG, np.float32), np.full(R, -2, np.int32)))


def test_census_plain_matches_rtc_tpu(glass32):
    """rtc_tpu's K4 computes t through the Plücker matmul, which differs
    from direct Möller-Trumbore by ulps, so its own gate applies
    (tests/test_pallas_mesh.py:322-326): counts equal on more than 99.5%
    of rays, and the latest crossing within 1e-4 where they agree."""
    js, scene, o, d = glass32
    K = len(js.static.refr_mesh_obj_ids)
    assert K == 1 and scene.static.refr_mesh_obj_ids == (1,)
    for oo, dd, t_hit, gid in _census_rays(scene, o, d):
        cnt, last = mi.crossing_count_plain(
            *map(torch.from_numpy, (oo, dd, t_hit, gid)), scene.tri_p1,
            scene.tri_e1, scene.tri_e2, scene.tri_cid, K)
        jcnt, jlast = mesh_crossing_count_mxu(
            oo, dd, t_hit, gid, js.tri_p1, js.tri_e1, js.tri_e2,
            js.cluster_aabb, js.tri_cid, n_containers=K,
            leaf=js.static.cluster_size, interpret=True)
        cnt, last = cnt.numpy(), last.numpy()
        jcnt, jlast = np.asarray(jcnt), np.asarray(jlast)
        same = (cnt == jcnt).all(axis=1)
        assert same.mean() > 0.995, f"census differs on {(~same).sum()} rays"
        close = np.abs(last - jlast) < 1e-4
        assert (close | ~same[:, None]).mean() > 0.995
        assert (last[cnt == 0] == np.float32(-BIG)).all()
    # re-seated rays count the entry behind their origin and the exit ahead
    assert int((cnt >= 2).sum()) > 20


def test_census_counts_crossings_on_a_cube():
    """A closed cube mesh (z in [-1, 1]) and rays along +z: the census
    counts negative-t crossings, excludes the hit triangle by id, and a
    dead lane (t_hit = -BIG) counts nothing."""
    scene = _compile(World(objects=[_cube_mesh(material=_glass(1.5))]),
                          dtype=torch.float64)
    o = torch.tensor([[0.3, 0.1, -4.0], [0.3, 0.1, 0.0], [0.3, 0.1, 4.0],
                      [0.3, 0.1, -4.0]], dtype=torch.float64)
    d = torch.tensor([[0.0, 0.0, 1.0]] * 4, dtype=torch.float64)
    t, idx, _ = mi.closest_hit_plain(o, d, scene.tri_p1, scene.tri_e1,
                                     scene.tri_e2, scene.tri_n)
    t_hit = torch.tensor([BIG, BIG, BIG, -BIG], dtype=torch.float64)
    gid = torch.full((4,), -2, dtype=torch.int32)
    cnt, last = mi.mesh_crossing_count(o, d, t_hit, gid, scene.tri_p1,
                                       scene.tri_e1, scene.tri_e2,
                                       scene.cluster_aabb, scene.tri_cid, 1, 128)
    assert cnt[:, 0].tolist() == [2, 2, 2, 0]
    assert last[:, 0].tolist()[:3] == pytest.approx([5.0, 1.0, -3.0])
    # the entry face itself, excluded by id: only the exit remains
    t_hit[0], gid[0] = float(t[0]), int(idx[0])
    cnt, _ = mi.crossing_count_plain(o, d, t_hit, gid, scene.tri_p1,
                                     scene.tri_e1, scene.tri_e2,
                                     scene.tri_cid, 1)
    assert int(cnt[0, 0]) == 0  # the exit lies beyond t_hit


# --- n1/n2 container semantics (tests/test_refraction_mesh.py) ------------------

def _cube_mesh(material=None, transform=None):
    """A closed +-1 cube as 12 triangles (tests/test_refraction_mesh.py)."""
    corners = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                        for z in (-1, 1)], dtype=np.float64)
    f = np.asarray([(0, 1, 3), (0, 3, 2), (4, 6, 7), (4, 7, 5), (0, 4, 5),
                    (0, 5, 1), (2, 3, 7), (2, 7, 6), (0, 2, 6), (0, 6, 4),
                    (1, 5, 7), (1, 7, 3)])
    return mesh(corners[f[:, 0]], corners[f[:, 1]], corners[f[:, 2]],
                material=material, transform=transform)


def _glass(ior):
    return Material(transparency=1.0, refractive_index=ior)


def _crossings(scene, o, d):
    """All (t, obj, is_tri, id) crossings along one ray, sorted by t."""
    o1 = torch.tensor([o], dtype=torch.float64)
    d1 = torch.tensor([d], dtype=torch.float64)
    out = []
    if scene.static.n_prims:
        t, v = integrator.prim_candidates(scene, o1, d1, CFG64.epsilon)
        for n, s in zip(*np.nonzero(v[0].numpy())):
            out.append((float(t[0, n, s]), int(scene.prim_obj[n]), False, int(n)))
    t, v, _, _ = intersect.triangle(o1[:, None], d1[:, None], scene.tri_p1[None],
                                    scene.tri_e1[None], scene.tri_e2[None])
    for i in np.nonzero(v[0].numpy())[0]:
        out.append((float(t[0, i]), int(scene.tri_obj[i]), True, int(i)))
    return sorted(out)


def _port_n1_n2(scene, o, d, t, obj, is_tri, gid):
    """n1/n2 of one chosen hit through the port's prepare_hit."""
    i32 = lambda x: torch.tensor([x], dtype=torch.int32)
    hit = integrator.HitInfo(
        t=torch.tensor([t], dtype=torch.float64),
        valid=torch.ones((1,), dtype=torch.bool), obj=i32(obj),
        prim=i32(0 if is_tri else gid), tri=i32(gid if is_tri else 0),
        is_tri=torch.tensor([is_tri]), tri_n=torch.zeros((1, 3), dtype=torch.float64))
    comps = integrator.prepare_hit(scene, torch.tensor([o], dtype=torch.float64),
                                   torch.tensor([d], dtype=torch.float64), hit, CFG64)
    return float(comps.n1[0]), float(comps.n2[0])


def _containers_walk(xs, iors, hit_i):
    """The reference's containers walk (src/intersection.rs:29-62)."""
    containers = []
    for i, (_, obj, _, _) in enumerate(xs):
        if i == hit_i:
            n1 = iors[containers[-1]] if containers else 1.0
        if obj in containers:
            containers.remove(obj)
        else:
            containers.append(obj)
        if i == hit_i:
            return n1, (iors[containers[-1]] if containers else 1.0)
    raise AssertionError("hit index out of range")


def _ladder_scene():
    """The book's A/B/C glass ladder with cube meshes
    (tests/test_refraction_mesh.py ladder_world_mesh)."""
    a = _cube_mesh(material=_glass(1.5), transform=X.scaling(2, 2, 2))
    b = _cube_mesh(material=_glass(2.0), transform=X.translation(0, 0, -0.25))
    c = _cube_mesh(material=_glass(2.5), transform=X.translation(0, 0, 0.25))
    return _compile(World(objects=[a, b, c],
                               light=PointLight((-10, 10, -10), (1, 1, 1))),
                         dtype=torch.float64)


def test_mesh_glass_ladder_matches_book_table():
    """The book's n1/n2 table (src/intersection.rs:301-309) through the
    port's prepare_hit, the hit triangle excluded from its own census."""
    scene = _ladder_scene()
    o, d = [0.3, 0.1, -4.0], [0.0, 0.0, 1.0]
    xs = _crossings(scene, o, d)
    assert len(xs) == 6
    ladder = [(1.0, 1.5), (1.5, 2.0), (2.0, 2.5), (2.5, 2.5), (2.5, 1.5), (1.5, 1.0)]
    for (t, obj, is_tri, gid), want in zip(xs, ladder):
        assert _port_n1_n2(scene, o, d, t, obj, is_tri, gid) == pytest.approx(want)


@pytest.mark.parametrize("case", ["ladder", "sphere_in_cube"])
def test_n1_n2_match_the_containers_walk(case):
    """Against a direct transcription of the reference's walk; the second
    case nests an analytic glass sphere in a glass cube mesh, so prim and
    mesh counts merge into one stack."""
    if case == "ladder":
        scene, o = _ladder_scene(), [0.37, 0.13, -4.0]
    else:
        world = World(objects=[_cube_mesh(material=_glass(1.5),
                                          transform=X.scaling(2, 2, 2)),
                               sphere(material=_glass(2.0))])
        scene, o = _compile(world, dtype=torch.float64), [0.2, 0.1, -5.0]
    d = [0.0, 0.0, 1.0]
    xs = _crossings(scene, o, d)
    assert len(xs) == (6 if case == "ladder" else 4)
    iors = scene.mat_ior.numpy()
    for i, (t, obj, is_tri, gid) in enumerate(xs):
        assert _port_n1_n2(scene, o, d, t, obj, is_tri, gid) == \
            pytest.approx(_containers_walk(xs, iors, i))


def test_glass_mesh_bends_light():
    """A slanted ray through a glass cube mesh onto a gradient floor: the
    color with ior 1.5 differs from the pass-through ior 1.0
    (tests/test_refraction_mesh.py)."""
    floor = plane(material=Material(pattern=gradient_pattern((1, 0, 0), (0, 0, 1)),
                                    specular=0.0))

    def color(ior):
        cube = _cube_mesh(material=Material(transparency=0.9, refractive_index=ior,
                                            diffuse=0.1, ambient=0.0, specular=0.0),
                          transform=X.translation(0, 2.0, 0))
        scene = _compile(World(objects=[floor, cube],
                                    light=PointLight((-10, 10, -10), (1, 1, 1))),
                              dtype=torch.float64)
        d = torch.tensor([[-0.12, -1.0, 0.35]], dtype=torch.float64)
        return integrator.color_at(scene, torch.tensor([[0.4, 5.0, -1.2]],
                                                       dtype=torch.float64),
                                   d / torch.linalg.norm(d),
                                   RenderConfig(dtype="float64", max_depth=8))[0]

    assert (color(1.5) - color(1.0)).abs().max() > 1e-3


# --- analytic kinds, normals and patterns against rtc_tpu -------------------------

def _seeded_rays(n=400, seed=7):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3.0, 3.0, (n, 3))
    d = rng.normal(size=(n, 3))
    d[:40, 1] = 0.0  # rays parallel to the xz plane and the caps
    d[40:60, 0] = d[40:60, 2] = 0.0  # rays along the y axis
    return o, d


KINDS = {
    "sphere": (intersect.sphere, jax_intersect.sphere, ()),
    "plane": (intersect.plane, jax_intersect.plane, (1e-5,)),
    "cube": (intersect.cube, jax_intersect.cube, (1e-5,)),
    "cylinder": (intersect.cylinder, jax_intersect.cylinder, (-1.0, 2.0, True, 1e-5)),
    "cone": (intersect.cone, jax_intersect.cone, (-1.5, 1.0, True, 1e-5)),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_analytic_kind_matches_rtc_tpu(kind):
    port, ref, args = KINDS[kind]
    o, d = _seeded_rays()
    targs = tuple(torch.tensor(a) if isinstance(a, bool) else a for a in args)
    got = port(torch.from_numpy(o), torch.from_numpy(d), *targs)
    want = ref(jnp.asarray(o), jnp.asarray(d), *args)
    valid = got.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(want.valid))
    assert valid.any() and not valid.all()
    np.testing.assert_allclose(got.t.numpy()[valid], np.asarray(want.t)[valid],
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", ["sphere", "plane", "cube", "cylinder", "cone"])
def test_normal_matches_rtc_tpu(kind):
    p = np.random.default_rng(11).uniform(-1.2, 1.2, (300, 3))
    p[:20, 1] = 1.0 - 1e-6  # on and near the cylinder's caps
    args = (-1.0, 1.0) if kind == "cylinder" else ()
    got = getattr(normals, kind)(torch.from_numpy(p), *args).numpy()
    want = np.asarray(getattr(jax_normals, kind)(jnp.asarray(p), *args))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", ["stripe", "gradient", "ring", "checkers",
                                  "test", "none"])
def test_pattern_matches_rtc_tpu(kind):
    """Every kind, with points on and beside the cell boundaries that
    PATTERN_EPS moves (rtc_tpu/ops/patterns.py:16-32)."""
    rng = np.random.default_rng(3)
    p = rng.uniform(-4.0, 4.0, (500, 3))
    p[:100] = np.round(p[:100])  # exactly on integer boundaries
    p[100:150] = np.round(p[100:150]) - 0.5e-4  # inside the nudge
    code = getattr(jax_patterns, kind.upper())
    a, b = rng.uniform(size=(500, 3)), rng.uniform(size=(500, 3))
    kinds = np.full(500, code, dtype=np.int32)
    assert patterns.PATTERN_EPS == jax_patterns.PATTERN_EPS
    got = patterns.color_at(*map(torch.from_numpy, (p, kinds, a, b))).numpy()
    want = np.asarray(jax_patterns.color_at(*map(jnp.asarray, (p, kinds, a, b))))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


# --- glass_teapot through render() ----------------------------------------------

def test_glass_teapot_f64_matches_golden_and_rtc_tpu():
    """Width 24: at depth 8 against tests/golden/glass_teapot.npy (the
    refraction chain reaches the floor, tests/test_golden.py SPECS), and
    at depth 5 against rtc_tpu's f64 render (its depth-8 program takes
    most of this file's time budget to build)."""
    world, cam = REGISTRY["glass_teapot"](24)
    scene = _compile(world, dtype=torch.float64)
    img = render(scene, cam, RenderConfig(dtype="float64", ray_tile=512,
                                          max_depth=8)).numpy()
    np.testing.assert_allclose(img, np.load(os.path.join(GOLDEN, "glass_teapot.npy")),
                               atol=1e-9, rtol=0)
    img5 = render(scene, cam, RenderConfig(dtype="float64", ray_tile=512)).numpy()
    jax_world, jax_cam = JAX_REGISTRY["glass_teapot"](24)
    ref = np.asarray(jax_render(jax_compile_scene(jax_world, dtype=np.float64),
                                jax_cam, JaxRenderConfig(dtype="float64",
                                                         ray_tile=512)))
    np.testing.assert_allclose(img5, ref, atol=1e-9, rtol=0)
    assert np.abs(img - img5).max() > 1e-3  # depth 8 reaches further


def test_glass_teapot_f32_matches_f64_golden():
    """tests/test_golden.py's F32_BUDGET for glass_teapot: 99% of pixels
    byte-equal after 8-bit quantization, no structural flip."""
    golden = np.load(os.path.join(GOLDEN, "glass_teapot.npy"))
    world, cam = REGISTRY["glass_teapot"](24)
    img = render(_compile(world, dtype=torch.float32), cam,
                 RenderConfig(ray_tile=512, max_depth=8)).numpy()
    match_frac = float(np.all(_quantize(golden) == _quantize(img), axis=2).mean())
    flips = int((np.abs(golden - img).max(axis=2) > 0.15).sum())
    assert match_frac >= 0.99 and flips == 0, (match_frac, flips)
