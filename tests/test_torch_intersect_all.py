"""rtc_tpu_torch's intersect_all, hit_index and tri_candidates against
rtc_tpu's on seeded worlds in float64 on the CPU: every prim kind with a
flat mesh group and a smooth triangle, the tie cases (coincident spheres,
triangles through a sphere's hit and tangent points) and the empty world.
t, u and v agree within 1e-9; obj and valid exactly, so the tie order
is rtc_tpu's, which is the reference's stable sort over the objects'
insertion order (src/world.rs:51)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtc_tpu.render import integrator as jax_integrator
from rtc_tpu.scene import shapes as JS
from rtc_tpu.scene.compile import compile_scene as jax_compile_scene
from rtc_tpu.scene.world import World as JaxWorld
from rtc_tpu.utils.config import RenderConfig as JaxRenderConfig
from rtc_tpu_torch import Intersections, hit_index, intersect_all
from rtc_tpu_torch.ops import transforms as X
from rtc_tpu_torch.render import integrator
from rtc_tpu_torch.scene import shapes as S
from rtc_tpu_torch.scene.compile import compile_scene
from rtc_tpu_torch.scene.world import World
from rtc_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(2)

CFG = RenderConfig(dtype="float64")
JAX_CFG = JaxRenderConfig(dtype="float64")
N_RAYS = 48


def kinds_objects(m, rng):
    """All five prim kinds, a flat mesh in a transformed group and a smooth
    triangle, built with the shapes module m of either package."""
    v = rng.uniform(-1.0, 1.0, size=(3, 6, 3))
    vn = rng.normal(size=(3, 1, 3))
    return [
        m.sphere(transform=X.translation(0.5, 0.2, 0.0) @ X.scaling(1.0, 0.7, 1.2)),
        m.plane(transform=X.translation(0.0, -2.0, 0.0)),
        m.cube(transform=X.translation(-1.5, 0.5, 1.0) @ X.rotation_y(0.6)),
        m.cylinder(-1.0, 1.0, True, transform=X.translation(2.0, 0.0, -1.0)),
        m.cone(-1.0, 0.5, True, transform=X.translation(-2.0, 0.0, -1.5)),
        m.group([m.mesh(*v)], transform=X.translation(0.0, 1.5, -1.0) @ X.rotation_x(0.4)),
        m.mesh([[-1.0, -1.0, 2.0]], [[1.0, -1.0, 2.5]], [[0.0, 1.0, 2.0]], *vn),
    ]


def tie_objects(m, rng):
    """Two coincident unit spheres, a triangle through their near hit
    (z = -1) and one through the tangent point (0, 1, 0), each t exact."""
    return [m.sphere(), m.sphere(),
            m.triangle([-2, -2, -1], [2, -2, -1], [0, 2, -1]),
            m.triangle([-2, -1, 0], [2, -1, 0], [0, 3, 0])]


WORLDS = {"kinds": kinds_objects, "ties": tie_objects, "empty": lambda m, rng: []}


def seeded_rays(name):
    rng = np.random.default_rng(7)
    if name == "ties":
        o = np.array([[0.0, 0.0, -5.0], [0.0, 1.0, -5.0]] * (N_RAYS // 2))
        d = np.tile([0.0, 0.0, 1.0], (N_RAYS, 1))
        o[2:, :2] += rng.uniform(-0.5, 0.5, size=(N_RAYS - 2, 2))
        return o, d
    o = rng.normal(size=(N_RAYS, 3))
    o = 8.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-2.0, 2.0, size=(N_RAYS, 3)) - o
    d[: N_RAYS // 4] = -d[: N_RAYS // 4]  # rays leaving the scene: negative ts
    return o, d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def worlds():
    out = {}
    for name, objects in WORLDS.items():
        scene = compile_scene(World(objects=objects(S, np.random.default_rng(3))),
                              dtype=torch.float64, device="cpu")
        jscene = jax_compile_scene(JaxWorld(objects=objects(JS, np.random.default_rng(3))),
                                   dtype=np.float64)
        out[name] = (scene, jscene, *seeded_rays(name))
    return out


def _port(scene, o, d, k):
    return intersect_all(scene, torch.from_numpy(o), torch.from_numpy(d), CFG, k=k)


def _jax(jscene, o, d, k):
    return jax_integrator.intersect_all(jscene, jnp.asarray(o), jnp.asarray(d), JAX_CFG, k=k)


@pytest.mark.parametrize("k", [None, 3], ids=["all", "k3"])
@pytest.mark.parametrize("name", sorted(WORLDS))
def test_intersect_all_matches_rtc_tpu(worlds, name, k):
    scene, jscene, o, d = worlds[name]
    xs, jxs = _port(scene, o, d, k), _jax(jscene, o, d, k)
    assert xs.t.shape == jxs.t.shape
    assert xs.obj.dtype == torch.int32 and xs.valid.dtype == torch.bool
    np.testing.assert_array_equal(xs.valid.numpy(), np.asarray(jxs.valid))
    np.testing.assert_array_equal(xs.obj.numpy(), np.asarray(jxs.obj))
    for a, b in ((xs.t, jxs.t), (xs.u, jxs.u), (xs.v, jxs.v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-9, rtol=0)
    hit = hit_index(xs)
    assert hit.dtype == torch.int32
    if xs.t.shape[1]:
        np.testing.assert_array_equal(hit.numpy(), np.asarray(jax_integrator.hit_index(jxs)))
    else:  # rtc_tpu's argmax raises on the empty list; the port has no hit
        assert hit.tolist() == [-1] * N_RAYS
    if name == "kinds" and k is None:
        assert int(xs.valid.sum(1).max()) >= 4 and bool((hit >= 0).any())
        assert bool(((xs.t < 0) & xs.valid).any())


def test_tie_order_is_insertion_order(worlds):
    """The tie rows list their equal ts in candidate order: prim slots
    before triangle rows, each in insertion order."""
    scene, _, o, d = worlds["ties"]
    xs = _port(scene, o[:2], d[:2], None)
    got = [xs.obj[r][xs.valid[r]].tolist() for r in range(2)]
    ts = [xs.t[r][xs.valid[r]].tolist() for r in range(2)]
    assert ts == [[4.0, 4.0, 4.0, 5.0, 6.0, 6.0], [4.0, 5.0, 5.0, 5.0, 5.0, 5.0]]
    assert got == [[0, 1, 2, 3, 0, 1], [2, 0, 0, 1, 1, 3]]
    assert hit_index(xs).tolist() == [0, 0]
    # the closest-hit path breaks the tie the same way: the first sphere
    hit = integrator.closest_hit(scene, torch.from_numpy(o[:1]), torch.from_numpy(d[:1]), CFG)
    assert int(hit.obj[0]) == 0 and float(hit.t[0]) == 4.0


@pytest.mark.parametrize("name", ["kinds", "ties"])
def test_tri_candidates_match_rtc_tpu(worlds, name):
    scene, jscene, o, d = worlds[name]
    got = integrator.tri_candidates(scene, torch.from_numpy(o), torch.from_numpy(d), CFG.epsilon,
                                    with_uv=True)
    want = jax_integrator.tri_candidates(jscene, jnp.asarray(o), jnp.asarray(d),
                                         JAX_CFG.epsilon, with_uv=True)
    t, valid, u, v = (a.numpy() for a in got)
    np.testing.assert_array_equal(valid, np.asarray(want[1]))
    for a, b in ((t, want[0]), (u, want[2]), (v, want[3])):
        np.testing.assert_allclose(np.where(valid, a, 0.0), np.where(valid, np.asarray(b), 0.0),
                                   atol=1e-9, rtol=0)
    assert valid.any()
    short = integrator.tri_candidates(scene, torch.from_numpy(o), torch.from_numpy(d),
                                      CFG.epsilon)
    assert len(short) == 2 and torch.equal(short[0], got[0])


def test_hit_index_matches_rtc_tpu_on_seeded_lists():
    rng = np.random.default_rng(11)
    t = np.sort(rng.normal(size=(64, 6)), axis=1)
    valid = rng.uniform(size=(64, 6)) < 0.7
    t[:4] = -np.abs(t[:4])  # rows with no non-negative t
    t[4:8] = 0.0            # a hit at t = 0 counts
    xs = Intersections(t=torch.from_numpy(t), obj=torch.zeros(t.shape, dtype=torch.int32),
                       valid=torch.from_numpy(valid))
    want = jax_integrator.hit_index(jax_integrator.Intersections(
        t=jnp.asarray(t), obj=jnp.zeros(t.shape, jnp.int32), valid=jnp.asarray(valid)))
    np.testing.assert_array_equal(hit_index(xs).numpy(), np.asarray(want))
