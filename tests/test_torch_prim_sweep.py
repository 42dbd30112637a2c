"""The analytic prims' sweep of rtc_tpu_torch: the reduced answers the
prim kernel gives (mesh_intersect.py prim_closest and prim_any; on the CPU
their plain versions, which the kernel equals bit for bit on the card,
tests/test_torch_cuda.py) against tests/oracle.py's scalar per-ray
intersections in float64, each kind, capped and open, a mixed world and
the edge cases; the local rays in affine3's component order against the
einsum; the gradients of integrator.KernelPrimClosest (the kernel's
forward, the winner re-evaluated backward) against the plain sweep's; and
the route: plan's prims flag, the calls of closest_hit and is_shadowed,
and the gradients of a frame through the prims' tables.
"""

import numpy as np
import pytest
import torch

import oracle
from rtc_tpu_torch.diff import render_grad as RG
from rtc_tpu_torch.models.scenes import REGISTRY
from rtc_tpu_torch.ops import intersect
from rtc_tpu_torch.ops import transforms as X
from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
from rtc_tpu_torch.render import integrator
from rtc_tpu_torch.render.camera import camera_rays
from rtc_tpu_torch.scene.compile import compile_scene
from rtc_tpu_torch.scene.shapes import cone, cube, cylinder, plane, sphere
from rtc_tpu_torch.scene.world import World
from rtc_tpu_torch.utils.config import RenderConfig
from rtc_tpu_torch.utils.constants import BIG, EPSILON

torch.set_num_threads(2)

F64 = torch.float64


def _tables(world):
    """The port's prim tables of world in float64 on the CPU, and the
    oracle's leaves in the same order."""
    scene = compile_scene(world, dtype=F64, device="cpu")
    leaves = oracle.flatten(world)
    codes = {"sphere": intersect.SPHERE, "plane": intersect.PLANE, "cube": intersect.CUBE,
             "cylinder": intersect.CYLINDER, "cone": intersect.CONE}
    assert scene.prim_kind.tolist() == [codes[leaf.kind] for leaf in leaves]
    return integrator.prim_tables(scene), leaves


def _rot(ax, ay, az):
    return X.rotation_x(ax) @ X.rotation_y(ay) @ X.rotation_z(az)


def _mixed():
    return [
        sphere(X.translation(0.5, 0.2, 4.0) @ X.scaling(1.5, 1.5, 1.5)),
        sphere(X.translation(-3.0, 1.0, -2.0) @ X.scaling(0.5, 0.8, 0.5)),
        plane(X.translation(0.0, -2.5, 0.0) @ X.rotation_z(0.1)),
        cube(X.translation(3.0, 0.0, -1.0) @ _rot(0.3, 0.5, 0.2)),
        cylinder(-1.0, 1.0, capped=True,
                 transform=X.translation(-2.0, 0.0, 2.0) @ X.rotation_x(0.7)),
        cylinder(transform=X.translation(0.0, 0.0, -4.0) @ X.scaling(0.4, 1.0, 0.4)),
        cone(-1.0, 0.5, capped=True, transform=X.translation(2.5, 2.0, 2.5)),
        cone(transform=X.translation(-1.0, -1.0, 0.0) @ X.rotation_z(1.2)
             @ X.scaling(0.5, 1.0, 0.5)),
        cube(X.translation(0.0, 3.0, 0.0) @ X.scaling(2.0, 0.3, 1.0)),
    ]


CASES = {
    "sphere": lambda: [sphere(X.translation(0.3, -0.2, 0.5) @ X.scaling(2.0, 1.0, 1.5))],
    "plane": lambda: [plane(X.translation(0.0, -0.5, 0.0) @ _rot(0.2, 0.0, -0.3))],
    "cube": lambda: [cube(_rot(0.4, 0.9, -0.2) @ X.scaling(1.5, 1.0, 2.0))],
    "cylinder_capped": lambda: [cylinder(-1.0, 1.5, capped=True,
                                         transform=_rot(0.3, 0.0, 0.2))],
    "cylinder_open": lambda: [cylinder(-1.0, 1.5, transform=_rot(-0.2, 0.0, 0.5))],
    "cone_capped": lambda: [cone(-1.5, 1.0, capped=True, transform=_rot(0.1, 0.3, -0.4))],
    "cone_open": lambda: [cone(-1.5, 1.0, transform=_rot(0.6, 0.0, 0.1))],
    "mixed": _mixed,
}


def _rays(leaves, n: int, seed: int):
    """n rays: origins in a box around the world, half aimed at a point
    near a prim's centre (so most of them hit), half in random
    directions; distances toward a light in [0.5, 15], every 8th lane
    dead (-1)."""
    rng = np.random.RandomState(seed)
    o = rng.uniform(-6.0, 6.0, (n, 3))
    centres = np.stack([leaf.transform[:3, 3] for leaf in leaves])
    aim = centres[rng.randint(0, len(leaves), n)] + rng.uniform(-1.5, 1.5, (n, 3))
    d = np.where(np.arange(n)[:, None] % 2 == 0, aim - o, rng.normal(size=(n, 3)))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dist = rng.uniform(0.5, 15.0, n)
    dist[::8] = -1.0
    return o, d, dist


def _oracle(leaves, o, d, dist):
    """Per ray: every prim's ts, the closest (t, prim) over t >= 0 ((BIG,
    0) where none is) and the shadow flag, a t in [0, dist)."""
    out = []
    for k in range(o.shape[0]):
        ts = [[x[0] for x in oracle.intersect_leaf(leaf, o[k], d[k])] for leaf in leaves]
        best, prim = BIG, 0
        for i, row in enumerate(ts):
            for t in row:
                if t >= 0.0 and t < best:
                    best, prim = t, i
        shadow = any(0.0 <= t < dist[k] for row in ts for t in row)
        out.append((ts, best, prim, shadow))
    return out


def _near(a, b, tol: float = 1e-9) -> bool:
    return abs(a - b) <= tol * max(1.0, abs(a), abs(b))


def _check_against_oracle(tabs, leaves, o, d, dist):
    """The reduced sweep against the oracle: t to 1e-9, the prim and the
    flag exactly where no other prim's t or the interval's ends lie within
    that tolerance (such a ray could go either way by rounding alone)."""
    ot, dt_, mt = (torch.from_numpy(x) for x in (o, d, dist))
    t, prim = mi.prim_closest(ot, dt_, *tabs, EPSILON)
    flag = mi.prim_any(ot, dt_, mt, *tabs, EPSILON)
    assert t.dtype == F64 and prim.dtype == torch.int32 and flag.dtype == torch.bool
    hits = shadows = 0
    for k, (ts, best, want, shadow) in enumerate(_oracle(leaves, o, d, dist)):
        assert _near(float(t[k]), best), (k, float(t[k]), best)
        others = [x for i, row in enumerate(ts) if i != want for x in row if x >= 0.0]
        if best < BIG and not any(_near(x, best) for x in others):
            assert int(prim[k]) == want, (k, int(prim[k]), want)
        ends = [0.0, dist[k]]
        if not any(_near(x, e) for row in ts for x in row for e in ends):
            assert bool(flag[k]) == shadow, (k, bool(flag[k]), shadow)
        hits += best < BIG
        shadows += shadow
    return hits, shadows


@pytest.mark.parametrize("case", sorted(CASES))
def test_prim_sweep_matches_oracle(case):
    """Each kind alone (cylinder and cone capped and open) and a world of
    nine prims of every kind: the closest (t, prim) and the shadow flag,
    dead lanes unshadowed, against the scalar oracle in float64."""
    world = World(objects=CASES[case]())
    tabs, leaves = _tables(world)
    o, d, dist = _rays(leaves, 384, seed=len(case))
    hits, shadows = _check_against_oracle(tabs, leaves, o, d, dist)
    assert hits > 50 and shadows > 10, (hits, shadows)
    flag = mi.prim_any(*(torch.from_numpy(x) for x in (o, d, dist)), *tabs, EPSILON)
    assert not bool(flag[::8].any())


# world, origin, direction, distance, closest t (None: BIG), prim, shadowed
EDGES = {
    "parallel_to_plane": (lambda: [plane()], (0.0, 1.0, 0.0), (1.0, 0.0, 0.0), 5.0,
                          None, 0, False),
    "in_the_plane": (lambda: [plane()], (0.0, 0.0, 0.0), (0.0, 0.0, 1.0), 5.0,
                     None, 0, False),
    "tangent_to_sphere": (lambda: [sphere()], (1.0, 0.0, -5.0), (0.0, 0.0, 1.0), 6.0,
                          5.0, 0, True),
    "tangent_past_the_light": (lambda: [sphere()], (1.0, 0.0, -5.0), (0.0, 0.0, 1.0), 5.0,
                               5.0, 0, False),
    "inside_the_cube": (lambda: [plane(X.translation(0.0, -3.0, 0.0)), cube()],
                        (0.0, 0.0, 0.0), (0.0, 0.0, 1.0), 2.0, 1.0, 1, True),
    "inside_the_cube_short": (lambda: [cube()], (0.2, -0.3, 0.1), (0.0, 1.0, 0.0), 0.5,
                              1.3, 0, False),
    "cylinder_cap_rim": (lambda: [cylinder(-2.0, 1.0, capped=True)], (1.0, 5.0, 0.0),
                         (0.0, -1.0, 0.0), 10.0, 4.0, 0, True),
    "cone_cap_rim": (lambda: [cone(-1.0, 1.0, capped=True)], (1.0, 5.0, 0.0),
                     (0.0, -1.0, 0.0), 10.0, 4.0, 0, True),
    "all_miss": (lambda: [plane(X.translation(0.0, -10.0, 0.0)), sphere(), cube()],
                 (5.0, 5.0, 5.0), (1.0, 0.0, 0.0), 50.0, None, 0, False),
}


@pytest.mark.parametrize("case", sorted(EDGES))
def test_prim_sweep_edge_cases(case):
    """Rays parallel to and in the plane, tangent to the sphere (the
    double root), from inside the cube, at a cap's rim (x^2 + z^2 == |y|),
    and a row that misses every prim ((BIG, 0)), exactly, and against the
    oracle."""
    make, org, dirn, dist, want_t, want_prim, want_shadow = EDGES[case]
    world = World(objects=make())
    tabs, leaves = _tables(world)
    o, d, m = (np.asarray([x], np.float64) for x in (org, dirn, [dist]))
    m = m[0]
    t, prim = mi.prim_closest(torch.from_numpy(o), torch.from_numpy(d), *tabs, EPSILON)
    flag = mi.prim_any(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(m),
                       *tabs, EPSILON)
    assert float(t[0]) == (BIG if want_t is None else want_t)
    assert int(prim[0]) == want_prim and bool(flag[0]) == want_shadow
    ((_, best, oprim, shadow),) = _oracle(leaves, o, d, m)
    assert (best, oprim, shadow) == (float(t[0]), want_prim, want_shadow)


@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_local_rays_in_affine3_order(dtype):
    """intersect.local_rays rounds as the prim kernel does,
    ((m0 x + m1 y) + m2 z) + m3 a component, and agrees with the einsum it
    replaced (1e-12 in float64, 1e-5 in float32)."""
    tabs, _ = _tables(World(objects=_mixed()))
    inv = tabs[0].to(dtype)
    gen = torch.Generator().manual_seed(7)
    o = torch.randn((256, 3), generator=gen, dtype=F64).to(dtype) * 5
    d = torch.randn((256, 3), generator=gen, dtype=F64).to(dtype)
    o_l, d_l = intersect.local_rays(inv, o, d)
    assert o_l.shape == d_l.shape == (256, inv.shape[0], 3)
    m = inv[None]                                         # (1, N, 3, 4)
    x = [c[:, None, None] for c in o.unbind(1)]           # (R, 1, 1)
    y = [c[:, None, None] for c in d.unbind(1)]
    assert torch.equal(o_l, m[..., 0] * x[0] + m[..., 1] * x[1] + m[..., 2] * x[2]
                       + m[..., 3])
    assert torch.equal(d_l, m[..., 0] * y[0] + m[..., 1] * y[1] + m[..., 2] * y[2])
    tol = 1e-12 if dtype == F64 else 1e-5
    e_o = torch.einsum("nij,rj->rni", inv[:, :, :3], o) + inv[:, :, 3]
    e_d = torch.einsum("nij,rj->rni", inv[:, :, :3], d)
    assert torch.allclose(o_l, e_o, rtol=tol, atol=tol)
    assert torch.allclose(d_l, e_d, rtol=tol, atol=tol)


def test_prim_candidates_reduce_to_the_sweep():
    """integrator.prim_candidates (intersect_all's and the census's sweep)
    reduces to the wrappers' answers: argmin of the valid t >= 0 and any
    t in [0, max_t), with the ids subset the census takes."""
    world = World(objects=_mixed())
    scene = compile_scene(world, dtype=F64, device="cpu")
    o, d, dist = (torch.from_numpy(x) for x in _rays(oracle.flatten(world), 256, seed=3))
    t, v = integrator.prim_candidates(scene, o, d, EPSILON)
    tt = torch.where(v & (t >= 0.0), t, BIG).reshape(o.shape[0], -1)
    t_p, prim = mi.prim_closest(o, d, *integrator.prim_tables(scene), EPSILON)
    assert torch.equal(tt.amin(1), t_p) and torch.equal(tt.argmin(1) // 4, prim.long())
    flag = mi.prim_any(o, d, dist, *integrator.prim_tables(scene), EPSILON)
    assert torch.equal(((v & (t >= 0.0) & (t < dist[:, None, None])).flatten(1).any(1)),
                       flag)
    ids = (1, 4, 7)
    ts, vs = integrator.prim_candidates(scene, o, d, EPSILON, ids=ids)
    assert torch.equal(ts, t[:, list(ids)]) and torch.equal(vs, v[:, list(ids)])


# --- the route -----------------------------------------------------------------

@pytest.fixture(scope="module")
def glass():
    world, cam = REGISTRY["glass_teapot"](24)
    scene = compile_scene(world, dtype=torch.float32, device="cpu")
    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize, cam.half_width,
                       cam.half_height, cam.pixel_size)
    return scene, o, d.contiguous()


def _spy(monkeypatch):
    """Count the calls of the prim kernel's wrappers."""
    calls = {"prim_closest": 0, "prim_any": 0}
    for name in calls:
        def spy(*a, name=name, fn=getattr(mi, name)):
            calls[name] += 1
            return fn(*a)
        monkeypatch.setattr(mi, name, spy)
    return calls


def _card_route(monkeypatch):
    """plan as on the card: prims set wherever the scene has prims (on the
    CPU the wrappers run their plain versions)."""
    real = integrator.plan
    monkeypatch.setattr(integrator, "plan", lambda scene, cfg, device, dtype: real(
        scene, cfg, device, dtype)._replace(prims=scene.static.n_prims > 0))
    return _spy(monkeypatch)


@pytest.mark.parametrize("scene_name, device, dtype, impl, want", [
    ("glass_teapot", "cuda", torch.float32, "auto", True),
    ("glass_teapot", "cuda", torch.float32, "elementwise", True),
    ("glass_teapot", "cuda", torch.float32, "bruteforce", False),
    ("glass_teapot", "cuda", F64, "auto", True),
    ("table", "cuda", torch.float32, "auto", True),
    ("table", "cuda", F64, "auto", True),
    ("table", "cuda", torch.float32, "bruteforce", False),
    ("cow", "cuda", torch.float32, "auto", False),
    ("glass_teapot", "cpu", torch.float32, "auto", False),
    ("table", "cpu", F64, "auto", False)])
def test_plan_takes_the_prim_kernel(scene_name, device, dtype, impl, want):
    """Plan.prims: prims in float32 or float64 on a CUDA device, whatever
    the triangles' route (the prim-only table's is 'bruteforce', and
    glass_teapot's in float64); never under an explicit 'bruteforce', on
    the CPU or in a world without prims."""
    world, _ = REGISTRY[scene_name](8)
    scene = compile_scene(world, dtype=dtype, device="cpu")
    p = integrator.plan(scene, RenderConfig(mesh_impl=impl), device, dtype)
    assert p.prims is want
    if scene_name == "table" or dtype == F64:
        assert p.impl == "bruteforce"


def test_glass_frame_calls_the_prim_kernel(glass, monkeypatch):
    """On the card's route a glass frame sweeps its prims through the
    kernel's wrappers, closest_hit and is_shadowed once a shading node
    (three each), and the image is the plain route's bit for bit (on the
    CPU the wrappers run their plain versions)."""
    scene, o, d = glass
    cfg = RenderConfig()
    want = integrator.color_at(scene, o, d, cfg)
    calls = _card_route(monkeypatch)
    got = integrator.color_at(scene, o, d, cfg)
    assert calls == {"prim_closest": 3, "prim_any": 3}
    assert torch.equal(got, want)


@pytest.mark.parametrize("scene_name", ["hexagon", "table", "single_sphere",
                                        "three_spheres", "glass_spheres", "default_world"])
def test_prim_only_frame_calls_the_prim_kernel(scene_name, monkeypatch):
    """The six worlds without triangles take the prim kernel too (their
    triangles' route is 'bruteforce'): closest_hit and is_shadowed call
    its wrappers once a shading node each, and the image is the plain
    route's bit for bit."""
    world, cam = REGISTRY[scene_name](16)
    scene = compile_scene(world, dtype=torch.float32, device="cpu")
    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize, cam.half_width,
                       cam.half_height, cam.pixel_size)
    o, d = o.contiguous(), d.contiguous()
    cfg = RenderConfig()
    want = integrator.color_at(scene, o, d, cfg)
    calls = _card_route(monkeypatch)
    got = integrator.color_at(scene, o, d, cfg)
    assert calls["prim_closest"] == calls["prim_any"] >= 1, calls
    assert torch.equal(got, want)


def test_cow_frame_never_calls_the_prim_kernel(monkeypatch):
    world, cam = REGISTRY["cow"](16)
    scene = compile_scene(world, dtype=torch.float32, device="cpu")
    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize, cam.half_width,
                       cam.half_height, cam.pixel_size)
    calls = _card_route(monkeypatch)
    integrator.color_at(scene, o.contiguous(), d, RenderConfig())
    assert calls == {"prim_closest": 0, "prim_any": 0}


@pytest.mark.parametrize("case", sorted(CASES))
def test_prim_closest_function_gradients(case):
    """KernelPrimClosest (the kernel's (t, prim), the winner's prim
    re-evaluated backward) against autograd through the plain sweep, in
    float64: (t, prim) equal, and the gradients of o, d, inv and params
    within 1e-10 of each one's largest entry (the sums over the rays run
    in another order); misses get none."""
    world = World(objects=CASES[case]())
    tabs, leaves = _tables(world)
    o, d, _ = (torch.from_numpy(x) for x in _rays(leaves, 256, seed=len(case) + 1))
    w = torch.randn(o.shape[0], generator=torch.Generator().manual_seed(3), dtype=F64)

    def run(sweep):
        xs = [x.clone().requires_grad_(True) for x in (o, d, tabs[0], tabs[2])]
        t, prim = sweep(xs[0], xs[1], xs[2], tabs[1], xs[3])
        hit = t < BIG
        loss = (torch.where(hit, t, 0.0) * w).sum()
        return t.detach(), prim, torch.autograd.grad(loss, xs), hit

    got = run(lambda o, d, inv, kind, params: integrator.KernelPrimClosest.apply(
        EPSILON, o, d, inv, kind, params))
    want = run(lambda *a: mi.prim_closest_plain(*a, EPSILON))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert int(got[3].sum()) > 50
    for g, r in zip(got[2], want[2]):
        scale = max(float(r.abs().max()), 1e-300)
        assert float((g - r).abs().max()) <= 1e-10 * scale
    assert float(got[2][0][~got[3]].abs().max()) == 0.0


@pytest.mark.parametrize("names, closest_calls", [
    (("mat_color", "light_intensity"), 3), (("prim_inv",), 3)])
def test_grad_through_the_prim_kernel(glass, names, closest_calls, monkeypatch):
    """The card's route under gradients: closest_hit calls the kernel's
    wrapper through KernelPrimClosest with the glass fit's parameters
    (colour and light) and with prim_inv a parameter alike. The loss is
    the plain route's bit for bit, and so are the colour's and the
    light's gradients; prim_inv's, summed over the rays in another order
    (by winner rows), within 1e-5 of its largest entry, and nonzero.
    is_shadowed never differentiates: the wrapper every time."""
    scene, o, d = glass
    cfg = RenderConfig()
    target = torch.full_like(o, 0.25)

    def run():
        params = RG.extract_params(scene, names)
        loss = RG.render_loss(params, scene, o, d, target, cfg)
        return loss, torch.autograd.grad(loss, list(params.values()))

    want = run()
    calls = _card_route(monkeypatch)
    got = run()
    assert calls == {"prim_closest": closest_calls, "prim_any": 3}
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        assert float(w.abs().sum()) > 0
        if names == ("prim_inv",):
            assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
        else:
            assert torch.equal(g, w)
