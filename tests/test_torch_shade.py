"""A bounce node's shading (ops/shading.py; the shading kernels,
csrc/mesh_intersect.cu shade_kernel, by mesh_intersect.py shade_surface,
shade_node and shade_blend).

On the CPU: plan's shade flag; the rule that takes the kernels only where
autograd has nothing to record; integrator.SHADE_NODES, one a shaded node
by the path taken; the kernels' route through color_at on the CPU (the
wrappers then run their plain versions) against the plain route on the
registry scenes and on edge-case worlds, and on the f64 goldens; the
metric reader shade_plain_share.frame. PyTorch's CPU kernels round pow
and sqrt by the tensors' layout (vector math over contiguous runs, libm
elsewhere), and the two routes lay out the object rows apart, so on the
CPU the routes agree within 1 ulp; on the card every value is per
element, and the tests hold bits.

On the card (skipped without one): each stage's kernel against its plain
version, bit for bit in float32 and float64 (but float64's pow, below), on
every call of a frame of
cow, glass_teapot, table and a small instanced herd at 192x96, and of the
edge-case worlds (every prim kind, a cylinder's caps within eps, every
pattern kind with coordinates on cell boundaries, inside hits, total
internal reflection, misses, back-facing and parked lanes); render()'s
image on the kernel route against the plain route's; the launches of a
frame; and a replayed graph adding SHADE_NODES' counts. This file imports
neither jax nor rtc_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_shade.py -q
"""

import dataclasses
import importlib.util
import os
import types

import numpy as np
import pytest
import torch

from rtc_tpu_torch.models.scenes import REGISTRY, _herd_cam, cow_herd_world
from rtc_tpu_torch.ops import transforms as X
from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
from rtc_tpu_torch.render import compiled, integrator
from rtc_tpu_torch.render.camera import camera_rays
from rtc_tpu_torch.render.renderer import render
from rtc_tpu_torch.scene.compile import compile_scene
from rtc_tpu_torch.scene.materials import (Material, checkers_pattern, gradient_pattern,
                                           ring_pattern, stripe_pattern, test_pattern)
from rtc_tpu_torch.scene.shapes import cone, cube, cylinder, plane, sphere
from rtc_tpu_torch.scene.world import PointLight, World
from rtc_tpu_torch.utils.config import RenderConfig
from rtc_tpu_torch.utils.constants import FAR, PARK

torch.set_num_threads(2)

F32, F64 = torch.float32, torch.float64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("shade_surface", "shade_node", "shade_blend")
PLAIN = {"shade_surface": mi.shade_surface_plain, "shade_node": mi.shade_node_plain,
         "shade_blend": mi.shade_blend_plain}


def _cfg(dtype, **kw):
    return RenderConfig(dtype="float64" if dtype == F64 else "float32", **kw)


def _camera_rays(cam, dtype=F32):
    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize, cam.half_width,
                       cam.half_height, cam.pixel_size)
    return o.to(dtype).contiguous(), d.to(dtype).contiguous()


# --- edge-case worlds ---------------------------------------------------------

def _prims_world():
    """Every prim kind, a capped cylinder and a capped cone among them,
    reflective, over a checkered floor."""
    shiny = Material(color=(0.8, 0.3, 0.2), reflective=0.3, shininess=50.0)
    return World(objects=[
        sphere(X.translation(-3.0, 1.0, 0.0), shiny),
        plane(X.translation(0.0, -1.0, 0.0),
              Material(pattern=checkers_pattern((1, 1, 1), (0.1, 0.1, 0.1)))),
        cube(X.translation(3.0, 0.0, 0.0) @ X.rotation_y(0.5), shiny),
        cylinder(-1.0, 1.0, capped=True, transform=X.translation(0.0, 0.0, 3.0),
                 material=Material(color=(0.2, 0.8, 0.3))),
        cone(-1.0, 0.0, capped=True, transform=X.translation(0.0, 1.0, -3.0),
             material=Material(color=(0.3, 0.3, 0.9), specular=0.5)),
        cylinder(transform=X.translation(-3.0, 0.0, 4.0) @ X.scaling(0.3, 1.0, 0.3)),
        cone(transform=X.translation(3.0, 0.0, -4.0) @ X.scaling(0.4, 1.0, 0.4)),
    ], light=PointLight((-6.0, 8.0, -6.0), (1.0, 1.0, 1.0)))


def _prims_rays():
    """Rays on the capped cylinder's top cap and just under its rim
    (within eps of the cap's plane), on its side, on the cone's cap."""
    o = [[0.5, 3.0, 3.0], [0.0, 3.0, 3.0], [-3.0, 1.0 - 4e-6, 3.0], [-3.0, 0.3, 3.2],
         [0.2, -3.0, -3.0], [0.0, 5.0, -3.0]]
    d = [[0.0, -1.0, 0.0], [0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [1.0, 0.0, 0.0],
         [0.0, 1.0, 0.0], [0.0, -1.0, 0.0]]
    return o, d


PATTERN_KINDS = (None, stripe_pattern, gradient_pattern, ring_pattern, checkers_pattern,
                 test_pattern)
CUBE_X = (-7.5, -4.5, -1.5, 1.5, 4.5, 7.5)


def _patterns_world():
    """A row of six unit cubes, one a pattern kind (none first), each
    pattern scaled by 1/4 so that a face holds several cells."""
    objs = []
    for cx, make in zip(CUBE_X, PATTERN_KINDS):
        m = Material(color=(0.9, 0.6, 0.3))
        if make is not None:
            pat = make() if make is test_pattern else make((1.0, 0.9, 0.1), (0.1, 0.2, 0.8))
            m.pattern = pat.set_transform(X.scaling(0.25, 0.25, 0.25))
        objs.append(cube(X.translation(cx, 0.0, 0.0), m))
    objs.append(plane(X.translation(0.0, -1.0, 0.0),
                      Material(pattern=ring_pattern((1, 1, 1), (0.2, 0.2, 0.2)))))
    return World(objects=objs, light=PointLight((2.0, 6.0, 8.0), (1.0, 1.0, 1.0)))


def _patterns_rays():
    """Rays straight at each cube's front face (z = 1 at t = 4) on a grid
    of 1/8 in x and y: in pattern space (x4) every other one lies on a
    cell boundary exactly."""
    o, d = [], []
    grid = np.arange(-7, 8) / 8.0
    for cx in CUBE_X:
        for u in grid:
            for v in grid:
                o.append([cx + u, v, 5.0])
                d.append([0.0, 0.0, -1.0])
    return o, d


def _glass_world():
    """A glass ball (reflective and transparent) and a glass cube over a
    checkered floor: inside hits, total internal reflection, the census."""
    glass = dict(transparency=0.9, refractive_index=1.5, reflective=0.9,
                 color=(0.1, 0.1, 0.1), diffuse=0.1, shininess=300.0)
    return World(objects=[
        sphere(X.scaling(1.5, 1.5, 1.5), Material(**glass)),
        cube(X.translation(3.5, 0.0, 0.0) @ X.rotation_y(0.4), Material(**glass)),
        plane(X.translation(0.0, -1.5, 0.0),
              Material(pattern=checkers_pattern((1, 1, 1), (0, 0, 0)), reflective=0.2)),
    ], light=PointLight((-5.0, 6.0, -7.0), (1.0, 1.0, 1.0)))


def _glass_rays():
    """Rays from inside the ball at steep angles to its surface (total
    internal reflection where they leave)."""
    o, d = [], []
    for k in range(64):
        a = 2 * np.pi * k / 64
        o.append([0.0, 0.0, 1.2])
        d.append([np.cos(a), np.sin(a) * 0.2, 0.05])
    return o, d


EDGE_WORLDS = {"prims": (_prims_world, _prims_rays),
               "patterns": (_patterns_world, _patterns_rays),
               "glass": (_glass_world, _glass_rays)}


def edge_case(name, dtype, device="cpu", n_random: int = 2048, seed: int = 3):
    """An edge-case world compiled in dtype on device, and its rays: a
    48x24 camera's, the world's own special rays, seeded random rays (from
    inside objects, pointing away: misses and back-facing lanes) and
    parked rays (FAR, PARK), as unit directions. Returns (scene, o, d)."""
    make_world, make_rays = EDGE_WORLDS[name]
    world = make_world()
    scene = compile_scene(world, dtype=dtype, device=device)
    _, cam = REGISTRY["cow"](48)
    cam = cam.set_transform(X.view_transform(np.array([1.0, 5.0, -10.0]), np.zeros(3),
                                             np.array([0.0, 1.0, 0.0])))
    co, cd = _camera_rays(cam, F64)
    so, sd = (np.asarray(x, dtype=np.float64) for x in make_rays())
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-5.0, 5.0, (n_random, 3))
    rd = rng.normal(size=(n_random, 3))
    po = np.full((64, 3), FAR)
    pd = np.full((64, 3), PARK)
    o = np.concatenate([co.numpy(), so, ro, po])
    d = np.concatenate([cd.numpy(), sd, rd, pd])
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=device).contiguous()
    return scene, as_t(o), as_t(d)


# --- helpers ------------------------------------------------------------------

def _kernel_route(monkeypatch):
    """plan as on the card: the shade flag set (on the CPU the wrappers run
    their plain versions)."""
    real = integrator.plan
    monkeypatch.setattr(integrator, "plan",
                        lambda *a: real(*a)._replace(shade=True))


def _plain_route(monkeypatch):
    real = integrator.plan
    monkeypatch.setattr(integrator, "plan",
                        lambda *a: real(*a)._replace(shade=False))


def _registry(name, width, dtype, device="cpu"):
    world, cam = REGISTRY[name](width)
    return compile_scene(world, dtype=dtype, device=device), cam


def _shades(fn):
    """fn()'s result and the SHADE_NODES it counted."""
    before = dict(integrator.SHADE_NODES)
    out = fn()
    return out, {k: n - before[k] for k, n in integrator.SHADE_NODES.items()}


def ulp_gap(a, b) -> int:
    """The most ulps between two float tensors of one dtype (0: equal bits)."""
    a, b = a.contiguous(), b.contiguous()
    if torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
        return 0
    ints = torch.int64 if a.dtype == F64 else torch.int32
    top = torch.iinfo(ints).min

    def ordered(x):
        i = x.view(ints).to(torch.int64)
        return torch.where(i < 0, top - i, i)
    return int((ordered(a) - ordered(b)).abs().max())


def _reader(name):
    path = os.path.join(ROOT, "rtbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# --- the route ------------------------------------------------------------------

@pytest.mark.parametrize("scene_name, device, dtype, impl, want", [
    ("glass_teapot", "cuda", F32, "auto", True),
    ("glass_teapot", "cuda", F32, "elementwise", True),
    ("glass_teapot", "cuda", F32, "bruteforce", False),
    ("glass_teapot", "cuda", F64, "auto", True),
    ("cow", "cuda", F32, "kernel", True),
    ("table", "cuda", F64, "auto", True),
    ("table", "cuda", F32, "bruteforce", False),
    ("cow", "cpu", F32, "auto", False),
    ("table", "cpu", F64, "auto", False)])
def test_plan_shades_by_kernel(scene_name, device, dtype, impl, want):
    """Plan.shade: float32 or float64 on a CUDA device, unless mesh_impl is
    'bruteforce' (the prims' rule); never on the CPU."""
    scene, _ = _registry(scene_name, 8, dtype)
    assert integrator.plan(scene, RenderConfig(mesh_impl=impl), device, dtype).shade is want


@pytest.mark.parametrize("field", ["mat_color", "light_intensity", "light_pos", "prim_inv",
                                   "pat_inv", "mat_shininess", "mat_ior"])
def test_kernels_only_where_autograd_records_nothing(field):
    """shade_by_kernel: the kernels under no_grad, and with grad on where no
    input of the node requires grad; the plain versions where a scene field
    the node reads, its rays or its hits require grad, and wherever the
    plan says so."""
    scene, cam = _registry("glass_teapot", 16, F32)
    o, d = _camera_rays(cam)
    cfg = RenderConfig()
    p = integrator.plan(scene, cfg, "cuda", F32)
    hit = integrator.closest_hit(scene, o, d, cfg)
    assert p.shade and integrator.shade_by_kernel(p, scene, o, d, hit)
    with torch.no_grad():
        assert integrator.shade_by_kernel(p, scene, o, d, hit)
    param = dataclasses.replace(
        scene, **{field: getattr(scene, field).clone().requires_grad_()})
    assert not integrator.shade_by_kernel(p, param, o, d, hit)
    with torch.no_grad():
        assert integrator.shade_by_kernel(p, param, o, d, hit)
    ray = o.clone().requires_grad_()
    assert not integrator.shade_by_kernel(p, scene, ray, d, hit)
    assert not integrator.shade_by_kernel(
        p, scene, o, d, hit._replace(t=hit.t.clone().requires_grad_()))
    assert not integrator.shade_by_kernel(p._replace(shade=False), scene, o, d, hit)


@pytest.mark.parametrize("scene_name, nodes", [("cow", 2), ("glass_teapot", 3),
                                               ("table", 3), ("single_sphere", 1)])
def test_shade_nodes_count_a_node_by_its_path(scene_name, nodes, monkeypatch):
    """SHADE_NODES counts one a shaded node: cow's primary and reflection
    nodes, glass_teapot's and table's primary, reflection and refraction
    nodes, one node of a matte world; 'plain' on the CPU's route, 'kernel'
    on the card's, whose image (the wrappers' plain versions on the CPU)
    is the plain route's within an ulp."""
    scene, cam = _registry(scene_name, 16, F32)
    o, d = _camera_rays(cam)
    cfg = RenderConfig()
    want, counted = _shades(lambda: integrator.color_at(scene, o, d, cfg))
    assert counted == {"kernel": 0, "plain": nodes}
    _kernel_route(monkeypatch)
    with torch.no_grad():
        got, counted = _shades(lambda: integrator.color_at(scene, o, d, cfg))
    assert counted == {"kernel": nodes, "plain": 0}
    assert ulp_gap(got, want) <= 1


@pytest.mark.parametrize("names", [("mat_color", "light_intensity"), ("mat_ior",)])
def test_fit_step_takes_the_plain_path(monkeypatch, names):
    """A gradient through mat_color and light_intensity, or through mat_ior
    alone (which reaches the node only through the census's n1/n2), on the
    card's route takes the plain versions on every node, and its gradients
    are the plain route's."""
    from rtc_tpu_torch.diff import render_grad as RG

    scene, cam = _registry("glass_teapot", 16, F32)
    o, d = _camera_rays(cam)
    cfg = RenderConfig()
    params = {k: getattr(scene, k).clone().requires_grad_() for k in names}

    def grads():
        img = integrator.color_at(RG.inject_params(scene, params), o, d, cfg)
        return torch.autograd.grad(img.square().sum(), list(params.values()))

    want = grads()
    _kernel_route(monkeypatch)
    got, counted = _shades(grads)
    assert counted == {"kernel": 0, "plain": 3}
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(bool(g.abs().sum() > 0) for g in got)


@pytest.mark.parametrize("name", sorted(EDGE_WORLDS))
@pytest.mark.parametrize("dtype", [F32, F64])
def test_kernel_route_on_edge_worlds(name, dtype, monkeypatch):
    """The edge-case worlds through color_at: the card's route (the stages'
    wrappers, on the CPU their plain versions) is the plain route's within
    an ulp, with the stages called once a node (surface, node) and once a
    branching node (blend)."""
    scene, o, d = edge_case(name, dtype)
    cfg = _cfg(dtype)
    want = integrator.color_at(scene, o, d, cfg)
    _kernel_route(monkeypatch)
    calls = {k: 0 for k in STAGES}
    for k in STAGES:
        monkeypatch.setattr(mi, k, lambda *a, k=k, f=getattr(mi, k), **kw:
                            calls.__setitem__(k, calls[k] + 1) or f(*a, **kw))
    with torch.no_grad():
        got, counted = _shades(lambda: integrator.color_at(scene, o, d, cfg))
    nodes, st = counted["kernel"], scene.static
    blends = int(st.any_reflective or st.any_refractive)
    assert calls == {"shade_surface": nodes, "shade_node": nodes, "shade_blend": blends}
    assert ulp_gap(got, want) <= 1
    assert bool((want.abs().sum(1) > 0).any())


@pytest.mark.parametrize("name", ["cow", "glass_teapot", "table", "glass_spheres"])
def test_kernel_route_reproduces_the_f64_goldens(name, monkeypatch):
    """The goldens of tests/test_golden.py (f64, its width and depth)
    through the card's route, its stages on their plain versions: the
    plain route's image within an ulp, and the goldens at their 1e-9."""
    specs = {"cow": (32, 5), "glass_teapot": (24, 8), "table": (32, 5),
             "glass_spheres": (32, 5)}
    width, depth = specs[name]
    golden = np.load(os.path.join(ROOT, "tests", "golden", f"{name}.npy"))
    scene, cam = _registry(name, width, F64)
    cfg = RenderConfig(dtype="float64", ray_tile=512, max_depth=depth)
    want = render(scene, cam, cfg)
    _kernel_route(monkeypatch)
    got, counted = _shades(lambda: render(scene, cam, cfg))
    assert counted["kernel"] > 0 and counted["plain"] == 0
    assert ulp_gap(got, want) <= 1
    np.testing.assert_allclose(got.numpy(), golden, atol=1e-9, rtol=0)


def test_shade_plain_share_reader():
    """shade_plain_share.frame: the plain nodes over every node, in %; None
    where the program has no counter or shaded no node."""
    read = _reader("shade_plain_share.frame")
    r = types.SimpleNamespace(host={})
    saved = dict(integrator.SHADE_NODES)
    try:
        integrator.SHADE_NODES.update(kernel=30, plain=10)
        assert read(r) == pytest.approx(25.0)
        integrator.SHADE_NODES.update(kernel=0, plain=0)
        assert read(r) is None
        del integrator.SHADE_NODES["plain"]
        assert read(r) is None
    finally:
        integrator.SHADE_NODES.clear()
        integrator.SHADE_NODES.update(saved)


# --- on the card ------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the GPU machine)")
    return torch.device("cuda")


# libdevice's double pow rounds by its build's contraction: PyTorch's own
# kernels are built with fused multiply-adds (nvcc -fmad=true), the
# shading kernels without (-fmad=false, which every other formula needs to
# round as the plain versions' separate operations), and the two builds'
# pow differ by an ulp on a few inputs in 10,000 (float powf does not). So
# in float64 a node's outputs that read a pow, its colour (Phong's
# x ** shininess) and Schlick's reflectance ((1 - cos) ** 5, weights[3]),
# and a frame's image, may differ by 2 ulp; every other output, and every
# float32 one, by none.
POW_OUTPUTS = ("color", "weights[3]")
F64_POW_ULPS = 2


def allowed_ulps(stage, dtype, output) -> int:
    return (F64_POW_ULPS if dtype == F64 and stage == "shade_node" and output in POW_OUTPUTS
            else 0)


def stage_gaps(name, got, want) -> dict:
    """{output: ulp gap} of a stage's kernel outputs against its plain
    version's; a node's weights column by column where the plain version
    has one."""
    if name == "shade_surface":
        return {k: ulp_gap(g, w) for k, g, w in zip(("origin", "direction", "distance"),
                                                    got, want)}
    if name == "shade_blend":
        return {"color": ulp_gap(got, want)}
    out = {"color": ulp_gap(got.color, want.color)}
    for child in ("refl", "refr"):
        g, w = getattr(got, child), getattr(want, child)
        assert (g is None) == (w is None)
        if g is not None:
            out[f"{child}.o"], out[f"{child}.d"] = ulp_gap(g[0], w[0]), ulp_gap(g[1], w[1])
    if got.weights is not None:
        for k, w in enumerate(want.weights):
            if w is not None:
                out[f"weights[{k}]"] = ulp_gap(got.weights[:, k], w)
    return out


def recorded_stages(fn):
    """fn() with each call of the stages' wrappers kept: (fn's result,
    [(stage, args, kwargs, outputs)])."""
    calls = []
    real = {k: getattr(mi, k) for k in STAGES}

    def keeper(k):
        def keep(*a, **kw):
            out = real[k](*a, **kw)
            calls.append((k, a, kw, out))
            return out
        return keep

    for k in STAGES:
        setattr(mi, k, keeper(k))
    try:
        result = fn()
        torch.cuda.synchronize()
    finally:
        for k in STAGES:
            setattr(mi, k, real[k])
    return result, calls


def assert_stages_are_plain(calls):
    """Every recorded stage call's kernel outputs equal its plain
    version's bit for bit (float64's pow outputs within F64_POW_ULPS)."""
    assert calls
    for k, a, kw, out in calls:
        gaps = stage_gaps(k, out, PLAIN[k](*a, **kw))
        dtype = a[1].dtype if k == "shade_blend" else a[0].dtype
        assert all(g <= allowed_ulps(k, dtype, name) for name, g in gaps.items()), (k, gaps)


def _card_frame(name, dtype, cuda):
    if name == "herd":
        scene = compile_scene(cow_herd_world(3, 3), dtype=dtype, device=cuda)
        return scene, _herd_cam(192)
    return _registry(name, 192, dtype, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cow", "glass_teapot", "table", "herd"])
@pytest.mark.parametrize("dtype", [F32, F64])
def test_stage_kernels_match_plain_on_frames(cuda, name, dtype):
    """Each stage's kernel on every call of a 192x96 eager frame (each
    shading node's inputs) against its plain version, bit for bit."""
    scene, cam = _card_frame(name, dtype, cuda)
    o, d = _camera_rays(cam, dtype)
    o, d = o.to(cuda), d.to(cuda)
    with torch.no_grad():
        _, calls = recorded_stages(lambda: integrator.color_at(scene, o, d, _cfg(dtype)))
    assert_stages_are_plain(calls)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(EDGE_WORLDS))
@pytest.mark.parametrize("dtype", [F32, F64])
def test_stage_kernels_match_plain_on_edge_worlds(cuda, name, dtype):
    """The edge-case worlds' rays through color_at on the card: each
    stage's kernel against its plain version, bit for bit."""
    scene, o, d = edge_case(name, dtype, device=cuda)
    with torch.no_grad():
        _, calls = recorded_stages(lambda: integrator.color_at(scene, o, d, _cfg(dtype)))
    assert_stages_are_plain(calls)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, F64])
def test_stage_kernels_match_plain_on_a_world_of_many_objects(cuda, dtype):
    """A world of some 400 objects (a 3x3 herd and 400 spheres): each stage's
    kernel against its plain version, bit for bit."""
    world = cow_herd_world(3, 3)
    world.objects.extend(sphere(X.translation(0.3 * k, -50.0, 0.0)) for k in range(400))
    scene = compile_scene(world, dtype=dtype, device=cuda)
    o, d = _camera_rays(_herd_cam(96), dtype)
    with torch.no_grad():
        _, calls = recorded_stages(lambda: integrator.color_at(
            scene, o.to(cuda), d.to(cuda), _cfg(dtype)))
    assert_stages_are_plain(calls)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["cow", "glass_teapot", "table", "herd"])
@pytest.mark.parametrize("dtype", [F32, F64])
def test_render_on_the_kernels_equals_the_plain_route(cuda, name, dtype, monkeypatch):
    """render()'s image, graphed on the kernel route (the first call, eager,
    and a replay), equals the eager plain route's bit for bit (float64
    within F64_POW_ULPS)."""
    scene, cam = _card_frame(name, dtype, cuda)
    cfg = _cfg(dtype)
    compiled.clear()
    kernel = [render(scene, cam, cfg).clone() for _ in range(2)]
    with monkeypatch.context() as m:
        _plain_route(m)
        with compiled.eager():
            plain, counted = _shades(lambda: render(scene, cam, cfg))
    assert counted["kernel"] == 0 and counted["plain"] > 0
    assert all(ulp_gap(k, plain) <= (F64_POW_ULPS if dtype == F64 else 0) for k in kernel)
    compiled.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("names", [("mat_ior",), ("mat_color", "mat_ior")])
def test_grads_on_the_card_are_the_plain_routes(cuda, names, monkeypatch):
    """A glass_teapot frame's gradient on the card's own route, through
    mat_ior (which reaches a node only through the census's n1/n2) alone
    or with mat_color: every node on the plain versions, and the
    gradients the plain route's bit for bit, mat_ior's not zero."""
    from rtc_tpu_torch.diff import render_grad as RG

    scene, cam = _card_frame("glass_teapot", F32, cuda)
    o, d = _camera_rays(cam)
    o, d = o.to(cuda), d.to(cuda)
    cfg = RenderConfig()
    params = {k: getattr(scene, k).clone().requires_grad_() for k in names}

    def grads():
        img = integrator.color_at(RG.inject_params(scene, params), o, d, cfg)
        return torch.autograd.grad(img.square().sum(), list(params.values()))

    got, counted = _shades(grads)
    assert counted == {"kernel": 0, "plain": 3}
    with monkeypatch.context() as m:
        _plain_route(m)
        want = grads()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert bool(got[0].abs().sum() > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name, nodes, branching", [("cow", 2, 1), ("glass_teapot", 3, 1),
                                                    ("table", 3, 1), ("herd", 1, 0)])
def test_a_replay_adds_the_shading_counts(cuda, name, nodes, branching):
    """A frame's graph takes back its capture's SHADE_NODES and launches
    and each replay adds them: nodes kernel-shaded nodes, a surface and a
    node launch each (cow's fused K3 gives the shadow flag: no surface
    launch), a blend launch a branching node."""
    scene, cam = _card_frame(name, F32, cuda)
    cfg = RenderConfig()
    compiled.clear()
    mi.reset_launch_counts()
    _, counted = _shades(lambda: render(scene, cam, cfg))
    graph = next(g for k, g in compiled._CACHE.items() if k[1] == "frame")
    surface = 0 if integrator.plan(scene, cfg, cuda, F32).fused else nodes
    launches = {"shade_surface": surface, "shade_node": nodes, "shade_blend": branching}
    assert counted == {"kernel": nodes, "plain": 0}
    assert graph.shades == {"kernel": nodes}
    assert {k: graph.launches.get(k, 0) for k in STAGES} == launches
    _, counted = _shades(lambda: render(scene, cam, cfg))
    torch.cuda.synchronize()
    assert counted == {"kernel": nodes, "plain": 0}
    assert {k: mi.LAUNCHES[k] for k in STAGES} == {k: 2 * n for k, n in launches.items()}
    assert graph.replays == 1
    compiled.clear()
