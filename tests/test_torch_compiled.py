"""The compiled frame (rtc_tpu_torch/render/compiled.py) on the CPU: the
route rule for every registry scene and config, checked against the
superblock streaming a frame really runs; the frame cache's keys, bound and
lifetime, with a stand-in for the CUDA graph that replays by running the
captured function on the graph's static inputs; ray generation from the
camera's values as one tensor, bit-equal to the numpy path; render() and
render_tiles byte-equal to the eager loop they replace, and to rtc_tpu's
f64 renders at 1e-9; and a warmed frame of each registry scene making no
tensor from host data but the camera's values. The graphs themselves run
on the card (tests/test_torch_cuda.py, chip_smoke.py phase 18)."""

import gc

import numpy as np
import pytest
import torch

from rtc_tpu.models.scenes import REGISTRY as JAX_REGISTRY
from rtc_tpu.render.renderer import render as jax_render
from rtc_tpu.scene.compile import compile_scene as jax_compile_scene
from rtc_tpu.utils.config import RenderConfig as JaxRenderConfig
from rtc_tpu_torch.models.scenes import REGISTRY, cow_herd_mesh_world
from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
from rtc_tpu_torch.render import compiled, integrator, progressive, renderer
from rtc_tpu_torch.render.camera import (camera_rays, camera_rays_for_pixels,
                                         camera_values, rays_from_values)
from rtc_tpu_torch.render.order import morton_perm
from rtc_tpu_torch.render.renderer import render
from rtc_tpu_torch.scene.compile import compile_scene
from rtc_tpu_torch.utils.config import RenderConfig
from rtc_tpu_torch.utils.constants import FAR, PARK
from rtc_tpu_torch.utils import constants, profiling

torch.set_num_threads(2)

CUDA = torch.device("cuda")  # route() reads only its type: no card is needed
SMALL_BUDGET = 2 * 128       # two clusters a superblock


def _compile(world, **kw):
    """The port's compile_scene on the CPU: its default device is the card."""
    return compile_scene(world, device="cpu", **kw)


@pytest.fixture(scope="module")
def registry():
    """Every registry scene at width 8, f32 on the CPU."""
    out = {}
    for name, build in REGISTRY.items():
        world, cam = build(8)
        out[name] = _compile(world, dtype=torch.float32), cam
    return out


# --- the route rule ---------------------------------------------------------

@pytest.mark.parametrize("impl", ["auto", "kernel", "elementwise", "bruteforce"])
def test_every_registry_scene_is_graphed_on_the_card(registry, impl):
    """No registry scene streams at its size, so on a CUDA device every
    one replays a graph on every backend; the CPU is eager."""
    for name, (scene, _) in registry.items():
        cfg = RenderConfig(mesh_impl=impl)
        assert compiled.route(scene, cfg, CUDA) == compiled.GRAPHED, name
        assert compiled.route(scene, cfg) == "eager: the CPU", name
        assert not compiled.graphed(scene, cfg, scene.tri_p1.device)


def test_float64_on_the_card_is_graphed_and_a_kernel_route_raises(registry):
    """f64 on the card sweeps densely ('auto' -> 'bruteforce'), which a
    graph takes; an explicit kernel route raises in route() as in the
    frame."""
    scene, _ = registry["glass_teapot"]
    assert compiled.route(scene, RenderConfig(dtype="float64"), CUDA) == compiled.GRAPHED
    with pytest.raises(ValueError, match="float32"):
        compiled.route(scene, RenderConfig(dtype="float64", mesh_impl="kernel"), CUDA)


def test_prim_axis_is_eager(registry):
    for name in ("cow", "glass_teapot", "table"):
        scene, _ = registry[name]
        assert compiled.route(scene, RenderConfig(prim_axis="prims"), CUDA).startswith(
            "eager: primitive sharding"), name


def test_eager_context_disables_graphs(registry, monkeypatch):
    scene, _ = registry["cow"]
    monkeypatch.setattr(compiled, "route", lambda *a: compiled.GRAPHED)
    assert compiled.graphed(scene, RenderConfig(), CUDA)
    with compiled.eager():
        assert not compiled.graphed(scene, RenderConfig(), CUDA)
    assert compiled.graphed(scene, RenderConfig(), CUDA)


@pytest.fixture(scope="module")
def one_mesh_herd():
    """The one-mesh herd's shapes (cow_herd_mesh_world, 2 cows: 96
    clusters in one leaf), flat and smooth."""
    return {smooth: _compile(cow_herd_mesh_world(2, 1, smooth=smooth),
                             dtype=torch.float32)
            for smooth in (False, True)}


def test_a_streamed_table_is_eager(one_mesh_herd, monkeypatch):
    """Over the budget K1 and K2 stream on the kernel route (the plan's
    blocks > 1 and streams), and the frame goes eager; the elementwise
    kernels and the dense sweep never stream; under the budget the same
    table is graphed."""
    for scene in one_mesh_herd.values():
        for impl in ("auto", "kernel", "elementwise", "bruteforce"):
            cfg = RenderConfig(mesh_impl=impl)
            assert compiled.route(scene, cfg, CUDA) == compiled.GRAPHED
            assert not integrator.plan(scene, cfg, CUDA, torch.float32).streams
    monkeypatch.setattr(constants, "VMEM_TRI_BUDGET", SMALL_BUDGET)
    for scene in one_mesh_herd.values():
        for impl in ("auto", "kernel", "elementwise", "bruteforce"):
            cfg = RenderConfig(mesh_impl=impl)
            p = integrator.plan(scene, cfg, CUDA, torch.float32)
            assert p.streams == (impl in ("auto", "kernel")), impl
            assert p.blocks == (1 if impl == "bruteforce" else 48), impl
            route = compiled.route(scene, cfg, CUDA)
            if p.streams:
                assert route.startswith("eager: a streamed table")
            else:
                assert route == compiled.GRAPHED


ROUTE_CASES = [("cow", "auto", 5, True), ("cow", "auto", 5, False),
               ("cow", "elementwise", 5, True), ("teapot_smooth", "auto", 5, True),
               ("glass_teapot", "auto", 5, True), ("glass_teapot", "elementwise", 5, True),
               ("glass_teapot", "elementwise", 3, True), ("glass_teapot", "bruteforce", 5, True),
               ("cow_herd", "auto", 5, True), ("herd_mesh", "auto", 5, True),
               ("herd_mesh", "auto", 5, False), ("herd_mesh_smooth", "auto", 5, True),
               ("herd_mesh", "elementwise", 5, True), ("herd_mesh", "bruteforce", 5, True)]


@pytest.mark.parametrize("name,impl,depth,shadows", ROUTE_CASES)
def test_rule_matches_the_streaming_a_frame_runs(registry, one_mesh_herd, monkeypatch,
                                                name, impl, depth, shadows):
    """With a budget of two clusters a superblock, route() calls a frame
    streamed exactly when its color_at, run on the CPU as the card would
    route it (the wrappers then take their plain versions), calls one of
    the three superblock streaming functions; the plan's tlas and fused
    hold exactly when it calls K5 (mesh_closest_hit_tlas*) and K3
    (mesh_closest_shadow*)."""
    if name.startswith("herd_mesh"):
        scene, cam = one_mesh_herd[name.endswith("smooth")], registry["cow_herd"][1]
    else:
        scene, cam = registry[name]
    cfg = RenderConfig(mesh_impl=impl, max_depth=depth, shadows=shadows)
    monkeypatch.setattr(constants, "VMEM_TRI_BUDGET", SMALL_BUDGET)
    eager = compiled.route(scene, cfg, CUDA) != compiled.GRAPHED
    p = integrator.plan(scene, cfg, CUDA, torch.float32)
    monkeypatch.setattr(integrator, "mesh_impl_for", lambda *a: p.impl)
    calls = {"streamed": [], "tlas": [], "fused": []}
    for kind, names in (("streamed", ("closest_hit_blocked", "any_hit_blocked",
                                      "crossing_count_blocked")),
                        ("tlas", ("mesh_closest_hit_tlas", "mesh_closest_hit_tlas_sn")),
                        ("fused", ("mesh_closest_shadow", "mesh_closest_shadow_sn"))):
        for name in names:
            fn = getattr(mi, name)
            monkeypatch.setattr(mi, name, lambda *a, fn=fn, c=calls[kind], **k:
                                c.append(fn) or fn(*a, **k))
    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize, cam.half_width,
                       cam.half_height, cam.pixel_size)
    with torch.no_grad():
        integrator.color_at(scene, o.contiguous(), d, cfg)
    assert eager == p.streams == bool(calls["streamed"]), (
        compiled.route(scene, cfg, CUDA), len(calls["streamed"]))
    assert p.tlas == bool(calls["tlas"]) and p.fused == bool(calls["fused"]), p


# --- the frame cache ----------------------------------------------------------

class ReplayingGraph(compiled.Graph):
    """The cache's graph with the capture and replay done on the CPU:
    capture runs fn on the static inputs, and a replay runs it again on
    whatever the caller copied into them, so a replay shows what a graph
    reading those inputs would compute."""

    def capture(self):
        compiled.COUNTS["captures"] += 1
        return self.fn(*self.inputs)

    def replay(self):
        self.replays += 1
        return self.fn(*self.inputs)


@pytest.fixture
def cpu_graphs(monkeypatch):
    """render() and render_tiles on the graphed route, on the CPU, with
    ReplayingGraph; an empty cache before and after."""
    monkeypatch.setattr(compiled, "Graph", ReplayingGraph)
    monkeypatch.setattr(compiled, "route", lambda *a: compiled.GRAPHED)
    compiled.clear()
    yield compiled.COUNTS
    compiled.clear()


def _camera(build, width, eye):
    """build's camera at width, looking at the origin from eye."""
    from rtc_tpu_torch.ops import transforms as X

    _, cam = build(width)
    return cam.set_transform(X.view_transform(np.array(eye, float), np.zeros(3),
                                              np.array([0.0, 1.0, 0.0])))


def test_cache_key_canvas_and_cfg_split_camera_values_do_not(cpu_graphs):
    """One capture per (scene, canvas, cfg): a second camera on the same
    canvas replays the first's graph with its own values, and its image
    equals its eager frame; a new canvas or cfg captures anew."""
    world, cam = REGISTRY["cow"](32)
    scene = _compile(world, dtype=torch.float32)
    cam2 = _camera(REGISTRY["cow"], 32, [3.0, 4.0, -9.0])
    cfg, cfg2 = RenderConfig(ray_tile=256), RenderConfig(ray_tile=256, max_depth=1)
    with compiled.eager():
        want = {(c, k): render(scene, c_, k_) for c, c_ in (("a", cam), ("b", cam2))
                for k, k_ in (("cfg", cfg), ("cfg2", cfg2))}
    assert not torch.equal(want["a", "cfg"], want["b", "cfg"])
    captures = cpu_graphs["captures"]
    for c, c_ in (("a", cam), ("b", cam2), ("a", cam)):
        assert torch.equal(render(scene, c_, cfg), want[c, "cfg"])
    assert cpu_graphs["captures"] == captures + 1
    assert compiled.graph_for(scene, ("frame", (16, 32), cfg)).replays == 2
    assert torch.equal(render(scene, cam2, cfg2), want["b", "cfg2"])
    _, cam16 = REGISTRY["cow"](16)
    render(scene, cam16, cfg)
    assert cpu_graphs["captures"] == captures + 3
    assert compiled.graph_for(scene, ("frame", (16, 32), cfg)) is not None
    assert compiled.graph_for(scene, ("frame", (8, 16), cfg)) is not None
    assert compiled.graph_for(scene, ("frame", (16, 32), cfg2)) is not None


class CapturingGraph(ReplayingGraph):
    """ReplayingGraph that lets go of fn (and the scene it holds) at the
    capture, as the CUDA graph does; it cannot replay."""

    def capture(self):
        out = super().capture()
        self.fn = None
        return out


def test_cache_is_bounded_and_dies_with_its_scene(cpu_graphs, monkeypatch):
    """At most MAX_GRAPHS graphs, the least recently used out first; a
    scene's graphs go when it does, and a reassigned field recaptures."""
    monkeypatch.setattr(compiled, "Graph", CapturingGraph)
    world, _ = REGISTRY["three_spheres"](8)
    scene = _compile(world, dtype=torch.float64)
    cfg = RenderConfig(dtype="float64")
    for width in (8, 16, 24, 32, 40, 48):
        render(scene, REGISTRY["three_spheres"](width)[1], cfg)
    assert len(compiled._CACHE) == compiled.MAX_GRAPHS
    assert compiled.graph_for(scene, ("frame", (4, 8), cfg)) is None
    assert compiled.graph_for(scene, ("frame", (24, 48), cfg)) is not None
    captures = cpu_graphs["captures"]
    scene.light_pos = scene.light_pos.clone()
    assert compiled.graph_for(scene, ("frame", (24, 48), cfg)) is None
    render(scene, REGISTRY["three_spheres"](48)[1], cfg)
    assert cpu_graphs["captures"] == captures + 1
    del scene
    gc.collect()
    assert not compiled._CACHE


def test_a_field_reshaped_at_its_address_captures_again(cpu_graphs):
    """A scene field reassigned to a view of its storage with another
    shape keeps its data_ptr(): the graph is no longer the scene's, and the
    next call captures again (as jax.jit retraces on a new shape), its
    image equal to the eager frame."""
    world, cam = REGISTRY["cow"](16)
    scene = _compile(world, dtype=torch.float32)
    cfg = RenderConfig(ray_tile=128)
    key = ("frame", (8, 16), cfg)
    rows = scene.tri_n.shape[0]
    spare = torch.cat([scene.tri_n, torch.zeros((5, 3))])
    scene.tri_n = spare[:rows + 5]  # the winners never read the 5 extra rows
    with compiled.eager():
        want = render(scene, cam, cfg)
    captures = cpu_graphs["captures"]
    render(scene, cam, cfg)
    assert compiled.graph_for(scene, key) is not None
    scene.tri_n = spare[:rows]
    assert scene.tri_n.data_ptr() == spare.data_ptr()
    assert compiled.graph_for(scene, key) is None
    assert torch.equal(render(scene, cam, cfg), want)
    assert cpu_graphs["captures"] == captures + 2
    assert compiled.graph_for(scene, key) is not None
    scene.tri_n = spare.view(-1)[:rows * 3].view(3, rows).t()  # same shape, other strides
    assert scene.tri_n.shape == (rows, 3) and scene.tri_n.data_ptr() == spare.data_ptr()
    assert compiled.graph_for(scene, key) is None


def test_a_frame_graph_keeps_its_pixel_order(cpu_graphs):
    """A frame's graph holds the pixel order its capture read (a replay
    runs no Python that would keep pixel_order's cached tensors alive):
    after nine other canvases push that entry out of pixel_order's cache,
    the graph still holds the very tensors its frame reads, and a replay
    still equals the eager frame. 24x12 is no multiple of 16, so the
    order has its un-permute gather too."""
    world, cam = REGISTRY["cow"](24)
    scene = _compile(world, dtype=torch.float32)
    cfg = RenderConfig(ray_tile=128)
    with compiled.eager():
        want = render(scene, cam, cfg)
    cpu = torch.device("cpu")
    render(scene, cam, cfg)
    graph = compiled.graph_for(scene, ("frame", (12, 24), cfg))
    order = renderer.pixel_order(12, 24, "morton", cpu)
    assert graph.keep is order and graph.fn.args[-1] is order
    assert order[3] is not None
    for width in range(32, 32 + 9 * 8, 8):
        renderer.pixel_order(width // 2, width, "morton", cpu)
    assert renderer.pixel_order(12, 24, "morton", cpu) is not order
    assert graph.keep is order
    assert torch.equal(render(scene, cam, cfg), want)
    assert graph.replays == 1


def test_tile_graph_replays_every_tile(cpu_graphs):
    """render_tiles replays one graph per (scene, tile, cfg), each tile's
    rays copied into it: the tiles equal the eager ones."""
    world, cam = REGISTRY["glass_teapot"](24)
    scene = _compile(world, dtype=torch.float32)
    cfg = RenderConfig(ray_tile=64)
    with compiled.eager():
        want = [c for _, _, c in progressive.render_tiles(scene, cam, cfg)]
    captures = cpu_graphs["captures"]
    got = [c for _, _, c in progressive.render_tiles(scene, cam, cfg, start_tile=1)]
    assert len(want) == 5 and all(np.array_equal(a, b) for a, b in zip(want[1:], got))
    assert cpu_graphs["captures"] == captures + 1
    assert compiled.graph_for(scene, ("tile", 64, cfg)).replays == 3


REPLAY_SPANS = ("rtc.graph.lookup", "rtc.graph.fill", "rtc.graph.replay", "rtc.graph.output")


def recorded(call) -> list:
    """The program's spans of call(), recorded: [(name, parent index)] in
    order of entry."""
    profiling.take_spans()
    profiling.set_recording(True)
    try:
        call()
    finally:
        profiling.set_recording(False)
    return [(s.name, s.parent) for s in profiling.take_spans().spans]


def test_render_records_its_spans(cpu_graphs):
    """A graphed render() is one rtc.render root over the camera's values,
    the route, the graph's lookup, the inputs' fill, the replay and the
    output's copy, in that order; the first call captures where a later
    one replays, and an eager frame has no graph's spans."""
    world, cam = REGISTRY["cow"](16)
    scene = _compile(world, dtype=torch.float32)
    cfg = RenderConfig(ray_tile=64)
    head = [("rtc.render", -1), ("rtc.camera", 0), ("rtc.route", 0)]
    assert recorded(lambda: render(scene, cam, cfg)) == head + [
        ("rtc.graph.lookup", 0), ("rtc.graph.fill", 0), ("rtc.graph.output", 0)]
    assert recorded(lambda: render(scene, cam, cfg)) == head + [(n, 0) for n in REPLAY_SPANS]
    with compiled.eager():
        assert recorded(lambda: render(scene, cam, cfg)) == head


def test_render_tiles_records_a_root_a_tile(cpu_graphs):
    """render_tiles: a root for the rays' set-up with the route, then one
    a tile over its graph's spans; none open across a yield. The stand-in
    graph's replay reruns the tile, so its primary node's refraction
    census (rtc.census over the mesh's rtc.census.mesh) sits under the
    replay; a card's replay runs no Python and records none."""
    world, cam = REGISTRY["glass_teapot"](16)
    scene = _compile(world, dtype=torch.float32)
    cfg = RenderConfig(ray_tile=64)
    list(progressive.render_tiles(scene, cam, cfg))
    got = recorded(lambda: list(progressive.render_tiles(scene, cam, cfg)))
    want = [("rtc.render_tiles", -1), ("rtc.route", 0)]
    for _ in range(2):
        root = len(want)
        want += [("rtc.render_tiles", -1)] + [(n, root) for n in REPLAY_SPANS]
        replay = want.index(("rtc.graph.replay", root))
        want[replay + 1:replay + 1] = [("rtc.census", replay), ("rtc.census.mesh", replay + 1)]
    assert got == want


# --- ray generation, and the CPU route's bytes --------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rays_from_values_equal_the_numpy_path(dtype):
    """The camera's values as one tensor give the rays of the numpy
    matrix and Python floats bit for bit."""
    cam = _camera(REGISTRY["cow"], 48, [2.0, 3.0, -7.0])
    px, py, _, _ = renderer.pixel_order(cam.vsize, cam.hsize, "morton", torch.device("cpu"))
    want = camera_rays_for_pixels(cam.transform_inverse, px, py, cam.half_width,
                                  cam.half_height, cam.pixel_size, dtype)
    values = torch.from_numpy(camera_values(cam)).to(dtype)
    got = rays_from_values(values, px, py)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[1].dtype == dtype


def _render_as_before(scene, cam, cfg):
    """render()'s eager loop as it was before the compiled frame: the
    camera's values converted on each call, the pixel order rebuilt, the
    tiles shaded one by one."""
    dtype, device = cfg.torch_dtype(), scene.tri_p1.device
    vsize, hsize = cam.vsize, cam.hsize
    blocked = cfg.ray_order == "morton" and vsize % 16 == 0 and hsize % 16 == 0
    inv_perm = None
    if blocked:
        px, py = renderer.blocked_pixels(vsize, hsize, device)
    elif cfg.ray_order == "morton":
        perm, inv = morton_perm(vsize, hsize)
        perm, inv_perm = torch.as_tensor(perm), torch.as_tensor(inv)
        px, py = perm % hsize, perm // hsize
    else:
        idx = torch.arange(vsize * hsize)
        px, py = idx % hsize, idx // hsize
    o, d = camera_rays_for_pixels(cam.transform_inverse, px, py, cam.half_width,
                                  cam.half_height, cam.pixel_size, dtype)
    n, tile = o.shape[0], min(cfg.ray_tile, o.shape[0])
    pad = -(-n // tile) * tile - n
    o = torch.cat([o, o.new_full((pad, 3), FAR)])
    d = torch.cat([d, d.new_full((pad, 3), PARK)])
    with torch.no_grad():
        colors = torch.cat([integrator.color_at(scene, o[i:i + tile], d[i:i + tile], cfg)
                            for i in range(0, n + pad, tile)])[:n]
    if blocked:
        return renderer._unblock(colors, vsize, hsize)
    if inv_perm is not None:
        colors = colors[inv_perm]
    return colors.reshape(vsize, hsize, 3)


@pytest.mark.parametrize("name,width,dtype,order", [
    ("cow", 32, "float32", "morton"), ("cow", 40, "float64", "morton"),
    ("glass_teapot", 32, "float64", "morton"), ("glass_teapot", 24, "float32", "scanline"),
    ("table", 32, "float32", "morton"), ("cow_herd", 8, "float32", "morton")])
def test_cpu_render_is_byte_equal_to_before(name, width, dtype, order):
    world, cam = REGISTRY[name](width)
    scene = _compile(world, dtype=torch.float64 if dtype == "float64" else torch.float32)
    cfg = RenderConfig(dtype=dtype, ray_tile=256, ray_order=order)
    img = render(scene, cam, cfg)
    assert img.numpy().tobytes() == _render_as_before(scene, cam, cfg).numpy().tobytes()


def test_cpu_render_tiles_are_byte_equal_to_before():
    world, cam = REGISTRY["glass_teapot"](24)
    scene = _compile(world, dtype=torch.float64)
    cfg = RenderConfig(dtype="float64", ray_tile=64)
    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize, cam.half_width,
                       cam.half_height, cam.pixel_size, torch.float64)
    pad = -(-o.shape[0] // 64) * 64 - o.shape[0]
    o = torch.cat([o, o.new_full((pad, 3), FAR)])
    d = torch.cat([d, d.new_full((pad, 3), PARK)])
    for i, n, colors in progressive.render_tiles(scene, cam, cfg):
        with torch.no_grad():
            want = integrator.color_at(scene, o[i * 64:(i + 1) * 64],
                                       d[i * 64:(i + 1) * 64], cfg)
        assert colors.tobytes() == want.numpy().tobytes()


@pytest.mark.parametrize("name", ["cow", "glass_teapot"])
def test_cpu_render_matches_rtc_tpu_f64(name):
    world, cam = REGISTRY[name](32)
    img = render(_compile(world, dtype=torch.float64), cam,
                 RenderConfig(dtype="float64", ray_tile=256)).numpy()
    jax_world, jax_cam = JAX_REGISTRY[name](32)
    ref = np.asarray(jax_render(jax_compile_scene(jax_world, dtype=np.float64), jax_cam,
                                JaxRenderConfig(dtype="float64", ray_tile=256)))
    np.testing.assert_allclose(img, ref, atol=1e-9, rtol=0)


def test_a_warmed_frame_makes_no_tensor_from_host_data(registry, monkeypatch):
    """After one frame, a frame of each registry scene calls torch.tensor
    and torch.as_tensor on no host data (no list, array or number), and
    torch.from_numpy once: the camera's values, the graph's input."""
    calls = {"tensor": 0, "as_tensor": 0, "from_numpy": 0}

    def counting(name, fn):
        def call(data, *a, **k):
            if not isinstance(data, torch.Tensor):
                calls[name] += 1
            return fn(data, *a, **k)
        return call

    for name, (scene, cam) in registry.items():
        cfg = RenderConfig()
        render(scene, cam, cfg)
        with monkeypatch.context() as m:
            for fn in calls:
                m.setattr(torch, fn, counting(fn, getattr(torch, fn)))
            render(scene, cam, cfg)
        assert calls == {"tensor": 0, "as_tensor": 0, "from_numpy": 1}, name
        calls["from_numpy"] = 0
