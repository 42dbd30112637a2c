"""The benchmark's table configuration (rtbench/configs/table.json): the
book's 18-cube room through rtc_tpu_torch's prim-only route, and the
reference that knows the book's cube and stripe pattern
(rtbench/reference/prims.py).

The configuration against the port's own scene: its world compiles to
the tables of models/scenes.py table_world(), element for element, and
its camera is the published pose's direction and elevation at 0.75 of
its distance. The port against the reference in f64 on the CPU: the
table at 64x32, and seeded worlds of 6-10 cubes with random affine
transforms, stripes and checkers and one glass cube, under both
container rules. The reference against tracer.py where both apply
(glass_teapot) and against tests/oracle.py on the table. The count of
the prims' plain sweeps (intersect.PLAIN_SWEEPS) after an eager frame,
and on a card through a graph's replay; the census's spans; the cell's
accounting and readers; the cell rehearsed on the CPU (run.py
--rehearse).

The card's test imports neither jax nor rtc_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_table.py -q
"""

import importlib.util
import json
import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from rtbench import accounting_prims
from rtbench.program import Program
from rtbench.reference import geometry as G
from rtbench.reference import prims, tracer
from rtc_tpu_torch.models import scenes
from rtc_tpu_torch.ops import intersect
from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
from rtc_tpu_torch.render import compiled
from rtc_tpu_torch.render.renderer import render
from rtc_tpu_torch.scene.compile import TENSOR_FIELDS, compile_scene
from rtc_tpu_torch.utils import profiling
from rtc_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "table.orbit"
# the port and the reference in f64 differ by rounding alone: the
# reference tests' bound (rtbench/tests/test_bench_reference.py)
F64_ATOL = 1e-9


def _json(*parts):
    with open(os.path.join(ROOT, "rtbench", *parts)) as f:
        return json.load(f)


def _sized(config: dict, width: int) -> dict:
    config = json.loads(json.dumps(config))
    config["canvas"].update(width=width, height=width // 2)
    return config


def _port(config: dict, dtype=torch.float64):
    """The port's frame of the configuration at its camera, on the CPU."""
    prog = Program(config, ROOT, "cpu")
    scene = compile_scene(prog.world(), dtype=dtype, device="cpu",
                          containers=config["render"]["containers"])
    cfg = RenderConfig(dtype={torch.float64: "float64", torch.float32: "float32"}[dtype])
    return render(scene, prog.camera(config["camera"]["from"]), cfg)


def _reference(module, config: dict, px, py):
    c, cam = config["canvas"], config["camera"]
    scene = module.Scene(config, ROOT, torch.float64, "cpu")
    o, d = G.pixel_rays(G.view_transform(cam["from"], cam["to"], cam["up"]), c["width"],
                        c["height"], c["field_of_view"], px, py, torch.float64, "cpu")
    return module.render_rays(scene, o, d, config["render"]["max_depth"])


def _every_pixel(config: dict):
    w, h = config["canvas"]["width"], config["canvas"]["height"]
    py, px = np.divmod(np.arange(w * h), w)
    return px, py


# --- the configuration against the port's own scene ---------------------------

def test_config_is_table_world():
    """The file's world compiles on the CPU to table_world()'s tables,
    element for element: 18 cubes in its order, their transforms,
    materials and patterns (a stripe under a rotation among them), the
    light. Its camera keeps the published pose's direction and elevation
    at 0.75 of its distance, the one cut, which BENCHMARK.json and the
    file both list."""
    config = _json("configs", "table.json")
    prog = Program(config, ROOT, "cpu")
    got = compile_scene(prog.world(), device="cpu")
    want = compile_scene(scenes.table_world(), device="cpu")
    assert got.static == want.static
    for k in TENSOR_FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    st = got.static
    assert (st.n_prims, st.n_tris, st.n_objects) == (18, 0, 18)
    assert list(st.refr_prim_ids) == [7]
    published = config["cuts"]["camera"]["published"]
    _, cam = scenes.table(1920)
    assert np.array_equal(
        Program(dict(config, camera=published), ROOT, "cpu").camera(published["from"]).transform,
        cam.transform)
    to, frm = np.array(published["to"]), np.array(published["from"])
    assert np.allclose(config["camera"]["from"], to + 0.75 * (frm - to), rtol=0, atol=1e-12)
    assert config["camera"]["to"] == published["to"]
    assert (config["canvas"]["width"], config["canvas"]["height"]) == (1920, 960)
    r = config["render"]
    assert (r["max_depth"], r["dtype"], r["tf32"], r["containers"]) == (
        5, "float32", False, "refractive")
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    entry = next(c for c in bench["configs"] if c["name"] == "table")
    assert entry["reduced"] == config["reduced"] == ["camera"]


def test_the_turntable_stays_inside_the_room():
    """Every azimuth of the cut ring puts the eye inside both room cubes
    (floor and ceiling, walls) and outside every other cube, where the
    published ring leaves the walls cube."""
    config = _json("configs", "table.json")
    inv = [np.linalg.inv(G.compose(o["transform"])) for o in config["objects"]]

    def inside(k, eye):
        return bool(np.all(np.abs(inv[k][:3, :3] @ eye + inv[k][:3, 3]) < 1.0))

    def ring(cam, a):
        to = np.array(cam["to"])
        off = np.array(cam["from"]) - to
        r = math.hypot(off[0], off[2])
        return to + np.array([r * math.cos(a), off[1], r * math.sin(a)])

    turns = np.linspace(0.0, 2 * math.pi, 721)
    for a in turns:
        eye = ring(config["camera"], a)
        assert inside(0, eye) and inside(1, eye), a
        assert not any(inside(k, eye) for k in range(2, 18)), a
    published = config["cuts"]["camera"]["published"]
    assert not all(inside(1, ring(published, a)) for a in turns)


# --- the port against the reference --------------------------------------------

def test_port_f64_matches_reference_on_the_table():
    """The port's f64 frame of the table at 64x32 on the CPU, every pixel,
    against prims.py's colours."""
    config = _sized(_json("configs", "table.json"), 64)
    img = _port(config)
    want = _reference(prims, config, *_every_pixel(config))
    assert (want.amax(1) > 0).sum() > 1800  # the room fills the frame
    np.testing.assert_allclose(img.reshape(-1, 3).numpy(), want.numpy(), rtol=0, atol=F64_ATOL)


def _random_cubes(seed: int, containers: str) -> dict:
    """A world of 6-10 cubes around the origin with seeded affine
    transforms (translation, three rotations, a scaling), materials and
    patterns (stripe or checkers under their own seeded transforms, or
    none); one glass cube (transparency 0.7-0.95, ior 1.3-1.7) near the
    middle, and a reflective floor cube under them all; the table's
    light and render settings, at 48x24."""
    rng = np.random.default_rng(seed)
    config = _sized(_json("configs", "table.json"), 48)
    config["render"]["containers"] = containers
    config["camera"] = {"from": [0.0, 3.0, -7.0], "to": [0.0, 0.5, 0.0], "up": [0.0, 1.0, 0.0]}
    config["light"]["position"] = [-4.0, 8.0, -6.0]

    def material(**kw):
        m = {"color": rng.uniform(0.1, 1.0, 3).tolist(), "ambient": rng.uniform(0.05, 0.3),
             "diffuse": rng.uniform(0.3, 0.9), "specular": rng.uniform(0.0, 0.9),
             "shininess": float(rng.choice([10.0, 50.0, 200.0])),
             "reflective": float(rng.choice([0.0, 0.0, rng.uniform(0.1, 0.6)])),
             "transparency": 0.0, "refractive_index": 1.0}
        kind = rng.choice(["stripe", "checkers", "none"])
        if kind != "none":
            m["pattern"] = {"kind": str(kind), "a": rng.uniform(0, 1, 3).tolist(),
                            "b": rng.uniform(0, 1, 3).tolist(),
                            "transform": [["scaling", *rng.uniform(0.1, 0.6, 3)],
                                          ["rotation_y", rng.uniform(-1, 1)],
                                          ["rotation_x", rng.uniform(-1, 1)]]}
        m.update(kw)
        return m

    def transform(pos, size):
        return [["translation", *pos], ["rotation_x", rng.uniform(-0.6, 0.6)],
                ["rotation_y", rng.uniform(-math.pi, math.pi)],
                ["rotation_z", rng.uniform(-0.6, 0.6)], ["scaling", *size]]

    objects = [{"kind": "cube", "transform": [["translation", 0.0, -1.0, 0.0],
                                              ["scaling", 8.0, 1.0, 8.0]],
                "material": material(reflective=0.3)}]
    for _ in range(int(rng.integers(4, 8))):
        pos = [rng.uniform(-3, 3), rng.uniform(0.4, 2.5), rng.uniform(-1, 4)]
        objects.append({"kind": "cube", "transform": transform(pos, rng.uniform(0.2, 0.8, 3)),
                        "material": material()})
    glass = material(transparency=float(rng.uniform(0.7, 0.95)),
                     refractive_index=float(rng.uniform(1.3, 1.7)),
                     reflective=float(rng.uniform(0.05, 0.3)), diffuse=0.2)
    glass.pop("pattern", None)
    objects.insert(int(rng.integers(1, len(objects) + 1)), {
        "kind": "cube", "transform": transform([rng.uniform(-0.6, 0.6), 0.9, rng.uniform(-1, 0)],
                                               rng.uniform(0.5, 0.9, 3)),
        "material": glass})
    config["objects"] = objects
    return config


@pytest.mark.parametrize("containers", ["refractive", "all"])
@pytest.mark.parametrize("seed", [30, 31, 32])
def test_port_f64_matches_reference_on_random_cube_worlds(seed, containers):
    """The port's f64 frame of a seeded cube world at 48x24 on the CPU,
    every pixel, against prims.py's colours under both container rules."""
    config = _random_cubes(seed, containers)
    assert 6 <= len(config["objects"]) <= 10
    img = _port(config)
    want = _reference(prims, config, *_every_pixel(config))
    assert (want.amax(1) > 0).sum() > 800
    np.testing.assert_allclose(img.reshape(-1, 3).numpy(), want.numpy(), rtol=0, atol=F64_ATOL)


# --- the reference against tracer.py and the oracle ------------------------------

@pytest.mark.parametrize("containers", ["refractive", "all"])
def test_reference_agrees_with_tracer_on_glass_teapot(containers):
    """Where both references apply (a smooth glass mesh over a checkered
    plane), prims.py gives tracer.py's colours: both are float64 over the
    same formulas, so to 1e-12."""
    config = _sized(_json("configs", "glass_teapot.json"), 32)
    config["render"]["containers"] = containers
    px, py = _every_pixel(config)
    want = _reference(tracer, config, px, py)
    got = _reference(prims, config, px, py)
    assert (want.amax(1) > 0).sum() > 400
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


def test_reference_matches_oracle_on_the_table():
    """prims.py against tests/oracle.py, the repo's per-ray float64
    oracle of the book's integrator (every object a container), on seeded
    pixels of the table at 64x32."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import oracle

    config = _sized(_json("configs", "table.json"), 64)
    config["render"]["containers"] = "all"
    prog = Program(config, ROOT, "cpu")
    cam = prog.camera(config["camera"]["from"])
    orc = oracle.Oracle(prog.world())
    rng = np.random.default_rng(19)
    px, py = rng.integers(0, 64, 150), rng.integers(0, 32, 150)
    got = _reference(prims, config, px, py).numpy()
    want = np.array([orc.color_at(*oracle.camera_ray(cam, x, y)) for x, y in zip(px, py)])
    assert (want.max(1) > 0).sum() > 120
    np.testing.assert_allclose(got, want, rtol=0, atol=F64_ATOL)


def test_reference_refuses_what_it_lacks():
    config = _sized(_json("configs", "table.json"), 16)
    bad = json.loads(json.dumps(config))
    bad["objects"][0]["kind"] = "sphere"
    with pytest.raises(ValueError, match="no 'sphere' object"):
        prims.Scene(bad, ROOT)
    bad = json.loads(json.dumps(config))
    bad["objects"][0]["material"]["pattern"]["kind"] = "ring"
    with pytest.raises(ValueError, match="no 'ring' pattern"):
        prims.Scene(bad, ROOT)


# --- the plain sweeps' count and the census's spans -----------------------------

def _table_scene(width: int):
    config = _sized(_json("configs", "table.json"), width)
    prog = Program(config, ROOT, "cpu")
    scene = compile_scene(prog.world(), dtype=torch.float64, device="cpu")
    return scene, prog.camera(config["camera"]["from"])


def test_plain_sweep_count_after_an_eager_frame():
    """An eager CPU frame of the table (one tile) sweeps the prims in
    PyTorch at each of its three shading nodes for the closest hit and the
    shadow flag, and once for the primary node's refraction census (the
    children's budget leaves no child of their own): 7 calls of
    intersect.prims, and no kernel launch."""
    scene, cam = _table_scene(16)
    mi.reset_launch_counts()
    before = intersect.PLAIN_SWEEPS["prims"]
    with compiled.eager():
        render(scene, cam, RenderConfig(dtype="float64"))
    assert intersect.PLAIN_SWEEPS["prims"] - before == 7
    assert mi.LAUNCHES == dict.fromkeys(mi.LAUNCHES, 0)
    before = intersect.PLAIN_SWEEPS["prims"]
    with compiled.eager():
        render(scene, cam, RenderConfig(dtype="float64", max_depth=1))
    assert intersect.PLAIN_SWEEPS["prims"] - before == 2  # no child, no census


def _spans(fn):
    profiling.take_spans()
    was = profiling.set_recording(True)
    try:
        fn()
    finally:
        profiling.set_recording(was)
    spans = profiling.take_spans().spans
    return [(s.name, spans[s.parent].name if s.parent >= 0 else None) for s in spans
            if s.name.startswith("rtc.census")]


def test_census_spans_fire_in_an_eager_frame():
    """Recording, an eager frame of the table records one rtc.census with
    one rtc.census.prims inside it (a prim container, the glass cube);
    glass_teapot's census is its mesh's, rtc.census.mesh. Off, none."""
    scene, cam = _table_scene(16)
    cfg = RenderConfig(dtype="float64")
    with compiled.eager():
        got = _spans(lambda: render(scene, cam, cfg))
        assert got == [("rtc.census", "rtc.render"), ("rtc.census.prims", "rtc.census")]
        world, gcam = scenes.glass_teapot(16)
        glass = compile_scene(world, dtype=torch.float64, device="cpu")
        got = _spans(lambda: render(glass, gcam, cfg))
        assert got == [("rtc.census", "rtc.render"), ("rtc.census.mesh", "rtc.census")]
        profiling.take_spans()
        render(scene, cam, cfg)
        assert profiling.take_spans().spans == []


@pytest.mark.cuda
def test_the_plain_sweep_count_is_carried_through_a_replay():
    """On a card, the table's frame is captured once and replayed: the
    capture's plain sweep (the census's) is taken back and kept as the
    graph's sweeps, and each replay adds it, as it adds the prim kernel's
    launches; the replayed image equals the eager one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the GPU machine)")
    config = _sized(_json("configs", "table.json"), 128)
    prog = Program(config, ROOT, "cuda")
    scene = prog.compile(prog.world())
    cam = prog.camera(config["camera"]["from"])
    cfg = RenderConfig()
    compiled.clear()
    with compiled.eager():
        want = render(scene, cam, cfg).clone()
    mi.reset_launch_counts()
    sweeps = intersect.PLAIN_SWEEPS["prims"]
    first = render(scene, cam, cfg).clone()  # the eager run on the side stream, and the capture
    graph = next(g for k, g in compiled._CACHE.items() if k[1] == "frame")
    assert graph.sweeps == {"prims": 1}
    assert graph.launches == {"prim_closest": 3, "prim_any": 3, "shade_surface": 3,
                              "shade_node": 3, "shade_blend": 1}
    assert intersect.PLAIN_SWEEPS["prims"] == sweeps + 1
    got = render(scene, cam, cfg)
    torch.cuda.synchronize()
    assert intersect.PLAIN_SWEEPS["prims"] == sweeps + 2
    assert (mi.LAUNCHES["prim_closest"], mi.LAUNCHES["prim_any"]) == (6, 6)
    assert graph.replays == 1
    assert torch.equal(first, want) and torch.equal(got, want)
    compiled.clear()


# --- the cell's accounting and readers -------------------------------------------

def _reader(name):
    path = os.path.join(ROOT, "rtbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_prim_queries_of_the_table():
    """A 1920x960 table frame: 3 shading nodes a pixel, each a closest and
    an any sweep over 18 cubes; 61 bytes a ray a node; 45 FLOP a ray and
    cube (the 3x4 and 3x3 affines, 33; the slabs, 12). A mesh
    configuration has no such count."""
    q = accounting_prims.frame_queries(_json("configs", "table.json"))
    rays = 1920 * 960 * 3
    assert q == {"queries": 2 * rays * 18, "bytes": rays * 61, "flop": 2 * rays * 18 * 45}
    assert accounting_prims.frame_queries(_json("configs", "glass_teapot.json")) is None


def test_readers_of_the_cell():
    """prim_roofline.frame: the least time over the kernels' time a frame,
    None without a trace or on a mesh configuration. prim_plain_share.frame:
    the plain sweeps over every prim sweep, None where the program has no
    such counter (a parent without it)."""
    config = _json("configs", "table.json")
    summary = types.SimpleNamespace(iterations=4, kernel_s=4e-3, device_s=0.1)
    r = types.SimpleNamespace(ctx=types.SimpleNamespace(config=config), summary=summary,
                              device_name="NVIDIA H100 80GB HBM3", host={})
    roof = _reader("prim_roofline.frame")
    q = accounting_prims.frame_queries(config)
    least = max(q["bytes"] / 3.35e12, q["flop"] / 67e12)
    assert roof(r) == pytest.approx(100 * least / 1e-3)
    assert roof(types.SimpleNamespace(**{**vars(r), "summary": None})) is None
    assert roof(types.SimpleNamespace(**{**vars(r), "ctx": types.SimpleNamespace(
        config=_json("configs", "cow.json"))})) is None
    share = _reader("prim_plain_share.frame")
    saved = dict(intersect.PLAIN_SWEEPS), dict(mi.LAUNCHES)
    try:
        intersect.PLAIN_SWEEPS["prims"] = 10
        mi.LAUNCHES.update(prim_closest=30, prim_any=30)
        assert share(r) == pytest.approx(100 * 10 / 70)
        del intersect.PLAIN_SWEEPS["prims"]
        assert share(r) is None
    finally:
        intersect.PLAIN_SWEEPS.update(saved[0])
        mi.LAUNCHES.update(saved[1])


# --- the cell rehearsed on the CPU ---------------------------------------------

def test_rehearsal_of_the_cell_prints_the_contracts_line():
    """run.py on the CPU at a canvas 16 wide and a 1 s window: the
    contract's line, last on stdout, with the cell's end-to-end metrics,
    each compared number beside its limit on stderr, and correct."""
    proc = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", CELL, "--seed", "3000000019",
         "--seconds", "1", "--trace", "0", "--rehearse", "16"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line)[0] == "correct" and list(line)[-1] == "compared"
    assert set(line["metrics"]) == {"setup_s", "frame_ms", "frame_p95_ms"}
    assert all(v["value"] > 0 for v in line["metrics"].values())
    assert line["device"]["platform"] == "cpu"
    assert set(line["compared"]) == {"bad_share", "gap_p90"}
    for k, v in line["compared"].items():
        assert f"compared {k} {v['value']!r} limit {v['limit']!r}" in proc.stderr
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0


def test_reference_imports_nothing_of_the_program():
    """prims.py loads neither JAX, rtc_tpu nor rtc_tpu_torch."""
    code = ("import sys, json\nsys.path.insert(0, %r)\nimport rtbench.reference.prims\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True)
    loaded = set(json.loads(out.stdout.splitlines()[-1]))
    assert "rtbench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "rtc_tpu", "rtc_tpu_torch"}
