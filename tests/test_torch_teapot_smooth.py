"""The benchmark's teapot_smooth configuration
(rtbench/configs/teapot_smooth.json): the book's smooth Utah teapot under
a gradient through rtc_tpu_torch's fused K3 with_sn route, and the
reference that knows the book's gradient pattern
(rtbench/reference/gradient.py).

The configuration against the port's own scene: its world compiles to
the tables of models/scenes.py teapot_smooth_world(), element for
element, under teapot_smooth's camera, and the card's plan fuses its
closest hit and shadow (K3 with_sn). The port against the reference in
f64 on the CPU: the teapot at 48x24, and seeded worlds of the smooth
teapot under random transforms, gradients and lights, reflective or not
(one with a gradient plane), on the card's route run by the plain
versions. The reference against tracer.py where both apply
(glass_teapot) and against tests/oracle.py on the teapot; what it
refuses; that it loads nothing of the program. The cell's reader
fused_share.frame, and the cell rehearsed on the CPU (run.py
--rehearse). On a card: the 1920x960 frame's fused K3 with_sn, replayed
from a graph, against the split route (K1 with_sn, then K2) under the
kernel parity gate, and the launches of the replayed frame.

The card's test imports neither jax nor rtc_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_teapot_smooth.py -q
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

from rtbench.program import Program
from rtbench.reference import geometry as G
from rtbench.reference import gradient, tracer
from rtbench.reference.obj import read_obj
from rtc_tpu_torch.models import scenes
from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
from rtc_tpu_torch.render import compiled, integrator
from rtc_tpu_torch.render.camera import camera_rays
from rtc_tpu_torch.render.renderer import render
from rtc_tpu_torch.scene.compile import TENSOR_FIELDS, compile_scene
from rtc_tpu_torch.utils.config import RenderConfig
from rtc_tpu_torch.utils.constants import BIG

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "teapot_smooth.orbit"
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


def _port(config: dict):
    """The port's f64 frame of the configuration at its camera, on the
    CPU."""
    prog = Program(config, ROOT, "cpu")
    scene = compile_scene(prog.world(), dtype=torch.float64, device="cpu",
                          containers=config["render"]["containers"])
    return render(scene, prog.camera(config["camera"]["from"]), RenderConfig(dtype="float64"))


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

def test_config_is_teapot_smooth_world():
    """The file's world compiles on the CPU to teapot_smooth_world()'s
    tables, element for element: the smooth teapot's 6,320 triangles and
    corner normals under its translation, the gradient, the light; its
    camera is teapot_smooth's at 1920x960, and nothing is cut."""
    config = _json("configs", "teapot_smooth.json")
    prog = Program(config, ROOT, "cpu")
    got = compile_scene(prog.world(), device="cpu")
    want = compile_scene(scenes.teapot_smooth_world(), device="cpu")
    assert got.static == want.static
    for k in TENSOR_FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    st = got.static
    assert (st.n_prims, st.n_objects, st.any_smooth) == (0, 1, True)
    faces = read_obj(os.path.join(ROOT, config["objects"][0]["file"]))[1]
    assert len(faces) == 6320 and st.n_tris == st.n_clusters * st.cluster_size >= 6320
    _, cam = scenes.teapot_smooth(1920)
    mine = prog.camera(config["camera"]["from"])
    assert np.array_equal(mine.transform, cam.transform)
    assert (mine.hsize, mine.vsize, mine.field_of_view) == (cam.hsize, cam.vsize,
                                                            cam.field_of_view)
    r = config["render"]
    assert (r["max_depth"], r["dtype"], r["tf32"], r["fused_shadow"], r["containers"]) == (
        5, "float32", False, True, "refractive")
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    entry = next(c for c in bench["configs"] if c["name"] == "teapot_smooth")
    assert entry["reduced"] == config["reduced"] == []


def test_the_cards_plan_fuses_the_cell():
    """For float32 rays on a card the plan takes the kernels, one K3
    with_sn launch a node (a pure smooth mesh within one superblock), the
    shading kernels, and nothing else: no prims, no census, no stream."""
    config = _json("configs", "teapot_smooth.json")
    prog = Program(config, ROOT, "cpu")
    scene = compile_scene(prog.world(), device="cpu")
    p = integrator.plan(scene, RenderConfig(), torch.device("cuda"), torch.float32)
    assert (p.impl, p.fused, p.tlas, p.blocks, p.uv, p.census, p.prims, p.shade) == (
        "kernel", True, False, 1, False, False, False, True)
    assert not integrator.plan(scene, RenderConfig(fused_shadow=False), torch.device("cuda"),
                               torch.float32).fused


# --- the port against the reference --------------------------------------------

def test_port_f64_matches_reference_on_teapot_smooth():
    """The port's f64 frame of the teapot at 48x24 on the CPU, every
    pixel, against gradient.py's colours."""
    config = _sized(_json("configs", "teapot_smooth.json"), 48)
    img = _port(config)
    want = _reference(gradient, config, *_every_pixel(config))
    assert (want.amax(1) > 0).sum() > 200  # the teapot: a sixth of the frame
    np.testing.assert_allclose(img.reshape(-1, 3).numpy(), want.numpy(), rtol=0, atol=F64_ATOL)


def _random_teapot(seed: int, with_plane: bool, reflective: float) -> dict:
    """The smooth teapot under a seeded transform (translation, three
    rotations, a scaling), a gradient with seeded colours under a seeded
    scaling and rotation, a seeded material with the given reflective,
    and a seeded light; with_plane adds a gradient floor under it. The
    cell's camera and render settings, at 48x24."""
    rng = np.random.default_rng(seed)
    config = _sized(_json("configs", "teapot_smooth.json"), 48)
    config["light"] = {"position": [float(rng.uniform(-8, 8)), float(rng.uniform(4, 10)),
                                    float(rng.uniform(-9, -3))],
                       "intensity": rng.uniform(0.6, 1.0, 3).tolist()}

    def grad():
        return {"kind": "gradient", "a": rng.uniform(0, 1, 3).tolist(),
                "b": rng.uniform(0, 1, 3).tolist(),
                "transform": [["rotation_y", float(rng.uniform(-math.pi, math.pi))],
                              ["rotation_z", float(rng.uniform(-1, 1))],
                              ["scaling", *rng.uniform(0.3, 2.0, 3).tolist()]]}

    def material(reflective):
        return {"color": [1.0, 1.0, 1.0], "ambient": float(rng.uniform(0.05, 0.3)),
                "diffuse": float(rng.uniform(0.4, 0.9)), "specular": float(rng.uniform(0, 0.9)),
                "shininess": float(rng.choice([10.0, 50.0, 200.0])), "reflective": reflective,
                "transparency": 0.0, "refractive_index": 1.0, "pattern": grad()}

    teapot = config["objects"][0]
    teapot["transform"] = [
        ["translation", *rng.uniform(-0.8, 0.8, 3).tolist()],
        ["rotation_x", float(rng.uniform(-0.5, 0.5))],
        ["rotation_y", float(rng.uniform(-math.pi, math.pi))],
        ["rotation_z", float(rng.uniform(-0.5, 0.5))],
        ["scaling", *rng.uniform(0.7, 1.2, 3).tolist()], ["translation", 0.0, -1.5, 0.0]]
    teapot["material"] = material(reflective)
    if with_plane:
        config["objects"].append({"kind": "plane", "transform": [["translation", 0.0, -2.5, 0.0]],
                                  "material": material(0.0)})
    return config


@pytest.mark.parametrize("seed, with_plane, reflective", [
    (40, False, 0.3), (41, False, 0.0), (43, True, 0.3)])
def test_port_f64_matches_reference_on_random_teapot_worlds(monkeypatch, seed, with_plane,
                                                            reflective):
    """The port's f64 frame of a seeded teapot world at 48x24 on the CPU,
    on the card's route (the kernels' plain versions: the fused K3 with_sn
    a node, its reflected children's nodes too, where the world is the
    teapot alone), every pixel, against gradient.py's colours."""
    config = _random_teapot(seed, with_plane, reflective)
    monkeypatch.setattr(integrator, "mesh_impl_for", lambda *a: "kernel")
    img = _port(config)
    prog = Program(config, ROOT, "cpu")
    scene = compile_scene(prog.world(), dtype=torch.float64, device="cpu")
    assert integrator.plan(scene, RenderConfig(dtype="float64"), "cpu",
                           torch.float64).fused is not with_plane
    want = _reference(gradient, config, *_every_pixel(config))
    assert (want.amax(1) > 0).sum() > 100
    np.testing.assert_allclose(img.reshape(-1, 3).numpy(), want.numpy(), rtol=0, atol=F64_ATOL)


# --- the reference against tracer.py and the oracle ------------------------------

@pytest.mark.parametrize("containers", ["refractive", "all"])
def test_reference_equals_tracer_on_glass_teapot(containers):
    """Where both references apply (a smooth glass mesh over a checkered
    plane), gradient.py gives tracer.py's colours bit for bit: the same
    ray tree, and the same formulas over it."""
    config = _sized(_json("configs", "glass_teapot.json"), 32)
    config["render"]["containers"] = containers
    px, py = _every_pixel(config)
    want = _reference(tracer, config, px, py)
    got = _reference(gradient, config, px, py)
    assert (want.amax(1) > 0).sum() > 400
    assert torch.equal(got, want)


def test_reference_matches_oracle_on_teapot_smooth():
    """gradient.py against tests/oracle.py, the repo's per-ray float64
    oracle of the book's integrator (P_GRADIENT among its patterns), on
    seeded pixels of the teapot at 64x32."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import oracle

    config = _sized(_json("configs", "teapot_smooth.json"), 64)
    config["render"]["containers"] = "all"
    prog = Program(config, ROOT, "cpu")
    cam = prog.camera(config["camera"]["from"])
    orc = oracle.Oracle(prog.world())
    rng = np.random.default_rng(23)
    px, py = rng.integers(12, 52, 150), rng.integers(4, 28, 150)
    got = _reference(gradient, config, px, py).numpy()
    want = np.array([orc.color_at(*oracle.camera_ray(cam, x, y)) for x, y in zip(px, py)])
    assert (want.max(1) > 0).sum() > 45
    np.testing.assert_allclose(got, want, rtol=0, atol=F64_ATOL)


def test_reference_refuses_what_it_lacks():
    config = _sized(_json("configs", "teapot_smooth.json"), 16)
    bad = json.loads(json.dumps(config))
    bad["objects"][0]["kind"] = "cube"
    with pytest.raises(ValueError, match="no 'cube' object"):
        gradient.Scene(bad, ROOT)
    bad = json.loads(json.dumps(config))
    bad["objects"][0]["material"]["pattern"]["kind"] = "ring"
    with pytest.raises(ValueError, match="no 'ring' pattern"):
        gradient.Scene(bad, ROOT)


def test_reference_imports_nothing_of_the_program():
    """gradient.py loads neither JAX, rtc_tpu nor rtc_tpu_torch."""
    code = ("import sys, json\nsys.path.insert(0, %r)\nimport rtbench.reference.gradient\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True)
    loaded = set(json.loads(out.stdout.splitlines()[-1]))
    assert "rtbench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "rtc_tpu", "rtc_tpu_torch"}


# --- the cell's reader and its rehearsal -----------------------------------------

def _reader(name):
    path = os.path.join(ROOT, "rtbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("m_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_fused_share_reader():
    """fused_share.frame: K3's launches (flat and with_sn) over every
    closest-hit launch on a triangle table; 100 on a fused run, 0 on a
    split one, None where no closest hit on triangles was launched."""
    share = _reader("fused_share.frame")
    r = types.SimpleNamespace(ctx=None, summary=None, device_name="cpu", host={})
    saved = dict(mi.LAUNCHES)
    try:
        mi.reset_launch_counts()
        assert share(r) is None
        mi.LAUNCHES.update(prim_closest=6, shade_node=6)
        assert share(r) is None
        mi.LAUNCHES.update(closest_shadow_sn=6, closest_shadow=2)
        assert share(r) == 100.0
        mi.reset_launch_counts()
        mi.LAUNCHES.update(closest_hit_sn=12, any_hit=12)
        assert share(r) == 0.0
        mi.LAUNCHES.update(closest_shadow_sn=4, closest_hit_tlas=4)
        assert share(r) == pytest.approx(100 * 4 / 20)
    finally:
        mi.LAUNCHES.update(saved)


def test_rehearsal_of_the_cell_prints_the_contracts_line():
    """run.py on the CPU at a canvas 16 wide and a 1 s window: the
    contract's line, last on stdout, with the cell's end-to-end metrics,
    each compared number beside its limit on stderr, and correct."""
    proc = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", CELL, "--seed", "3000000023",
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


# --- on the card ------------------------------------------------------------------

@pytest.mark.cuda
def test_fused_frame_replayed_against_the_split_route():
    """teapot_smooth at 1920x960 in f32 on a card. The frame's replay
    launches one K3 with_sn and neither K1 with_sn nor K2. K3 with_sn on
    the frame's 1,843,200 primary rays, replayed from a graph, against the
    split route (K1 with_sn, then K2 on the shadow rays the integrator
    derives): equal hit masks, |dt| <= 1e-3 on the hits, indices that
    differ only at ties, and at most max(2, R // 2048) shadow flips."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the GPU machine)")
    config = _json("configs", "teapot_smooth.json")
    prog = Program(config, ROOT, "cuda")
    scene = prog.compile(prog.world())
    cam = prog.camera(config["camera"]["from"])
    cfg = RenderConfig()
    compiled.clear()
    render(scene, cam, cfg)  # the eager run on the side stream, and the capture
    mi.reset_launch_counts()
    render(scene, cam, cfg)
    torch.cuda.synchronize()
    graph = next(g for k, g in compiled._CACHE.items() if k[1] == "frame")
    assert graph.replays == 1
    print("replayed frame's launches", {k: n for k, n in mi.LAUNCHES.items() if n})
    assert mi.LAUNCHES["closest_shadow_sn"] == 1
    assert mi.LAUNCHES["closest_hit_sn"] == 0 and mi.LAUNCHES["any_hit"] == 0

    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize, cam.half_width,
                       cam.half_height, cam.pixel_size, device="cuda")
    o, d = o.contiguous(), d.contiguous()
    snc = integrator.corner_normals(scene)

    def fused(o, d):
        return mi.mesh_closest_shadow_sn(o, d, scene.tri_p1, scene.tri_e1, scene.tri_e2, snc,
                                         scene.cluster_aabb, scene.light_pos,
                                         scene.static.cluster_size, cfg.epsilon, occ=scene.occ)

    compiled.run(scene, ("k3_sn",), fused, (o, d), "K3 with_sn", keep=(snc,))
    mi.reset_launch_counts()
    t, idx, _, sh = (x.clone() for x in compiled.run(scene, ("k3_sn",), fused, (o, d),
                                                      "K3 with_sn", keep=(snc,)))
    assert mi.LAUNCHES["closest_shadow_sn"] == 1

    split = RenderConfig(fused_shadow=False)
    mi.reset_launch_counts()
    hit = integrator.closest_hit(scene, o, d, split)
    comps = integrator.prepare_hit3(scene, o, d, hit, split)
    over = torch.stack([torch.where(hit.valid, c, 1e12) for c in comps.over_point], 1)
    lv = [scene.light_pos[k] - comps.point[k] for k in range(3)]
    facing = sum(a * b for a, b in zip(lv, comps.normalv)) >= 0.0
    sh_split = integrator.is_shadowed(scene, over, split, live=hit.valid & facing)
    torch.cuda.synchronize()
    assert (mi.LAUNCHES["closest_hit_sn"], mi.LAUNCHES["any_hit"]) == (1, 1)
    assert mi.LAUNCHES["closest_shadow_sn"] == 0

    r = o.shape[0]
    assert r == 1920 * 960
    hit_k = t < BIG * 0.5
    assert torch.equal(hit_k, hit.valid) and torch.equal(idx >= 0, hit_k)
    hits = int(hit_k.sum())
    assert hits > r // 10
    dt = (t - hit.t).abs()[hit_k]
    assert float(dt.max()) <= 1e-3
    other = hit_k & (idx != hit.tri)
    assert bool(((t - hit.t).abs()[other] <= 1e-3).all())
    flips = int((sh != sh_split)[hit_k].sum())
    print("teapot_smooth 1920x960: hits", hits, "index mismatches", int(other.sum()),
          "shadow flips", flips)
    assert flips <= max(2, r // 2048)
    compiled.clear()
