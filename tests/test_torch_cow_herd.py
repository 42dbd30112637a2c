"""The benchmark's cow_herd configuration (rtbench/configs/cow_herd.json)
and the instanced route it runs.

The configuration against the port's own scene: its world compiles to
the tables of models/scenes.py cow_herd_world(), element for element,
instanced (90 cows in 96 instance slots of one unique mesh). The port
against the plain reference (rtbench/reference, plain torch) on seeded
random herds of 9 cows (52,236 triangles, so the TLAS is built): in f64
on the CPU through the world table's sweep and through the instanced
route's plain versions of K5 and K6, at the reference test's 1e-9; on a
card, the f32 frame through K5 and K6 against the reference in f64 under
the cell's limits (rtbench/workloads/cow_herd.orbit.json). The cell
rehearsed on the CPU (run.py --rehearse). The compile's spans
(rtc.compile.*), recorded and not.

The card's test imports neither jax nor rtc_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_cow_herd.py -q
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rtbench.program import Program
from rtbench.reference import geometry as G
from rtbench.reference import tracer
from rtc_tpu_torch.models import scenes
from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
from rtc_tpu_torch.render import integrator
from rtc_tpu_torch.render.renderer import render
from rtc_tpu_torch.scene.compile import TENSOR_FIELDS, TlasTables, compile_scene
from rtc_tpu_torch.utils import profiling
from rtc_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "cow_herd.orbit"


def _json(*parts):
    with open(os.path.join(ROOT, "rtbench", *parts)) as f:
        return json.load(f)


def _random_herd(seed: int, width: int) -> dict:
    """A configuration of 9 cows (the cell's mesh, flat) on a jittered 3x3
    grid, each with a seeded position, heading and colour, seen from
    above the herd's front; the cell's light and render settings."""
    rng = np.random.default_rng(seed)
    config = _json("configs", "cow_herd.json")
    config["canvas"] = {"width": width, "height": width // 2, "field_of_view": 0.785}
    config["camera"] = {"from": [0.0, 10.0, -18.0], "to": [0.0, 3.0, 2.0],
                        "up": [0.0, 1.0, 0.0]}
    objects = []
    for k in range(9):
        x, z = 3.0 * (k % 3 - 1), 3.0 * (k // 3)
        spec = json.loads(json.dumps(config["objects"][0]))
        spec["transform"] = [
            ["translation", x + rng.uniform(-0.6, 0.6), 3.5, z + rng.uniform(-0.6, 0.6)],
            ["rotation_y", rng.uniform(0.0, 2 * math.pi)], ["scaling", 0.5, 0.5, 0.5]]
        spec["material"]["color"] = rng.uniform(0.3, 1.0, 3).tolist()
        objects.append(spec)
    config["objects"] = objects
    return config


def _fields(scene) -> dict:
    out = {k: getattr(scene, k) for k in TENSOR_FIELDS}
    out.update({f"tlas.{k}": getattr(scene.tlas, k) for k in TlasTables._fields})
    for level in ("occ", "tlas_occ"):
        out.update({f"{level}.{k}": v for k, v in getattr(scene, level)._asdict().items()})
    return out


def _same_tables(a, b) -> None:
    assert a.static == b.static
    fa, fb = _fields(a), _fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


# --- the configuration against the port's own scene --------------------------

def test_config_is_cow_herd_world():
    """The file's world compiles on the CPU to cow_herd_world()'s tables,
    element for element (the world table, the TLAS tables inst_ab,
    inst_mesh, inst_obj and gid among them, both levels' occlusion tables,
    the material and pattern rows, the light): 90 instances in 96 slots of
    1 unique mesh, 522,360 triangles. Its camera is the published pose's
    at 1920x960, and nothing is cut."""
    config = _json("configs", "cow_herd.json")
    prog = Program(config, ROOT, "cpu")
    got = compile_scene(prog.world(), device="cpu")
    want = compile_scene(scenes.cow_herd_world(), device="cpu")
    _same_tables(got, want)
    st = got.static
    assert (st.tlas_n_inst, st.tlas_n_mesh, st.n_objects) == (96, 1, 90)
    assert int((got.tri_e1.abs().sum(1) > 0).sum()) == 522_360
    assert np.array_equal(prog.camera(config["camera"]["from"]).transform,
                          scenes.cow_herd(1920)[1].transform)
    assert (config["canvas"]["width"], config["canvas"]["height"]) == (1920, 960)
    assert config["render"]["max_depth"] == 5 and config["render"]["dtype"] == "float32"
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    entry = next(c for c in bench["configs"] if c["name"] == "cow_herd")
    assert entry["reduced"] == config["reduced"] == []


# --- the port against the plain reference --------------------------------------

def _reference(config, px, py, dtype, device):
    c, cam = config["canvas"], config["camera"]
    scene = tracer.Scene(config, ROOT, dtype, device)
    o, d = G.pixel_rays(G.view_transform(cam["from"], cam["to"], cam["up"]), c["width"],
                        c["height"], c["field_of_view"], px, py, dtype, device)
    return tracer.render_rays(scene, o, d, config["render"]["max_depth"])


@pytest.mark.parametrize("route", ["world_table", "instanced"])
@pytest.mark.parametrize("seed", [20, 21])
def test_port_f64_matches_reference_on_a_random_herd(seed, route, monkeypatch):
    """The port's f64 render of a seeded herd at 32x16 on the CPU, on
    seeded pixels of the canvas's middle, against the reference's colours
    at the reference test's 1e-9 (rtbench/tests/test_bench_reference.py):
    through the world table's sweep (the CPU's route), and through the
    instanced route (the route K5 and K6 take on a card) with their plain
    versions, forced on the CPU."""
    config = _random_herd(seed, 32)
    prog = Program(config, ROOT, "cpu")
    scene = compile_scene(prog.world(), dtype=torch.float64, device="cpu")
    assert scene.static.tlas_n_inst == 16
    if route == "instanced":
        monkeypatch.setattr(integrator, "mesh_impl_for", lambda *a: "kernel")
    img = render(scene, prog.camera(config["camera"]["from"]),
                 RenderConfig(dtype="float64", ray_tile=512))
    rng = np.random.default_rng([seed, 1])
    px, py = rng.integers(8, 24, 120), rng.integers(4, 12, 120)
    want = _reference(config, px, py, torch.float64, "cpu").numpy()
    got = img[torch.as_tensor(py), torch.as_tensor(px)].numpy()
    assert (want.max(1) > 0).sum() > 60  # most pixels see a cow
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [20, 21])
def test_k5_k6_frame_matches_reference_within_the_cells_limits(cuda, seed):
    """A seeded herd's f32 frame at 240x120 through K5 and K6 (no other
    port kernel but the node's shading stages), every pixel against the
    reference in f64, compared as
    the cell's check compares (rtbench/check.py frame_numbers): the share
    of pixels off by more than bad_gap, and the 90th percentile of the lit
    pixels' gaps, each within the cell's limit."""
    cell = _json("workloads", CELL + ".json")
    config = _random_herd(seed, 240)
    prog = Program(config, ROOT, "cuda")
    scene = prog.compile(prog.world())
    mi.reset_launch_counts()
    img = render(scene, prog.camera(config["camera"]["from"]), RenderConfig())
    launched = {k for k, v in mi.LAUNCHES.items() if v}
    assert launched == {"closest_hit_tlas", "any_hit_tlas", "shade_surface",
                        "shade_node"}, mi.LAUNCHES
    py, px = np.divmod(np.arange(240 * 120), 240)
    want = _reference(config, px, py, torch.float64, cuda)
    gap = (img.reshape(-1, 3).double() - want).abs().amax(1)
    lit = gap[want.amax(1) > 0]
    assert lit.numel() > 5000
    bad_share = float((gap > cell["check"]["bad_gap"]).double().mean())
    gap_p90 = float(torch.quantile(lit, 0.9))
    assert bad_share <= cell["limits"]["bad_share"], bad_share
    assert gap_p90 <= cell["limits"]["gap_p90"], gap_p90


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


# --- the compile's spans -------------------------------------------------------

def _recorded_compile(world, on: bool):
    profiling.take_spans()
    was = profiling.set_recording(on)
    try:
        scene = compile_scene(world, device="cpu")
    finally:
        profiling.set_recording(was)
    return scene, [(s.name, s.parent) for s in profiling.take_spans().spans]


def test_compile_records_its_spans_and_off_leaves_the_tables_equal():
    """Recording, a herd's compile_scene is one rtc.compile root over the
    world table's clustering, the instanced tables, the occlusion tables
    of each level and the uploads; a cow's has no instanced tables to
    build. Off, nothing is recorded and the tables are byte-equal."""
    herd = scenes.cow_herd_world(3, 3)
    scene, spans = _recorded_compile(herd, True)
    assert spans[0] == ("rtc.compile", -1)
    assert all(parent == 0 for _, parent in spans[1:])
    assert [n for n, _ in spans[1:]] == [
        "rtc.compile.cluster", "rtc.compile.tlas", "rtc.compile.upload",
        "rtc.compile.occlusion", "rtc.compile.occlusion", "rtc.compile.upload"]
    bare, none = _recorded_compile(herd, False)
    assert none == []
    _same_tables(scene, bare)
    _, cow = _recorded_compile(scenes.cow_world(), True)
    assert ("rtc.compile", -1) in cow and "rtc.compile.cluster" in dict(cow)
    assert "rtc.compile.tlas" not in dict(cow)
