"""rtc_tpu_torch.tools against rtc_tpu's root tools, on the CPU:

- tools.bench: check_kernel_parity passes on cow (the kernel route's
  wrappers take their plain versions on CPU tensors) and raises on each
  of three injected faults (a hit turned into a miss, a t off by 1e-2,
  occlusion flips above the limit); main at width 16 prints one stdout
  line with bench.py's keys and metric text (both read from bench.py's
  source), the suite's lines on stderr; the suite is bench.py's;
  rays_per_pixel of every registry scene's static equals rtc_tpu's;
- tools.perf_probe and tools.kernel_sweep print the key sets of
  perf_probe.py and kernel_sweep.py (read from their sources), the block
  size null on the CPU; --visits counts K1's visits as a dense test of
  every (ray, box) pair does;
- every tool's device defaults to the card and raises without one.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_tools.py -q
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from rtc_tpu.models.scenes import REGISTRY as JAX_REGISTRY
from rtc_tpu.scene.compile import compile_scene as jax_compile_scene
from rtc_tpu.utils.profiling import rays_per_pixel as jax_rays_per_pixel
from rtc_tpu_torch.models.scenes import REGISTRY
from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
from rtc_tpu_torch.render import integrator
from rtc_tpu_torch.scene.compile import compile_scene
from rtc_tpu_torch.tools import bench, graft_entry, kernel_sweep, perf_probe
from rtc_tpu_torch.tools.common import frame_rays
from rtc_tpu_torch.tools.walk import k1_visits, walk_census
from rtc_tpu_torch.utils.config import RenderConfig
from rtc_tpu_torch.utils.constants import BIG
from rtc_tpu_torch.utils.profiling import rays_per_pixel

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _source(name):
    with open(os.path.join(ROOT, name)) as f:
        return ast.parse(f.read())


def _dict_keys(node) -> set:
    return {k.value for k in node.keys if isinstance(k, ast.Constant)}


def _dicts_with(tree, key: str) -> list:
    """The dict literals of tree that have the string key."""
    return [n for n in ast.walk(tree) if isinstance(n, ast.Dict) and key in _dict_keys(n)]


def _function(tree, name):
    return next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name)


def _subscript_keys(fn, var: str) -> set:
    """The constant keys of var[...] = ... assignments in fn."""
    out = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                        and t.value.id == var):
                    if isinstance(t.slice, ast.Constant):
                        out.add(t.slice.value)
                    elif isinstance(t.slice, ast.JoinedStr):  # f"real_R/{frac}_ms"
                        out |= {"".join(str(v.value) if isinstance(v, ast.Constant)
                                        else str(frac) for v in t.slice.values)
                                for frac in (2, 4)}
    return out


@pytest.fixture(scope="module")
def cow():
    world, cam = REGISTRY["cow"](32)
    return compile_scene(world, device="cpu"), cam


@pytest.fixture
def kernel_route(monkeypatch):
    """The integrator takes the kernel route for CPU tensors too (its
    wrappers then return their plain versions), except where a config asks
    for the plain sweep."""
    monkeypatch.setattr(integrator, "mesh_impl_for",
                        lambda scene, cfg, *a: ("bruteforce" if cfg.mesh_impl == "bruteforce"
                                               else "kernel"))


def test_kernel_parity_passes_on_cow(cow, kernel_route, capsys):
    scene, cam = cow
    bench.check_kernel_parity(scene, cam, RenderConfig(ray_tile=2048))
    assert "kernel parity ok on cpu: max |dt|=0.00e+00, occlusion diffs=0/10240" \
        in capsys.readouterr().err


def test_kernel_parity_skips_without_a_kernel_route(cow, capsys):
    scene, cam = cow
    bench.check_kernel_parity(scene, cam, RenderConfig())
    assert "kernel parity: skipped" in capsys.readouterr().err


def _faulty(fn, fault):
    """fn (mesh_closest or is_shadowed) with fault applied to the kernel
    route's output; the plain sweep's ("bruteforce") left as it is."""
    def wrapped(scene, x, *args, **kw):
        cfg = args[-1] if args else kw["cfg"]
        out = fn(scene, x, *args, **kw)
        if cfg.mesh_impl == "bruteforce":
            return out
        if fault == "flips":  # 6 flags flipped: the limit is max(2, 10240 // 2048)
            out = out.clone()
            out[:6] = ~out[:6]
            return out
        t, idx, n = (v.clone() for v in out)
        first = int(torch.nonzero(t < BIG * 0.5)[0])
        if fault == "miss":
            t[first] = BIG
        else:
            t[first] += 1e-2
        return t, idx, n
    return wrapped


@pytest.mark.parametrize("fault,message", [("miss", "hit masks differ on 1 rays"),
                                           ("dt", "closest-hit t diverges"),
                                           ("flips", "occlusion parity: 6 rays differ")])
def test_kernel_parity_raises_on_a_fault(cow, kernel_route, monkeypatch, fault, message):
    scene, cam = cow
    name = "is_shadowed" if fault == "flips" else "mesh_closest"
    monkeypatch.setattr(integrator, name, _faulty(getattr(integrator, name), fault))
    with pytest.raises(AssertionError, match=message):
        bench.check_kernel_parity(scene, cam, RenderConfig(ray_tile=2048))


def _metric_template() -> str:
    """bench.py's metric f-string with its fields named."""
    node = next(v for d in _dicts_with(_source("bench.py"), "metric")
                for k, v in zip(d.keys, d.values) if k.value == "metric")
    return "".join(v.value if isinstance(v, ast.Constant) else
                   "{" + ast.unparse(v.value) + "}" for v in node.values)


@pytest.mark.parametrize("suite", [(), ("teapot_smooth",)])
def test_bench_prints_bench_pys_line(capsys, monkeypatch, suite):
    """One stdout line, bench.py's; with --no-suite no suite line, else
    each suite scene's line on stderr (a one-scene suite here: the herds
    take seconds a frame on the CPU)."""
    monkeypatch.setattr(bench, "SUITE_SCENES", suite or bench.SUITE_SCENES)
    args = ["16", "--device", "cpu"] + ([] if suite else ["--no-suite"])
    assert bench.main(args) == 0
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    (ref_dict,) = _dicts_with(_source("bench.py"), "metric")
    assert set(row) == _dict_keys(ref_dict)
    want = (_metric_template()
            .replace("{scene_name}", "cow").replace("{cam.hsize}", "16")
            .replace("{cam.vsize}", "8")
            .replace("{jax.devices()[0].device_kind}", "cpu"))
    assert "{" not in want and row["metric"] == want
    assert row["unit"] == "rays/s" and row["value"] > 0
    assert row["vs_baseline"] == round(row["value"] / 1e8, 4)
    rows = [json.loads(ln) for ln in err.splitlines() if ln.startswith('{"metric"')]
    assert [r["metric"].split(" (")[1].split(" ")[0] for r in rows] == list(suite)
    frames = [json.loads(ln) for ln in err.splitlines() if ln.startswith('{"scene"')]
    assert [f["scene"] for f in frames] == ["cow", *suite]
    assert all(set(f["frame_ms"]) == {"median", "min", "max"} and f["peak_gib"] is None
               for f in frames)


def test_bench_suite_and_tiles():
    """The suite is bench.py's; without --tile a scene renders at the port's
    default tile, RenderConfig().ray_tile."""
    tree = _source("bench.py")
    suite = next(n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", None) == "SUITE_SCENES")
    assert bench.SUITE_SCENES == ast.literal_eval(suite)
    assert bench.tile_for() == RenderConfig().ray_tile
    assert bench.tile_for(512) == 512


def test_rays_per_pixel_equals_rtc_tpu():
    """The casts a pixel that bench counts, from each registry scene's
    static (unclustered compiles: the flags do not depend on the leaf)."""
    assert sorted(REGISTRY) == sorted(JAX_REGISTRY) and len(REGISTRY) == 14
    for name in REGISTRY:
        st = compile_scene(REGISTRY[name](16)[0], device="cpu", cluster_size=0).static
        js = jax_compile_scene(JAX_REGISTRY[name](16)[0], cluster_size=0).static
        got = rays_per_pixel(5, st.any_reflective, st.any_refractive)
        assert got == jax_rays_per_pixel(5, js.any_reflective, js.any_refractive), name


def test_perf_probe_prints_perf_probe_pys_keys(capsys):
    tree = _source("perf_probe.py")
    perf_probe.main(16, "cow", "cpu")
    stages, rates = (json.loads(ln) for ln in capsys.readouterr().out.splitlines())
    assert set(stages) == _subscript_keys(_function(tree, "main"), "res")
    (ref,) = _dicts_with(tree, "primary_rays_per_s_closest")
    assert set(rates) == _dict_keys(ref)
    assert rates["pixels"] == 128 and all(v > 0 for v in stages.values())

    out = perf_probe.gather_probe(16, "cpu")
    (ref,) = _dicts_with(tree, "gather_tri_n_ms")
    assert set(out) == _dict_keys(ref) and out["R"] == 128 and out["T"] == 6144
    out = perf_probe.kernel_micro(16, "cpu")
    assert set(out) == _subscript_keys(_function(tree, "kernel_micro"), "res") | {"R"}


def test_perf_probe_visits_count_every_entered_box(capsys):
    """--visits' K1 visits on the CPU: a ray visits each cluster whose
    widened slab interval it enters by its final t, as a dense test of
    every (ray, cluster) pair counts; the list length is not known there."""
    primary, reflected = perf_probe.visit_sim(16, "cow", "cpu")
    assert primary["list"] is None and "scans_per_ray_mean" not in primary
    assert 0 < primary["visits_total"] <= primary["overlap_per_ray_mean"] * 128
    world, cam = REGISTRY["cow"](16)
    scene = compile_scene(world, device="cpu")
    o, d = frame_rays(cam, "cpu")
    t = integrator.mesh_closest(scene, o, d, RenderConfig())[0]
    tmin, tmax, empty = mi.box_slabs(o, d, scene.cluster_aabb, True)
    dense = (~empty[None] & (tmax >= tmin) & (tmax >= 0.0)
             & (tmin.clamp_min(0.0) <= t[:, None])).sum(1)
    assert torch.equal(k1_visits(o, d, scene.cluster_aabb, t), dense)
    assert primary["visits_total"] == int(dense.sum())
    model = walk_census(dense, scene.static.n_clusters, 16)
    assert torch.equal(model["new_scans"], dense // 16 + 1)
    assert reflected["sweep"] == "reflected_closest"


def test_kernel_sweep_prints_kernel_sweep_pys_keys(capsys):
    rows = kernel_sweep.sweep(16, device="cpu")
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines == rows and [r["leaf"] for r in rows] == [64, 128, 256]
    (ref,) = _dicts_with(_source("kernel_sweep.py"), "prim_mrays")
    assert all(set(r) == _dict_keys(ref) and r["rt"] is None for r in rows)
    assert [r["n_clusters"] for r in rows] == [96, 48, 24]


@pytest.mark.parametrize("tool", ["bench", "perf_probe", "kernel_sweep", "graft_entry"])
def test_tools_default_to_the_card(tool):
    """Every tool's --device defaults to cuda, and without a card that
    raises: no fallback to the CPU."""
    run = {"bench": lambda: bench.main(["16", "--no-suite"]),
           "perf_probe": lambda: perf_probe.cli(["16"]),
           "kernel_sweep": lambda: kernel_sweep.main(["16"]),
           "graft_entry": lambda: graft_entry.main(["--ranks", "1"])}[tool]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises((AssertionError, RuntimeError)):
        run()
