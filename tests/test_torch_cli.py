"""rtc_tpu_torch's user surface against rtc_tpu on the CPU: the PPM canvas
(tests/test_canvas.py's book expectations; bytes equal to rtc_tpu's,
through the C++ and the Python writer), the CLI (`python -m rtc_tpu_torch`:
files, --list, --report, and no fallback when no card is present) and
utils/debug.py (validate_world, checked_color_at, nan_debug)."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rtc_tpu.io.canvas import Canvas as JaxCanvas
from rtc_tpu.io.canvas import write_ppm as jax_write_ppm
from rtc_tpu.models.scenes import REGISTRY as JAX_REGISTRY
from rtc_tpu.render.renderer import render as jax_render
from rtc_tpu.scene import shapes as JS
from rtc_tpu.scene.compile import compile_scene as jax_compile_scene
from rtc_tpu.scene.materials import Material as JaxMaterial
from rtc_tpu.scene.world import World as JaxWorld
from rtc_tpu.scene.world import default_world as jax_default_world
from rtc_tpu.utils.config import RenderConfig as JaxRenderConfig
from rtc_tpu.utils.debug import validate_world as jax_validate_world
from rtc_tpu.utils.profiling import RenderReport as JaxRenderReport
from rtc_tpu_torch import native
from rtc_tpu_torch.cli import main
from rtc_tpu_torch.io.canvas import Canvas
from rtc_tpu_torch.scene import shapes as S
from rtc_tpu_torch.scene.compile import compile_scene
from rtc_tpu_torch.scene.materials import Material
from rtc_tpu_torch.scene.world import World, default_world
from rtc_tpu_torch.utils.config import RenderConfig
from rtc_tpu_torch.utils.debug import checked_color_at, nan_debug, validate_world

from conftest import assert_almost_eq

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- the canvas: tests/test_canvas.py's book expectations ---------------------

def test_creating_a_canvas():
    c = Canvas(10, 20)
    assert c.width == 10 and c.height == 20
    assert np.all(c.pixels == 0.0)


def test_writing_pixels_to_canvas():
    c = Canvas(10, 20)
    c.set_pixel(2, 3, [1.0, 0.0, 0.0])
    assert_almost_eq(c.get_pixel(2, 3), [1.0, 0.0, 0.0])


def test_constructing_the_ppm_header():
    lines = Canvas(5, 3).to_ppm_string().split("\n")
    assert lines[:3] == ["P3", "5 3", "255"]


def test_constructing_the_ppm_pixel_data():
    c = Canvas(5, 3)
    c.set_pixel(0, 0, [1.5, 0.0, 0.0])
    c.set_pixel(2, 1, [0.0, 0.5, 0.0])
    c.set_pixel(4, 2, [-0.5, 0.0, 1.0])
    lines = c.to_ppm_string().split("\n")
    assert len(lines) == 7
    assert lines[3] == "255 0 0 0 0 0 0 0 0 0 0 0 0 0 0"
    assert lines[4] == "0 0 0 0 0 0 0 128 0 0 0 0 0 0 0"
    assert lines[5] == "0 0 0 0 0 0 0 0 0 0 0 0 0 0 255"


def test_splitting_long_lines_in_ppm_files():
    c = Canvas(10, 2)
    c.pixels[:] = [1.0, 0.8, 0.6]
    lines = c.to_ppm_string().split("\n")
    assert len(lines) == 8
    assert lines[3] == "255 204 153 255 204 153 255 204 153 255 204 153 255 204 153 255 204"
    assert lines[4] == "153 255 204 153 255 204 153 255 204 153 255 204 153"
    assert lines[5] == "255 204 153 255 204 153 255 204 153 255 204 153 255 204 153 255 204"
    assert lines[6] == "153 255 204 153 255 204 153 255 204 153 255 204 153"


def test_ppm_files_are_terminated_by_a_newline_character():
    assert Canvas(5, 3).to_ppm_string().endswith("\n")


def _seeded_image(dtype=np.float64):
    """A 13x37 image from a seed, with values below 0, above 1, and on the
    half-steps (k + 0.5) / 255 where rounding decides; f32 images are
    widened exactly, so both packages quantize the same values."""
    rng = np.random.default_rng(7)
    img = rng.uniform(-0.3, 1.3, size=(13, 37, 3))
    halves = (rng.integers(0, 255, size=img.shape) + 0.5) / 255.0
    img = np.where(rng.random(img.shape) < 0.3, halves, img)
    return img.astype(dtype)


@pytest.mark.parametrize("writer", ["native", "python"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_ppm_bytes_equal_rtc_tpu(tmp_path, writer, dtype, monkeypatch):
    img = _seeded_image(np.dtype(dtype))
    want = JaxCanvas.from_image(img).to_ppm_string().encode()
    if writer == "python":
        monkeypatch.setattr(native, "encode_ppm", lambda pixels: None)
    else:
        assert native.encode_ppm(img) is not None, "native/librtc_native.so"
    path = tmp_path / "out.ppm"
    Canvas.from_image(torch.from_numpy(img)).save(str(path))
    assert path.read_bytes() == want


# --- the CLI ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["three_spheres", "hexagon", "cow"])
def test_cli_file_equals_rtc_tpu(tmp_path, name):
    """main on the CPU in f64 writes the bytes rtc_tpu's write_ppm writes of
    rtc_tpu's render of the same scene and config."""
    out = tmp_path / "port.ppm"
    assert main([str(out), "32", "--scene", name, "--device", "cpu",
                 "--dtype", "float64"]) == 0
    world, cam = JAX_REGISTRY[name](32)
    ref = jax_render(jax_compile_scene(world, dtype=np.float64), cam,
                     JaxRenderConfig(dtype="float64"))
    jax_write_ppm(np.asarray(ref), str(tmp_path / "ref.ppm"))
    assert out.read_bytes() == (tmp_path / "ref.ppm").read_bytes()
    assert out.read_bytes().startswith(b"P3\n32 16\n255\n")


def test_cli_file_at_the_default_tile_equals_rtc_tpu(tmp_path):
    """At the port's default tile (the whole 1920x960 frame) main shades
    three_spheres at 160x80 in one tile, rtc_tpu at its 8,192 in two; the
    files are the same bytes (f64)."""
    assert RenderConfig().ray_tile >= 160 * 80 > JaxRenderConfig().ray_tile
    out = tmp_path / "port.ppm"
    assert main([str(out), "160", "--scene", "three_spheres", "--device", "cpu",
                 "--dtype", "float64"]) == 0
    world, cam = JAX_REGISTRY["three_spheres"](160)
    ref = jax_render(jax_compile_scene(world, dtype=np.float64), cam,
                     JaxRenderConfig(dtype="float64"))
    jax_write_ppm(np.asarray(ref), str(tmp_path / "ref.ppm"))
    assert out.read_bytes() == (tmp_path / "ref.ppm").read_bytes()


def test_cli_list_prints_rtc_tpus_scenes(capsys):
    assert main(["--list"]) == 0
    assert capsys.readouterr().out.split() == sorted(JAX_REGISTRY)


def test_cli_list_loads_no_jax():
    """`python -m rtc_tpu_torch --list` imports no jax, jaxlib or rtc_tpu."""
    code = ("import runpy, sys; sys.argv = ['rtc_tpu_torch', '--list']\n"
            "try:\n    runpy.run_module('rtc_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n    assert e.code == 0, e.code\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'rtc_tpu')]; print(bad); sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "cow_herd_smooth" in proc.stdout


def test_cli_without_a_card_raises_and_writes_nothing(tmp_path):
    """The entry point runs on the card unless asked for the CPU: here,
    with no card, it raises where compile_scene does, and does not fall
    back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI renders on it")
    out = tmp_path / "out.ppm"
    with pytest.raises((AssertionError, RuntimeError)):
        main([str(out), "16", "--scene", "single_sphere"])
    assert not out.exists()


def test_cli_usage_and_unknown_scene(capsys):
    assert main([]) == 1
    assert capsys.readouterr().out.startswith("Expected a filename argument!")
    assert main(["x.ppm", "--scene", "nope", "--device", "cpu"]) == 1
    assert "Unknown scene 'nope'" in capsys.readouterr().out


def test_cli_report_has_rtc_tpus_keys(tmp_path, capsys):
    assert main([str(tmp_path / "out.ppm"), "16", "--scene", "single_sphere",
                 "--device", "cpu", "--report"]) == 0
    report = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert list(report) == [f.name for f in dataclasses.fields(JaxRenderReport)]
    assert (report["scene"], report["width"], report["height"], report["device"],
            report["dtype"]) == ("single_sphere", 16, 16, "cpu", "float32")
    assert report["total_ray_casts"] == 2 * 16 * 16
    assert report["rays_per_s"] == pytest.approx(
        report["total_ray_casts"] / report["wall_s"])


# --- debug: tests/test_debug.py's worlds ----------------------------------------

def _debug_worlds(S, Material, World, default_world):
    squashed = S.sphere()
    squashed.set_transform(np.diag([1.0, 0.0, 1.0, 1.0]))
    return {"clean": default_world(),
            "singular": World(objects=[squashed]),
            "material": World(objects=[S.sphere(material=Material(diffuse=-0.5))]),
            "cylinder": World(objects=[S.cylinder(2.0, 1.0, True)])}


@pytest.mark.parametrize("case", ["clean", "singular", "material", "cylinder"])
def test_validate_world_messages_equal_rtc_tpus(case):
    ours = _debug_worlds(S, Material, World, default_world)[case]
    theirs = _debug_worlds(JS, JaxMaterial, JaxWorld, jax_default_world)[case]
    problems = validate_world(ours)
    assert problems == jax_validate_world(theirs)
    assert bool(problems) == (case != "clean")


def _one_ray(dtype=torch.float64):
    o = torch.tensor([[0.0, 0.0, -5.0]], dtype=dtype)
    d = torch.tensor([[0.0, 0.0, 1.0]], dtype=dtype)
    return o, d


def test_checked_color_at_is_clean_on_default_world():
    scene = compile_scene(default_world(), dtype=torch.float64, device="cpu")
    err, colors = checked_color_at(scene, *_one_ray(), RenderConfig(dtype="float64"))
    err.throw()  # no error expected
    assert err.get() is None
    assert bool(torch.isfinite(colors).all())


def test_checked_color_at_throws_on_a_nan_colour():
    scene = compile_scene(default_world(), dtype=torch.float64, device="cpu")
    scene.light_intensity[0] = float("nan")
    err, colors = checked_color_at(scene, *_one_ray(), RenderConfig(dtype="float64"))
    assert not bool(torch.isfinite(colors).all())
    assert "non-finite color output" in err.get()
    with pytest.raises(FloatingPointError, match="non-finite"):
        err.throw()


def test_nan_debug_names_the_op():
    a = torch.tensor([0.0, 1.0])
    with nan_debug():
        b = a * 2  # no NaN: runs
        with pytest.raises(FloatingPointError, match="aten.div"):
            b / a
    assert torch.isnan(a / a).any()  # outside the block NaNs pass
