"""rtc_tpu_torch's prim-only scenes against rtc_tpu on the CPU: hexagon,
table, single_sphere, three_spheres, glass_spheres and default_world, the
six scenes of rtc_tpu's registry that hold no triangle. Their compiled
tables, their f64 renders (against tests/golden and rtc_tpu), their f32
renders (tests/test_golden.py's F32_BUDGET), and shape_bounds on every
shape of all 14 registry worlds."""

import os

import numpy as np
import pytest
import torch

from rtc_tpu.models import scenes as jax_scenes
from rtc_tpu.render.renderer import render as jax_render
from rtc_tpu.scene.bounds import shape_bounds as jax_shape_bounds
from rtc_tpu.scene.compile import compile_scene as jax_compile_scene
from rtc_tpu.utils.config import RenderConfig as JaxRenderConfig
from rtc_tpu_torch.models import scenes
from rtc_tpu_torch.render.renderer import render
from rtc_tpu_torch.scene.bounds import shape_bounds
from rtc_tpu_torch.scene.compile import (TENSOR_FIELDS, SceneStatic,
                                         compile_scene, scene_from_numpy)
from rtc_tpu_torch.utils.config import RenderConfig
from test_golden import F32_BUDGET, SPECS, _spec

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
PRIM_SCENES = ("hexagon", "table", "single_sphere", "three_spheres",
               "glass_spheres", "default_world")
DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}


def _compile(world, **kw):
    """The port's compile_scene on the CPU: its default device is the card."""
    return compile_scene(world, device="cpu", **kw)


def _quantize(img):
    return np.clip(np.asarray(img, np.float64) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def test_registry_is_rtc_tpus():
    assert list(scenes.REGISTRY) == list(jax_scenes.REGISTRY)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", PRIM_SCENES)
def test_compile_matches_rtc_tpu(name, dtype):
    """Every table and static field equals rtc_tpu's element for element;
    the camera is rtc_tpu's (the square scenes too)."""
    np_dt, torch_dt = DTYPES[dtype]
    width = _spec(SPECS[name])[0]
    jax_world, jax_cam = jax_scenes.REGISTRY[name](width)
    world, cam = scenes.REGISTRY[name](width)
    ref = jax_compile_scene(jax_world, dtype=np_dt)
    scene = _compile(world, dtype=torch_dt)
    for field in TENSOR_FIELDS:
        want, got = np.asarray(getattr(ref, field)), getattr(scene, field).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, field
        assert np.array_equal(got, want), field
    for field in SceneStatic._fields:
        assert getattr(scene.static, field) == getattr(ref.static, field), field
    assert scene.static.n_tris == 0 and scene.static.n_prims > 0
    assert (cam.hsize, cam.vsize, cam.field_of_view) == \
        (jax_cam.hsize, jax_cam.vsize, jax_cam.field_of_view)
    assert np.array_equal(cam.transform, np.asarray(jax_cam.transform))


@pytest.mark.parametrize("name", PRIM_SCENES)
def test_render_f64_matches_golden_and_rtc_tpu(name):
    """At tests/test_golden.py's width and depth (square scenes: width x
    width, which takes the Morton fallback at 24)."""
    width, depth = _spec(SPECS[name])
    golden = np.load(os.path.join(GOLDEN, f"{name}.npy"))
    world, cam = scenes.REGISTRY[name](width)
    img = render(_compile(world, dtype=torch.float64), cam,
                 RenderConfig(dtype="float64", ray_tile=512, max_depth=depth)).numpy()
    np.testing.assert_allclose(img, golden, atol=1e-9, rtol=0)
    jax_world, jax_cam = jax_scenes.REGISTRY[name](width)
    ref = np.asarray(jax_render(
        jax_compile_scene(jax_world, dtype=np.float64), jax_cam,
        JaxRenderConfig(dtype="float64", ray_tile=512, max_depth=depth)))
    np.testing.assert_allclose(img, ref, atol=1e-9, rtol=0)


@pytest.mark.parametrize("name", PRIM_SCENES)
def test_render_f32_meets_golden_budget(name):
    """tests/test_golden.py's F32_BUDGET: the share of pixels whose 8-bit
    bytes equal the f64 golden's, and the structural flips (> 0.15)."""
    width, depth = _spec(SPECS[name])
    golden = np.load(os.path.join(GOLDEN, f"{name}.npy"))
    world, cam = scenes.REGISTRY[name](width)
    img = render(_compile(world, dtype=torch.float32), cam,
                 RenderConfig(ray_tile=512, max_depth=depth)).numpy()
    match_frac = float(np.all(_quantize(golden) == _quantize(img), axis=2).mean())
    flips = int((np.abs(golden - img).max(axis=2) > 0.15).sum())
    min_frac, flip_budget = F32_BUDGET[name]
    assert match_frac >= min_frac and flips <= flip_budget, (match_frac, flips)


def _world(registry_module, name: str):
    """A registry world; the herds cut to 2x2 cows."""
    if name in ("cow_herd", "cow_herd_smooth"):
        return registry_module.cow_herd_world(2, 2, smooth=name == "cow_herd_smooth")
    return registry_module.REGISTRY[name](16)[0]


def _shapes(shape):
    yield shape
    for child in shape.children:
        yield from _shapes(child)


@pytest.mark.parametrize("name", list(jax_scenes.REGISTRY))
def test_shape_bounds_match_rtc_tpu(name):
    """shape_bounds of every shape (groups, leaves, meshes) of every
    registry world equals rtc_tpu's, infinite extents included."""
    ours = [s for obj in _world(scenes, name).objects for s in _shapes(obj)]
    theirs = [s for obj in _world(jax_scenes, name).objects for s in _shapes(obj)]
    assert [s.kind for s in ours] == [s.kind for s in theirs]
    for s, js in zip(ours, theirs):
        lo, hi = shape_bounds(s)
        jlo, jhi = jax_shape_bounds(js)
        assert np.array_equal(lo, jlo) and np.array_equal(hi, jhi), s.kind


def test_glass_spheres_compile_equals_carried_tables():
    """The port's own glass_spheres equals the scene tests/test_torch_grad.py
    carries across from rtc_tpu's compile with scene_from_numpy."""
    ref = jax_compile_scene(jax_scenes.REGISTRY["glass_spheres"](16)[0],
                            dtype=np.float64)
    carried = scene_from_numpy({f: np.asarray(getattr(ref, f)) for f in TENSOR_FIELDS},
                               ref.static._asdict(), device="cpu")
    scene = _compile(scenes.REGISTRY["glass_spheres"](16)[0], dtype=torch.float64)
    assert scene.static == carried.static
    for field in TENSOR_FIELDS:
        assert torch.equal(getattr(scene, field), getattr(carried, field)), field
