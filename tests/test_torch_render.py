"""The port's slice end to end on the CPU: cow through render() against
tests/golden/cow.npy and against rtc_tpu's renders, plus the integrator's
fused branch and the launch-count hygiene."""

import os

import numpy as np
import pytest
import torch

from rtc_tpu.models.scenes import REGISTRY as JAX_REGISTRY
from rtc_tpu.render.renderer import render as jax_render
from rtc_tpu.scene.compile import compile_scene as jax_compile_scene
from rtc_tpu.utils.config import RenderConfig as JaxRenderConfig
from rtc_tpu_torch.models.scenes import REGISTRY
from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
from rtc_tpu_torch.render import integrator
from rtc_tpu_torch.render.camera import camera_rays
from rtc_tpu_torch.render.renderer import render
from rtc_tpu_torch.scene.compile import compile_scene
from rtc_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(2)


def _compile(world, **kw):
    """The port's compile_scene on the CPU: its default device is the card."""
    return compile_scene(world, device="cpu", **kw)


GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
# tests/test_golden.py: cow golden width, and its f32 budget
# (min exact-match fraction after 8-bit quantization, structural flips)
COW_WIDTH = 32
COW_F32_BUDGET = (0.98, 2)


def _quantize(img):
    return np.clip(np.asarray(img, np.float64) * 255.0 + 0.5, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def cow64():
    world, cam = REGISTRY["cow"](64)
    return _compile(world, dtype=torch.float32), cam


def test_render_f64_matches_golden_and_rtc_tpu():
    golden = np.load(os.path.join(GOLDEN, "cow.npy"))
    world, cam = REGISTRY["cow"](COW_WIDTH)
    scene = _compile(world, dtype=torch.float64)
    img = render(scene, cam, RenderConfig(dtype="float64", ray_tile=512)).numpy()
    np.testing.assert_allclose(img, golden, atol=1e-9, rtol=0)
    jax_world, jax_cam = JAX_REGISTRY["cow"](COW_WIDTH)
    ref = np.asarray(jax_render(jax_compile_scene(jax_world, dtype=np.float64),
                                jax_cam, JaxRenderConfig(dtype="float64",
                                                         ray_tile=512)))
    np.testing.assert_allclose(img, ref, atol=1e-9, rtol=0)


def test_color_at_matches_reference_oracle_f64():
    """Against tests/oracle.py, the NumPy transliteration of the reference
    integrator that shares no code with either package: 100 random camera
    rays of cow in float64, at tests/test_oracle.py's 1e-9."""
    import oracle

    world, cam = REGISTRY["cow"](64)
    rng = np.random.default_rng(1234)
    rays = [oracle.camera_ray(cam, int(x), int(y)) for x, y in zip(
        rng.integers(0, cam.hsize, 100), rng.integers(0, cam.vsize, 100))]
    o, d = (np.array(a) for a in zip(*rays))
    ref = oracle.Oracle(world, max_depth=5)
    expected = np.array([ref.color_at(o[i], d[i]) for i in range(len(o))])
    got = integrator.color_at(_compile(world, dtype=torch.float64),
                              torch.from_numpy(o), torch.from_numpy(d),
                              RenderConfig(dtype="float64"))
    np.testing.assert_allclose(got.numpy(), expected, atol=1e-9, rtol=0)


def test_render_f32_matches_f64_golden():
    golden = np.load(os.path.join(GOLDEN, "cow.npy"))
    world, cam = REGISTRY["cow"](COW_WIDTH)
    img = render(_compile(world, dtype=torch.float32), cam,
                 RenderConfig(ray_tile=512)).numpy()
    match_frac = float(np.all(_quantize(golden) == _quantize(img), axis=2).mean())
    flips = int((np.abs(golden - img).max(axis=2) > 0.15).sum())
    min_frac, flip_budget = COW_F32_BUDGET
    assert match_frac >= min_frac and flips <= flip_budget, (match_frac, flips)


@pytest.fixture(scope="module")
def port64(cow64):
    scene, cam = cow64
    mi.reset_launch_counts()
    img = render(scene, cam, RenderConfig(ray_tile=512)).numpy()
    return img, dict(mi.LAUNCHES)


def test_auto_on_cpu_launches_no_kernel(port64):
    _, launches = port64
    assert launches == dict.fromkeys(mi.LAUNCHES, 0)


@pytest.mark.parametrize("fused_shadow", [True, False])
def test_render_f32_matches_rtc_tpu_kernels(port64, fused_shadow):
    """Against rtc_tpu's Pallas path in interpret mode, fused and split:
    the 99.9th-percentile error stays below 2e-3 and at most 3 pixels
    differ by more than 0.05 (tests/test_pallas_mesh.py's budget)."""
    img, _ = port64
    world, cam = JAX_REGISTRY["cow"](64)
    ref = np.asarray(jax_render(
        jax_compile_scene(world, dtype=np.float32), cam,
        JaxRenderConfig(dtype="float32", ray_tile=512,
                        mesh_impl="mxu_interpret", fused_shadow=fused_shadow)))
    err = np.abs(img - ref).max(axis=2)
    assert np.quantile(err, 0.999) < 2e-3 and (err > 0.05).sum() <= 3


def test_fused_branch_equals_split_branch(cow64, monkeypatch):
    """color_at's fused branch (one K3 call per node) against its split
    branch (K1, then K2 on the shading frame's shadow rays). On the CPU the
    wrappers run their plain versions, whose phase 2 repeats the
    integrator's formulas operation for operation, so the two branches
    agree bit for bit."""
    scene, cam = cow64
    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize,
                       cam.half_width, cam.half_height, cam.pixel_size)
    o = o.contiguous()
    monkeypatch.setattr(integrator, "mesh_impl_for", lambda *a: "kernel")
    mi.reset_launch_counts()
    fused = integrator.color_at(scene, o, d, RenderConfig())
    split = integrator.color_at(scene, o, d, RenderConfig(fused_shadow=False))
    assert torch.equal(fused, split)
    assert mi.LAUNCHES == dict.fromkeys(mi.LAUNCHES, 0)


def test_kernel_impl_on_cpu_raises(cow64):
    scene, cam = cow64
    with pytest.raises(ValueError, match="CUDA"):
        render(scene, cam, RenderConfig(mesh_impl="kernel"))


def test_morton_fallback_is_a_permutation():
    """A canvas that does not divide into 16x16 blocks renders in Z-order;
    pixels come out exactly as in scanline order."""
    world, cam = REGISTRY["cow"](40)
    scene = _compile(world, dtype=torch.float32)
    cfg = RenderConfig(ray_tile=256)
    morton = render(scene, cam, cfg)
    scanline = render(scene, cam, RenderConfig(ray_tile=256, ray_order="scanline"))
    assert morton.shape == (20, 40, 3)
    assert torch.equal(morton, scanline)
