"""The elementwise cross-check backend (K7a, K7b) and the flat-mesh scenes
teapot and pumpkin, in rtc_tpu_torch against rtc_tpu on the CPU: K7a's and
K7b's plain versions against rtc_tpu's Pallas kernels in interpret mode on
teapot at 32 px, with rtc_tpu's own gates (tests/test_pallas_mesh.py:28-64,
tests/test_anyhit.py); the 'elementwise' render against rtc_tpu's
'pallas_interpret' render; the integrator's elementwise branch calling only
K7a, K7b and the census; and the f64 renders of teapot and pumpkin against
their goldens and rtc_tpu's. The CUDA kernels are held against these plain
versions on the GPU (tests/test_torch_cuda.py, chip_smoke.py).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rtc_tpu.models.scenes import REGISTRY as JAX_REGISTRY
from rtc_tpu.ops.pallas.mesh_intersect import (mesh_any_hit_pallas,
                                               mesh_closest_hit_pallas)
from rtc_tpu.render.camera import camera_rays as jax_camera_rays
from rtc_tpu.render.renderer import render as jax_render
from rtc_tpu.scene.compile import compile_scene as jax_compile_scene
from rtc_tpu.utils.config import RenderConfig as JaxRenderConfig
from rtc_tpu_torch.models.scenes import REGISTRY
from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
from rtc_tpu_torch.render import integrator
from rtc_tpu_torch.render.renderer import render
from rtc_tpu_torch.scene.compile import TENSOR_FIELDS, SceneStatic, compile_scene
from rtc_tpu_torch.utils.config import RenderConfig
from rtc_tpu_torch.utils.constants import BIG

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_WIDTH = 24  # tests/test_golden.py SPECS for teapot and pumpkin
ELEMENTWISE_WRAPPERS = ("mesh_closest_hit_elementwise",
                        "mesh_any_hit_elementwise")
OTHER_WRAPPERS = ("mesh_closest_hit", "mesh_closest_hit_sn",
                  "mesh_closest_hit_uv", "mesh_any_hit", "mesh_closest_shadow",
                  "mesh_closest_shadow_sn", "mesh_crossing_count",
                  "mesh_closest_hit_tlas", "mesh_closest_hit_tlas_sn",
                  "mesh_any_hit_tlas")


def _compile(world, **kw):
    """The port's compile_scene on the CPU: its default device is the card."""
    return compile_scene(world, device="cpu", **kw)


def jax_rays(cam):
    """rtc_tpu's f32 camera rays as numpy, fed to both packages."""
    dt = jnp.float32
    o, d = jax_camera_rays(jnp.asarray(cam.transform_inverse, dt), cam.hsize,
                           cam.vsize, jnp.asarray(cam.half_width, dt),
                           jnp.asarray(cam.half_height, dt),
                           jnp.asarray(cam.pixel_size, dt), dt)
    return np.array(o), np.array(d)


@pytest.fixture(scope="module")
def teapot32():
    """rtc_tpu's f32 teapot at 32 px, the port's own compile of it, and
    rtc_tpu's camera rays."""
    world, cam = JAX_REGISTRY["teapot"](32)
    js = jax_compile_scene(world, dtype=np.float32)
    scene = _compile(REGISTRY["teapot"](32)[0])
    return js, scene, *jax_rays(cam)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("name", ["teapot", "pumpkin"])
def test_compile_matches_rtc_tpu(name, dtype):
    """teapot (flat) and pumpkin (smooth): every table and static field
    equals rtc_tpu's element for element."""
    np_dt, torch_dt = {"float32": (np.float32, torch.float32),
                       "float64": (np.float64, torch.float64)}[dtype]
    js = jax_compile_scene(JAX_REGISTRY[name](24)[0], dtype=np_dt)
    scene = _compile(REGISTRY[name](24)[0], dtype=torch_dt)
    for field in TENSOR_FIELDS:
        ref, got = np.asarray(getattr(js, field)), getattr(scene, field).numpy()
        assert got.dtype == ref.dtype and np.array_equal(got, ref), field
    for field in SceneStatic._fields:
        assert getattr(scene.static, field) == getattr(js.static, field), field
    st = scene.static
    assert (st.any_smooth, st.n_tris) == {"teapot": (False, 7168),
                                          "pumpkin": (True, 10240)}[name]
    assert st.n_clusters == st.n_super * mi.SUPER_WIDTH


def test_k7a_plain_matches_rtc_tpu_pallas(teapot32):
    """rtc_tpu's gates (test_pallas_matches_bruteforce): equal hit masks,
    t within rtol 1e-5 / atol 1e-6, idx equal on more than 99% of hits."""
    js, scene, o, d = teapot32
    st = js.static
    t_r, i_r = mesh_closest_hit_pallas(
        o, d, js.tri_p1, js.tri_e1, js.tri_e2, js.cluster_aabb, js.super_aabb,
        n_super=st.n_super, leaf=st.cluster_size, interpret=True)
    t_r, i_r = np.asarray(t_r), np.asarray(i_r)
    t, idx = mi.mesh_closest_hit_elementwise(
        torch.from_numpy(o), torch.from_numpy(d), scene.tri_p1, scene.tri_e1,
        scene.tri_e2, scene.cluster_aabb, scene.super_aabb,
        scene.static.cluster_size)
    t, idx = t.numpy(), idx.numpy()
    hit = idx >= 0
    np.testing.assert_array_equal(hit, i_r >= 0)
    assert 100 < hit.sum() < len(hit)
    np.testing.assert_allclose(t[hit], t_r[hit], rtol=1e-5, atol=1e-6)
    assert (t[~hit] == np.float32(BIG)).all()
    assert (idx[hit] == i_r[hit]).mean() > 0.99


def test_k7b_plain_matches_rtc_tpu_pallas(teapot32):
    """tests/test_anyhit.py's query: shadow rays from the primary hit
    points toward the light, max_t their distance; misses are dead lanes.
    Agreement above 0.995 of the hits (self-shadow knife edges only)."""
    js, scene, o, d = teapot32
    st = js.static
    t, idx = mi.closest_hit_plain(torch.from_numpy(o), torch.from_numpy(d),
                                  scene.tri_p1, scene.tri_e1, scene.tri_e2,
                                  scene.tri_n)[:2]
    hit = (idx >= 0).numpy()
    pts = o + d * np.where(hit, t.numpy(), 1.0)[:, None]
    v = np.asarray(js.light_pos, np.float32)[None] - pts
    dist = np.sqrt((v * v).sum(1)).astype(np.float32)
    sd = (v / dist[:, None]).astype(np.float32)
    max_t = np.where(hit, dist, -1.0).astype(np.float32)
    ref = np.asarray(mesh_any_hit_pallas(
        pts, sd, max_t, js.tri_p1, js.tri_e1, js.tri_e2, js.cluster_aabb,
        js.super_aabb, n_super=st.n_super, leaf=st.cluster_size,
        interpret=True))
    got = mi.mesh_any_hit_elementwise(
        torch.from_numpy(pts), torch.from_numpy(sd), torch.from_numpy(max_t),
        scene.tri_p1, scene.tri_e1, scene.tri_e2, scene.cluster_aabb,
        scene.super_aabb, scene.static.cluster_size).numpy()
    assert not got[~hit].any() and not ref[~hit].any()
    assert 10 < got.sum() < hit.sum()
    assert (got == ref)[hit].mean() > 0.995


def _spy_calls(mp, names):
    calls = dict.fromkeys(names, 0)

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    for name in names:
        mp.setattr(mi, name, spy(name, getattr(mi, name)))
    return calls


def _elementwise_render(name, width):
    """render() with the integrator's elementwise branch forced on CPU
    tensors (the wrappers then run their plain versions), the calls of
    every mesh wrapper, and the kernel launches."""
    scene = _compile(REGISTRY[name](width)[0])
    cam = REGISTRY[name](width)[1]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(integrator, "_resolve_mesh_impl",
                   lambda scene, cfg, x: "elementwise")
        calls = _spy_calls(mp, ELEMENTWISE_WRAPPERS + OTHER_WRAPPERS)
        mi.reset_launch_counts()
        img = render(scene, cam, RenderConfig(ray_tile=512)).numpy()
        launches = dict(mi.LAUNCHES)
    return img, calls, launches


def test_elementwise_render_matches_rtc_tpu_pallas():
    """teapot at 28 px (tests/test_anyhit.py): the port's 'elementwise'
    render against rtc_tpu's 'pallas_interpret' render, rtc_tpu's gate
    (diff > 1e-4).mean() < 0.01; one node per tile (the teapot is not
    reflective), each a K7a and a K7b call and nothing else."""
    img, calls, launches = _elementwise_render("teapot", 28)
    world, cam = JAX_REGISTRY["teapot"](28)
    ref = np.asarray(jax_render(
        jax_compile_scene(world, dtype=np.float32), cam,
        JaxRenderConfig(dtype="float32", ray_tile=512,
                        mesh_impl="pallas_interpret")))
    assert img.max() > 0.1
    diff = np.abs(img - ref).max(axis=-1)
    assert (diff > 1e-4).mean() < 0.01
    tiles = -(-28 * 14 // 512)
    want = dict.fromkeys(calls, 0)
    want.update(mesh_closest_hit_elementwise=tiles,
                mesh_any_hit_elementwise=tiles)
    assert calls == want
    assert launches == dict.fromkeys(mi.LAUNCHES, 0)


def test_elementwise_census_takes_k4():
    """glass_teapot under 'elementwise': the census runs K4's wrapper
    (rtc_tpu runs a dense sweep there, which is no Pallas kernel); the
    closest hits and shadows K7a and K7b, three nodes per tile."""
    img, calls, launches = _elementwise_render("glass_teapot", 16)
    assert np.isfinite(img).all() and img.max() > 0.1
    want = dict.fromkeys(calls, 0)
    want.update(mesh_closest_hit_elementwise=3, mesh_any_hit_elementwise=3,
                mesh_crossing_count=1)
    assert calls == want
    assert launches == dict.fromkeys(mi.LAUNCHES, 0)


def test_elementwise_takes_cuda_f32_only(teapot32):
    _, scene, _, _ = teapot32
    cam = REGISTRY["teapot"](16)[1]
    with pytest.raises(ValueError, match="elementwise"):
        render(scene, cam, RenderConfig(mesh_impl="elementwise"))
    assert RenderConfig(mesh_impl="elementwise").mesh_impl == "elementwise"


def test_elementwise_never_takes_the_instanced_or_fused_route():
    """rtc_tpu's choices for 'pallas': the herds sweep their world table
    and no fused kernel runs (rtc_tpu integrator :518, :532)."""
    scene = _compile(REGISTRY["cow_herd"](16)[0])
    cfg = RenderConfig(mesh_impl="elementwise")
    assert scene.static.tlas_n_inst
    assert not integrator._use_tlas(scene, cfg, "elementwise")
    assert not integrator._use_fused_shadow(scene, cfg, "elementwise")
    assert integrator._use_tlas(scene, cfg, "kernel")


@pytest.mark.parametrize("name", ["teapot", "pumpkin"])
def test_render_f64_matches_golden_and_rtc_tpu(name):
    """The f64 render (the dense sweep) at the golden width equals
    tests/golden/<name>.npy and rtc_tpu's f64 render at 1e-9."""
    golden = np.load(os.path.join(GOLDEN, f"{name}.npy"))
    world, cam = REGISTRY[name](GOLDEN_WIDTH)
    img = render(_compile(world, dtype=torch.float64), cam,
                 RenderConfig(dtype="float64", ray_tile=512)).numpy()
    np.testing.assert_allclose(img, golden, atol=1e-9, rtol=0)
    jax_world, jax_cam = JAX_REGISTRY[name](GOLDEN_WIDTH)
    ref = np.asarray(jax_render(jax_compile_scene(jax_world, dtype=np.float64),
                                jax_cam, JaxRenderConfig(dtype="float64",
                                                         ray_tile=512)))
    np.testing.assert_allclose(img, ref, atol=1e-9, rtol=0)
