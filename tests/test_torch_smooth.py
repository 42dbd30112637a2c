"""Smooth meshes in rtc_tpu_torch against rtc_tpu: the plain versions of K1
and K3 `with_sn` against rtc_tpu's Pallas kernels (interpret mode on the
CPU) on identical tables and rays, the smooth-normal semantics of
closest_hit, and the smooth scenes rendered through render() against
rtc_tpu's renders and tests/golden. The CUDA kernels themselves are held
against these plain versions on the GPU (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rtc_tpu.models.scenes import REGISTRY as JAX_REGISTRY
from rtc_tpu.ops.pallas.mesh_intersect import (mesh_closest_hit_mxu,
                                               mesh_closest_shadow_mxu)
from rtc_tpu.render.camera import camera_rays as jax_camera_rays
from rtc_tpu.render.renderer import render as jax_render
from rtc_tpu.scene.compile import compile_scene as jax_compile_scene
from rtc_tpu.utils.config import RenderConfig as JaxRenderConfig
from rtc_tpu_torch.models.scenes import REGISTRY
from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
from rtc_tpu_torch.render import integrator
from rtc_tpu_torch.render.camera import camera_rays
from rtc_tpu_torch.render.renderer import render
from rtc_tpu_torch.scene import shapes
from rtc_tpu_torch.scene.compile import (TENSOR_FIELDS, compile_scene,
                                         scene_from_numpy)
from rtc_tpu_torch.scene.world import World
from rtc_tpu_torch.utils.config import RenderConfig
from rtc_tpu_torch.utils.constants import BIG

torch.set_num_threads(2)


def _compile(world, **kw):
    """The port's compile_scene on the CPU: its default device is the card."""
    return compile_scene(world, device="cpu", **kw)


GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
# tests/test_golden.py: golden widths and F32_BUDGET (min exact-match
# fraction after 8-bit quantization, structural flips)
SMOOTH_SCENES = {"teapot_smooth": (24, (0.99, 2)), "teddy": (24, (0.98, 2))}


def _quantize(img):
    return np.clip(np.asarray(img, np.float64) * 255.0 + 0.5, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def teapot():
    """rtc_tpu's f32 teapot_smooth tables and 512 width-32 camera rays, as
    numpy; the port's scene from the same tables; the (T, 9) corner
    normals."""
    world, cam = JAX_REGISTRY["teapot_smooth"](32)
    js = jax_compile_scene(world, dtype=np.float32)
    dt = jnp.float32
    o, d = jax_camera_rays(jnp.asarray(cam.transform_inverse, dt), cam.hsize,
                           cam.vsize, jnp.asarray(cam.half_width, dt),
                           jnp.asarray(cam.half_height, dt),
                           jnp.asarray(cam.pixel_size, dt), dt)
    arrays = {f: np.asarray(getattr(js, f)) for f in TENSOR_FIELDS}
    scene = scene_from_numpy(arrays, js.static._asdict(), device="cpu")
    snc = np.concatenate([arrays["tri_sn1"], arrays["tri_sn2"],
                          arrays["tri_sn3"]], axis=1)
    return js, scene, np.asarray(o), np.asarray(d), snc


def _tables(scene):
    return scene.tri_p1, scene.tri_e1, scene.tri_e2


def _assert_closest_parity(t, idx, n, jt, jidx, jn, o, d, snc, scene):
    """tests/test_torch_mesh_kernels.py's gate: equal hit masks; t within
    rtol 1e-5 / atol 1e-6; idx equal on >= 99% of hits, mismatches only at
    ties. The blend n is held within 1e-4 of rtc_tpu's where idx agrees,
    and of an f64 recompute of the blend at the same winner: (u, v) in f32
    lose digits on the teapot's small triangles seen from 12 units away.
    Measured on these rays against the f64 blend: the port's direct
    Möller-Trumbore 1.95e-5, rtc_tpu's Plücker matmul 3.9e-6; port against
    rtc_tpu 2.0e-5. So 1e-6 cannot hold for n here."""
    t, idx, n = t.numpy(), idx.numpy(), n.numpy()
    jt, jidx, jn = map(np.asarray, (jt, jidx, jn))
    hit, jhit = idx >= 0, jidx >= 0
    np.testing.assert_array_equal(hit, jhit)
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-5, atol=1e-6)
    same = idx == jidx
    assert same[hit].mean() >= 0.99
    assert (np.abs(t - jt)[hit & ~same] <= 1e-6).all()
    np.testing.assert_allclose(n[same & hit], jn[same & hit], rtol=0, atol=1e-4)
    assert (n[~hit] == 0).all() and (t[~hit] == np.float32(BIG)).all()
    f64 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    n64 = mi.smooth_blend(f64(o), f64(d), *(f64(x) for x in _tables(scene)),
                          f64(snc), torch.from_numpy(idx)).numpy()
    np.testing.assert_allclose(n[hit], n64[hit], rtol=0, atol=1e-4)
    return hit


def test_k1_sn_plain_matches_rtc_tpu(teapot):
    js, scene, o, d, snc = teapot
    t, idx, n = mi.closest_hit_sn_plain(torch.from_numpy(o), torch.from_numpy(d),
                                        *_tables(scene), torch.from_numpy(snc))
    jt, jidx, jn = mesh_closest_hit_mxu(
        o, d, js.tri_p1, js.tri_e1, js.tri_e2, js.cluster_aabb, js.super_aabb,
        n_super=js.static.n_super, leaf=js.static.cluster_size,
        interpret=True, tri_sn=snc)
    hit = _assert_closest_parity(t, idx, n, jt, jidx, jn, o, d, snc, scene)
    assert hit.sum() > 50
    # the blend is unnormalized: its length is below 1 inside a triangle
    assert (torch.linalg.norm(n[torch.from_numpy(hit)], dim=1) < 1.0 + 1e-6).all()


def test_k3_sn_plain_matches_rtc_tpu(teapot):
    js, scene, o, d, snc = teapot
    t, idx, n, sh = mi.closest_shadow_sn_plain(
        torch.from_numpy(o), torch.from_numpy(d), *_tables(scene),
        torch.from_numpy(snc), scene.light_pos)
    jt, jidx, jn, jsh = mesh_closest_shadow_mxu(
        o, d, js.tri_p1, js.tri_e1, js.tri_e2, js.tri_n, js.cluster_aabb,
        js.light_pos, leaf=js.static.cluster_size, interpret=True, tri_sn=snc)
    hit = _assert_closest_parity(t, idx, n, jt, jidx, jn, o, d, snc, scene)
    sh = sh.numpy()
    assert sh.sum() >= 2 and not sh[~hit].any()  # the teapot shades itself
    assert int((sh != np.asarray(jsh)).sum()) <= max(2, hit.sum() // 1000)


def test_sn_wrappers_take_plain_versions_on_cpu(teapot):
    _, scene, o, d, snc = teapot
    o, d, snc = torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(snc)
    leaf = scene.static.cluster_size
    mi.reset_launch_counts()
    got = mi.mesh_closest_hit_sn(o, d, *_tables(scene), snc,
                                 scene.cluster_aabb, leaf)
    ref = mi.closest_hit_sn_plain(o, d, *_tables(scene), snc)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    got = mi.mesh_closest_shadow_sn(o, d, *_tables(scene), snc,
                                    scene.cluster_aabb, scene.light_pos, leaf)
    ref = mi.closest_shadow_sn_plain(o, d, *_tables(scene), snc, scene.light_pos)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert set(mi.LAUNCHES.values()) == {0}


def _smooth_triangle_world(extra=()):
    """The book's smooth triangle: p (0,1,0), (-1,0,0), (1,0,0) with
    normals (0,1,0), (-1,0,0), (1,0,0)."""
    tri = shapes.mesh([[0, 1, 0]], [[-1, 0, 0]], [[1, 0, 0]],
                      vn1=[[0, 1, 0]], vn2=[[-1, 0, 0]], vn3=[[1, 0, 0]])
    return World(objects=[tri, *extra])


def test_smooth_normal_interpolates_with_uv():
    """The book's smooth-triangle normal at u = 0.45, v = 0.25
    (tests/test_smooth.py), through closest_hit in f64."""
    scene = _compile(_smooth_triangle_world(), dtype=torch.float64)
    assert scene.static.any_smooth
    u, v = 0.45, 0.25
    o = torch.tensor([[-u + v, 1 - u - v, -2.0]], dtype=torch.float64)
    d = torch.tensor([[0.0, 0.0, 1.0]], dtype=torch.float64)
    hit = integrator.closest_hit(scene, o, d, RenderConfig(dtype="float64"))
    assert bool(hit.valid[0])
    expected = np.array([-u + v, 1 - u - v, 0.0])
    np.testing.assert_allclose(hit.tri_n[0].numpy(),
                               expected / np.linalg.norm(expected), atol=1e-9)


def test_flat_mesh_in_smooth_scene_keeps_face_normal():
    flat = shapes.mesh([[0, 1, 5]], [[-1, 0, 5]], [[1, 0, 5]])
    scene = _compile(_smooth_triangle_world([flat]), dtype=torch.float64)
    o = torch.tensor([[0.0, 0.5, 2.0]], dtype=torch.float64)
    d = torch.tensor([[0.0, 0.0, 1.0]], dtype=torch.float64)
    hit = integrator.closest_hit(scene, o, d, RenderConfig(dtype="float64"))
    assert int(hit.obj[0]) == 1
    np.testing.assert_allclose(hit.tri_n[0].abs().numpy(), [0, 0, 1], atol=1e-12)


def test_fused_sn_branch_equals_split_branch(monkeypatch):
    """color_at's fused branch (one K3 with_sn call per node) against its
    split branch (K1 with_sn, then K2). On the CPU the wrappers run their
    plain versions, which normalize the blend with the same operations, so
    the two branches agree bit for bit."""
    world, cam = REGISTRY["teapot_smooth"](48)
    scene = _compile(world, dtype=torch.float32)
    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize,
                       cam.half_width, cam.half_height, cam.pixel_size)
    monkeypatch.setattr(integrator, "mesh_impl_for", lambda *a: "kernel")
    fused = integrator.color_at(scene, o, d, RenderConfig())
    split = integrator.color_at(scene, o, d, RenderConfig(fused_shadow=False))
    assert torch.equal(fused, split)
    assert float(fused.amax()) > 0.1


@pytest.mark.parametrize("name", sorted(SMOOTH_SCENES))
def test_render_f64_matches_golden_and_rtc_tpu(name):
    width, _ = SMOOTH_SCENES[name]
    golden = np.load(os.path.join(GOLDEN, f"{name}.npy"))
    world, cam = REGISTRY[name](width)
    img = render(_compile(world, dtype=torch.float64), cam,
                 RenderConfig(dtype="float64", ray_tile=512)).numpy()
    np.testing.assert_allclose(img, golden, atol=1e-9, rtol=0)
    jax_world, jax_cam = JAX_REGISTRY[name](width)
    ref = np.asarray(jax_render(jax_compile_scene(jax_world, dtype=np.float64),
                                jax_cam, JaxRenderConfig(dtype="float64",
                                                         ray_tile=512)))
    np.testing.assert_allclose(img, ref, atol=1e-9, rtol=0)


@pytest.mark.parametrize("name", sorted(SMOOTH_SCENES))
def test_render_f32_matches_f64_golden(name):
    width, (min_frac, flip_budget) = SMOOTH_SCENES[name]
    golden = np.load(os.path.join(GOLDEN, f"{name}.npy"))
    world, cam = REGISTRY[name](width)
    img = render(_compile(world, dtype=torch.float32), cam,
                 RenderConfig(ray_tile=512)).numpy()
    match_frac = float(np.all(_quantize(golden) == _quantize(img), axis=2).mean())
    flips = int((np.abs(golden - img).max(axis=2) > 0.15).sum())
    assert match_frac >= min_frac and flips <= flip_budget, (match_frac, flips)
