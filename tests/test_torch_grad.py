"""rtc_tpu_torch.diff against rtc_tpu.diff on the CPU, in f64 on the plain
(bruteforce) path: the gradients of tests/test_grad.py and the recoveries
of tests/test_inverse_rendering.py, run through the port, held to
rtc_tpu's gradients, to central finite differences, and to optax's Adam
trajectory; and the parameter checkpoints, whose .npz rtc_tpu reads.

glass_spheres and default_world are compiled by rtc_tpu and carried
across with scene_from_numpy, their parameters with params_from_numpy, so
both packages start from the same tables (tests/test_torch_scenes.py holds
the port's own compile of them equal to rtc_tpu's).
"""

import math

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from rtc_tpu.diff import checkpoint as jax_ckpt
from rtc_tpu.diff import render_grad as JRG
from rtc_tpu.models.scenes import REGISTRY as JAX_REGISTRY
from rtc_tpu.render.camera import camera_rays as jax_camera_rays
from rtc_tpu.scene.compile import compile_scene as jax_compile_scene
from rtc_tpu.scene.world import default_world as jax_default_world
from rtc_tpu.utils.config import RenderConfig as JaxRenderConfig
from rtc_tpu_torch.diff import checkpoint as ckpt
from rtc_tpu_torch.diff import render_grad as RG
from rtc_tpu_torch.ops import transforms as X
from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
from rtc_tpu_torch.ops.vec import affine3
from rtc_tpu_torch.render import integrator
from rtc_tpu_torch.render.camera import Camera, camera_rays
from rtc_tpu_torch.scene import shapes as S
from rtc_tpu_torch.scene.compile import (TENSOR_FIELDS, compile_scene,
                                         params_from_numpy, scene_from_numpy)
from rtc_tpu_torch.scene.materials import Material, gradient_pattern
from rtc_tpu_torch.scene.world import PointLight, World
from rtc_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(2)

CFG = RenderConfig(dtype="float64")
JAX_CFG = JaxRenderConfig(dtype="float64")
ALL_PARAMS = RG.DEFAULT_PARAMS + RG.TRANSFORM_PARAMS


def _carry(js):
    """The port's scene on the CPU from rtc_tpu's compiled tables."""
    arrays = {f: np.asarray(getattr(js, f)) for f in TENSOR_FIELDS}
    return scene_from_numpy(arrays, js.static._asdict(), device="cpu")


def _numpy(params):
    return {k: np.asarray(v) for k, v in params.items()}


@pytest.fixture(scope="module")
def setup():
    """tests/test_grad.py's setup in both packages: glass_spheres at 16x8
    in f64, its camera rays, a flat 0.25 target, and the parameters of
    DEFAULT_PARAMS + TRANSFORM_PARAMS."""
    world, cam = JAX_REGISTRY["glass_spheres"](16)
    js = jax_compile_scene(world, dtype=np.float64)
    o, d = jax_camera_rays(jnp.asarray(cam.transform_inverse, jnp.float64),
                           cam.hsize, cam.vsize, cam.half_width, cam.half_height,
                           cam.pixel_size, dtype=jnp.float64)
    target = jnp.zeros_like(o) + 0.25
    jparams = JRG.extract_params(js, ALL_PARAMS)
    t = lambda a: torch.from_numpy(np.array(a))
    return dict(js=js, jax=(o, d, target), jparams=jparams, scene=_carry(js),
                rays=(t(o), t(d), t(target)),
                params=params_from_numpy(_numpy(jparams), "cpu"))


def test_loss_and_grad_match_rtc_tpu(setup):
    jloss, jgrads = JRG.loss_and_grad(setup["jparams"], setup["js"], *setup["jax"],
                                      JAX_CFG)
    loss, grads = RG.loss_and_grad(setup["params"], setup["scene"], *setup["rays"], CFG)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-12)
    assert set(grads) == set(ALL_PARAMS)
    for k in ALL_PARAMS:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jgrads[k]),
                                   rtol=1e-6, atol=1e-10, err_msg=k)
    assert float(grads["prim_inv"].abs().sum()) > 0


@pytest.mark.parametrize(
    "name,index",
    [
        ("mat_color", (0, 1)),
        ("mat_ambient", (0,)),
        ("mat_diffuse", (0,)),
        ("mat_reflective", (1,)),
        ("mat_transparency", (1,)),
        ("mat_ior", (1,)),
        ("light_pos", (1,)),
        ("light_intensity", (2,)),
        ("pat_a", (0, 0)),
    ],
)
def test_grad_matches_finite_diff(setup, name, index):
    params = {k: setup["params"][k] for k in RG.DEFAULT_PARAMS}
    ad, fd = RG.finite_diff_check(params, setup["scene"], *setup["rays"], CFG,
                                  name, index)
    assert np.isfinite(ad) and np.isfinite(fd)
    np.testing.assert_allclose(ad, fd, rtol=2e-3, atol=1e-7)


def test_transform_grads_flow(setup):
    ad, fd = RG.finite_diff_check(setup["params"], setup["scene"], *setup["rays"],
                                  CFG, "prim_inv", (1, 0, 3))
    assert np.isfinite(ad) and abs(ad) > 0
    np.testing.assert_allclose(ad, fd, rtol=5e-3, atol=1e-7)


def test_grads_are_nan_free_everywhere(setup):
    _, grads = RG.loss_and_grad(setup["params"], setup["scene"], *setup["rays"], CFG)
    for k, g in grads.items():
        assert bool(torch.isfinite(g).all()), f"non-finite grad in {k}"


def test_adam_trajectory_matches_optax(setup):
    """Ten Adam steps at lr 5e-2 from the same values: torch.optim.Adam with
    its defaults takes optax.adam's steps."""
    jparams = {k: setup["jparams"][k] for k in RG.DEFAULT_PARAMS}
    tx = optax.adam(5e-2)
    jstep = JRG.make_train_step(tx, JAX_CFG)
    state = tx.init(jparams)
    jlosses = []
    for _ in range(10):
        jparams, state, loss = jstep(jparams, state, setup["js"], *setup["jax"])
        jlosses.append(float(loss))

    params = params_from_numpy(_numpy({k: setup["jparams"][k]
                                       for k in RG.DEFAULT_PARAMS}), "cpu")
    step = RG.make_train_step(torch.optim.Adam(params.values(), lr=5e-2), CFG)
    losses = [float(step(params, setup["scene"], *setup["rays"])) for _ in range(10)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-6)
    assert losses[-1] < losses[0]
    for k in params:
        np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(jparams[k]),
                                   rtol=1e-5, atol=1e-8, err_msg=k)


# --- affine3: the per-ray affines of normal_at and the pattern lookup ------

AFFINE_FORMS = ("3x3", "3x4", "3x4 linear part")


def _affine_case(dtype, form, rays=37):
    """Per-ray matrices of the form (a 3x4 one's linear part is a strided
    view) and (R, 3) vectors."""
    g = torch.Generator().manual_seed(7)
    m = torch.randn((rays, 3, 4), generator=g, dtype=torch.float64).to(dtype)
    v = torch.randn((rays, 3), generator=g, dtype=torch.float64).to(dtype)
    if form == "3x3":
        m = m[:, :, :3].contiguous()
    elif form == "3x4 linear part":
        m = m[:, :, :3]
    return m, v


@pytest.mark.parametrize("form", AFFINE_FORMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_affine3_matches_einsum(dtype, form):
    m, v = _affine_case(dtype, form)
    want = torch.einsum("rij,rj->ri", m[:, :, :3], v)
    if m.shape[-1] == 4:
        want = want + m[:, :, 3]
    got = affine3(m, *v.unbind(1))
    assert got.shape == want.shape and got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-12 if dtype == torch.float64 else 1e-5)


@pytest.mark.parametrize("form", AFFINE_FORMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_affine3_rounds_as_instance_rays(dtype, form):
    """Bit for bit the sums of mi.instance_rays: its origin o' = A o + b
    with a translation, its direction d' = A d without."""
    m, v = _affine_case(dtype, form)
    b = m[:, :, 3] if m.shape[-1] == 4 else torch.zeros_like(v)
    o2, d2 = mi.instance_rays(v, v, torch.cat([m[:, :, :3].reshape(-1, 9), b], 1))
    assert torch.equal(affine3(m, *v.unbind(1)), o2 if m.shape[-1] == 4 else d2)


@pytest.mark.parametrize("form", AFFINE_FORMS)
def test_affine3_gradcheck(form):
    m, v = _affine_case(torch.float64, form, rays=5)
    leaf = (m[:, :, :3] if form == "3x3" else m).detach().requires_grad_()
    view = (lambda a: a[:, :, :3]) if form == "3x4 linear part" else (lambda a: a)
    v = v.detach().requires_grad_()
    assert torch.autograd.gradcheck(lambda a, x: affine3(view(a), *x.unbind(1)),
                                    (leaf, v))


@pytest.fixture(scope="module")
def affine_scene():
    """Two transformed spheres over a plane, each with a rotated, scaled
    gradient pattern (a color that moves with the hit point, unlike
    checkers), at 16x8 in f64: prim_inv reaches the normal's products
    (the point's and the inverse-transpose's) and the pattern's point."""
    def grad_pattern(a, b, m):
        return gradient_pattern(a, b).set_transform(m)

    floor = S.plane(material=Material(
        pattern=grad_pattern((0.9, 0.2, 0.1), (0.1, 0.3, 0.9),
                             X.rotation_y(0.4) @ X.scaling(0.7, 1.0, 0.7)),
        reflective=0.3))
    ball = S.sphere(transform=X.translation(-0.6, 1.0, 0.3) @ X.rotation_z(0.3)
                    @ X.scaling(1.0, 1.4, 0.8),
                    material=Material(pattern=grad_pattern(
                        (0.2, 0.8, 0.3), (0.7, 0.1, 0.6),
                        X.rotation_x(0.5) @ X.scaling(0.4, 0.4, 0.4)),
                        diffuse=0.8, specular=0.4))
    glass = S.sphere(transform=X.translation(0.9, 0.7, -0.8) @ X.scaling(0.6, 0.7, 0.6),
                     material=Material(color=(0.1, 0.1, 0.1), transparency=0.9,
                                       refractive_index=1.5, reflective=0.5))
    world = World(objects=[floor, ball, glass], light=PointLight((-10, 10, -10), (1, 1, 1)))
    scene = compile_scene(world, dtype=torch.float64, device="cpu")
    cam = Camera(16, 8, math.pi / 3)
    cam.set_transform(X.view_transform([0, 1.5, -5], [0, 1, 0], [0, 1, 0]))
    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize, cam.half_width,
                       cam.half_height, cam.pixel_size, torch.float64)
    return scene, o, d, torch.zeros_like(o) + 0.25


@pytest.mark.parametrize(
    "name,index",
    [
        ("prim_inv", (0, 1, 3)),   # the plane's height: the pattern's point
        ("prim_inv", (1, 0, 0)),   # the ball's linear part: its normals
        ("prim_inv", (1, 1, 2)),
        ("prim_inv", (1, 2, 3)),
        ("prim_inv", (2, 1, 1)),   # the glass ball, seen through refraction
        ("pat_a", (0, 0)),
        ("pat_b", (1, 2)),
    ],
)
def test_prim_and_pattern_grads_match_finite_diff(affine_scene, name, index):
    scene, o, d, target = affine_scene
    params = RG.extract_params(scene, ALL_PARAMS)
    ad, fd = RG.finite_diff_check(params, scene, o, d, target, CFG, name, index)
    assert np.isfinite(ad) and abs(ad) > 1e-6
    np.testing.assert_allclose(ad, fd, rtol=2e-3, atol=1e-7)


# --- camera-pose gradients ----------------------------------------------------

POSE = ([0.0, 1.5, -5.0], [0.0, 1.0, 0.0], [0.0, 1.0, 0.0], math.pi / 3)
TARGET_POSE = ([0.1, 1.4, -5.0], [0.0, 1.0, 0.0], [0.0, 1.0, 0.0], math.pi / 3 + 0.05)


@pytest.fixture(scope="module")
def world_scenes():
    js = jax_compile_scene(jax_default_world(), dtype=jnp.float64)
    return js, _carry(js)


def _pose_target(scene, pose, hsize=8, vsize=8):
    o, d = RG.camera_pose_rays(RG.camera_params(*pose, device="cpu"), hsize, vsize,
                               torch.float64)
    with torch.no_grad():
        return integrator.color_at(scene, o, d, CFG)


def test_camera_pose_rays_match_rtc_tpu():
    o, d = RG.camera_pose_rays(RG.camera_params(*POSE, device="cpu"), 6, 4,
                               torch.float64)
    jo, jd = JRG.camera_pose_rays(JRG.camera_params(*POSE), 6, 4, jnp.float64)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=0, atol=1e-13)
    np.testing.assert_allclose(d.detach().numpy(), np.asarray(jd), rtol=0, atol=1e-13)


def test_camera_pose_gradients_match_rtc_tpu_and_finite_diff(world_scenes):
    """tests/test_grad.py's camera-pose check through the port, and the
    gradients equal to rtc_tpu's."""
    js, scene = world_scenes
    target = _pose_target(scene, TARGET_POSE)
    cam = RG.camera_params(*POSE, device="cpu")
    loss = lambda c: RG.camera_render_loss(c, scene, target, CFG, 8, 8)
    grads = dict(zip(cam, torch.autograd.grad(loss(cam), list(cam.values()))))

    jtarget = jnp.asarray(target.numpy())
    jgrads = jax.grad(lambda c: JRG.camera_render_loss(c, js, jtarget, JAX_CFG, 8, 8))(
        JRG.camera_params(*POSE))
    for k in RG.CAMERA_PARAMS:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jgrads[k]),
                                   rtol=1e-6, atol=1e-10, err_msg=k)

    eps = 1e-6
    for name, index in (("cam_from", (0,)), ("cam_from", (2,)),
                        ("cam_to", (1,)), ("cam_fov", ())):
        @torch.no_grad()
        def loss_at(v):
            c = dict(cam)
            c[name] = cam[name].detach().clone()
            c[name][index] = v
            return float(loss(c))

        v0 = float(cam[name].detach()[index])
        fd = (loss_at(v0 + eps) - loss_at(v0 - eps)) / (2 * eps)
        ad = float(grads[name][index])
        assert abs(ad - fd) < 1e-4 * max(1.0, abs(fd)), (
            f"{name}[{index}]: autodiff {ad} vs finite-diff {fd}")
        assert abs(ad) > 1e-12, f"{name}[{index}] gradient is dead"


def test_camera_pose_recovery_step(world_scenes):
    """A few SGD steps on the camera pose reduce the pose-mismatch loss."""
    _, scene = world_scenes
    target = _pose_target(scene, POSE)
    cam = RG.camera_params([0.15, 1.45, -5.0], *POSE[1:], device="cpu")
    loss = lambda c: RG.camera_render_loss(c, scene, target, CFG, 8, 8)
    l0 = float(loss(cam))
    opt = torch.optim.SGD(cam.values(), lr=1.0)
    for _ in range(60):
        opt.zero_grad()
        loss(cam).backward()
        opt.step()
    l1 = float(loss(cam))
    assert l1 < 0.5 * l0, (l0, l1)


# --- inverse rendering (tests/test_inverse_rendering.py) -------------------------

def _sphere_setup(color=(0.2, 0.8, 0.3), tx=0.0):
    s = S.sphere(transform=X.translation(tx, 0, 0), material=Material(color=color))
    world = World(objects=[s], light=PointLight((-10, 10, -10), (1, 1, 1)))
    scene = compile_scene(world, dtype=torch.float64, device="cpu")
    cam = Camera(24, 24, np.pi / 3)
    cam.set_transform(X.view_transform([0, 0, -4], [0, 0, 0], [0, 1, 0]))
    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize, cam.half_width,
                       cam.half_height, cam.pixel_size, torch.float64)
    return scene, o, d


def test_recover_material_color():
    target_scene, o, d = _sphere_setup(color=(0.9, 0.1, 0.2))
    with torch.no_grad():
        target = integrator.color_at(target_scene, o, d, CFG)
    scene, _, _ = _sphere_setup(color=(0.5, 0.5, 0.5))
    params = RG.extract_params(scene, names=("mat_color",))
    step = RG.make_train_step(torch.optim.Adam(params.values(), lr=0.1), CFG)
    for _ in range(60):
        step(params, scene, o, d, target)
    np.testing.assert_allclose(params["mat_color"].detach().numpy()[0],
                               [0.9, 0.1, 0.2], atol=0.02)
    assert torch.equal(scene.mat_color, torch.full((1, 3), 0.5, dtype=torch.float64))


def test_recover_object_translation():
    target_scene, o, d = _sphere_setup(tx=0.15)
    with torch.no_grad():
        target = integrator.color_at(target_scene, o, d, CFG)
    scene, _, _ = _sphere_setup(tx=0.0)
    params = RG.extract_params(scene, names=("prim_inv",))
    step = RG.make_train_step(torch.optim.Adam(params.values(), lr=0.01), CFG)
    losses = [float(step(params, scene, o, d, target)) for _ in range(80)]
    with torch.no_grad():
        loss = float(RG.render_loss(params, scene, o, d, target, CFG))
    assert loss < 0.35 * losses[0]
    inv = params["prim_inv"].detach().numpy()[0]
    assert -0.2 < inv[0, 3] < -0.09


def test_param_checkpoint_roundtrip(setup, tmp_path):
    """save/restore keep every table bit for bit, and rtc_tpu's restore
    reads the port's .npz."""
    params = setup["params"]
    path = ckpt.save(str(tmp_path / "params"), params, step=3)
    assert path.endswith(".npz") and int(np.load(path)["__step__"]) == 3
    for restored in (ckpt.restore(str(tmp_path / "params"), device="cpu"),
                     jax_ckpt.restore(path)):
        assert set(restored) == set(params)
        for k in params:
            np.testing.assert_array_equal(np.asarray(restored[k].detach()
                                                     if isinstance(restored[k], torch.Tensor)
                                                     else restored[k]),
                                          params[k].detach().numpy())
