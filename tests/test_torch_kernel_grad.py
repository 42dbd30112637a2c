"""The closest-hit autograd Functions of rtc_tpu_torch.render.integrator
against rtc_tpu's custom JVPs, on the CPU.

Each Function runs here in f32 with its kernel wrapper on CPU tensors as
the search, which is the kernel's plain version. Its gradients with
respect to every differentiable input are held, at rtc_tpu's tolerances
(rtol 1e-3, atol 1e-5, tests/test_pallas_mesh.py:109-110), to jax.grad
through the matching custom JVP in interpret mode (as
tests/test_pallas_mesh.py and tests/test_tlas.py run them) and to
autograd through the port's dense plain sweep, on the same numpy inputs
and on the rays whose winner all three agree on. The loss is sum(t on
hits) + sum(n * w) for a fixed random w (uv * w for K1 with_uv).

Both references run on the same f32 values in f64. The Function's
backward evaluates the winner's closed form in f64 (render/integrator.py);
an f32 evaluation of these partials scatters by more than 1e-3 on some
grazing hits, whatever the order: rtc_tpu's own JVP and its transpose
differ so on the teapot's central rays. The kernels themselves run the
same comparisons on the card (tests/test_torch_cuda.py, chip_smoke.py).

Also: inject_params of triangle rows rebuilds the boxes and occlusion
tables the kernels read (or refuses, on an instanced scene), and the f64
gradients of the cow through color_at equal rtc_tpu's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from rtc_tpu.diff import render_grad as JRG
from rtc_tpu.models.scenes import REGISTRY as JAX_REGISTRY
from rtc_tpu.models.scenes import _cam as jax_cam
from rtc_tpu.models.scenes import cow_herd_world as jax_cow_herd_world
from rtc_tpu.render import integrator as jint
from rtc_tpu.render.camera import camera_rays as jax_camera_rays
from rtc_tpu.scene.compile import compile_scene as jax_compile_scene
from rtc_tpu.utils.config import RenderConfig as JaxRenderConfig
from rtc_tpu_torch.diff import render_grad as RG
from rtc_tpu_torch.models.scenes import REGISTRY, cow_herd_world
from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
from rtc_tpu_torch.render import integrator
from rtc_tpu_torch.scene.compile import (TENSOR_FIELDS, compile_scene,
                                         occlusion_tables, params_from_numpy,
                                         scene_from_numpy)
from rtc_tpu_torch.utils.config import RenderConfig
from rtc_tpu_torch.utils.constants import EPSILON

torch.set_num_threads(2)

RAYS = 64
TOL = dict(rtol=1e-3, atol=1e-5)


def _jax_rays(cam, dt=jnp.float32):
    o, d = jax_camera_rays(jnp.asarray(cam.transform_inverse, dt), cam.hsize,
                           cam.vsize, jnp.asarray(cam.half_width, dt),
                           jnp.asarray(cam.half_height, dt),
                           jnp.asarray(cam.pixel_size, dt), dt)
    mid = o.shape[0] // 2  # central rays hit the model
    return np.array(o[mid:mid + RAYS]), np.array(d[mid:mid + RAYS])


def _carry(js):
    arrays = {f: np.array(getattr(js, f)) for f in TENSOR_FIELDS}
    if js.static.tlas_n_inst:
        arrays["tlas"] = {k: np.array(v) for k, v in js.tlas._asdict().items()}
    return scene_from_numpy(arrays, js.static._asdict(), device="cpu")


@pytest.fixture(scope="module")
def scenes():
    """rtc_tpu's f32 scenes (teapot and teapot_smooth at 32x16, the 3x3
    herd flat and smooth, tests/test_tlas.py's camera at 64x32), the
    port's scenes carried from their tables, and RAYS central rays."""
    out = {}
    for name in ("teapot", "teapot_smooth"):
        world, cam = JAX_REGISTRY[name](32)
        js = jax_compile_scene(world, dtype=np.float32)
        out[name] = (js, _carry(js), *_jax_rays(cam))
    cam = jax_cam(64, [0, 10, -18], [0, 3, 2])
    for name, smooth in (("herd", False), ("herd_smooth", True)):
        js = jax_compile_scene(jax_cow_herd_world(3, 3, smooth), dtype=np.float32)
        out[name] = (js, _carry(js), *_jax_rays(cam))
    return out


def _snc(s):
    """The (T, 9) corner table of a scene of either package."""
    cat = jnp.concatenate if isinstance(s.tri_sn1, jax.Array) else torch.cat
    return cat([s.tri_sn1, s.tri_sn2, s.tri_sn3], 1)


def _spec(impl, js, R):
    st = js.static
    return (impl, st.n_super, st.cluster_size, min(512, max(128, R)), EPSILON)


def _tlas_spec(js):
    st = js.static
    return ("mxu_interpret", st.cluster_size, st.tlas_cm, jint.TLAS_RAY_TILE, EPSILON)


# Each case: (scene, Function, port search(scene) -> callable of the
# differentiable inputs, port inputs(scene), jax function(js, R) -> callable
# of the differentiable inputs, jax inputs(js), position of the vector output
# (n or uv) or None). A K5 Function also takes (tm, inst_mesh) first.

def _flat(s):
    return (s.tri_p1, s.tri_e1, s.tri_e2)


def _leaf(s):
    return s.static.cluster_size


def _blocks16(s):
    """The superblocks of 16 clusters of s's table (a streamed search)."""
    return mi._blocked(s.tri_p1, _leaf(s), 16 * _leaf(s))


CASES = {
    "K7a": ("teapot", integrator.KernelClosest,
            lambda s: lambda *x: mi.mesh_closest_hit_elementwise(
                *x, s.cluster_aabb, s.super_aabb, _leaf(s), EPSILON),
            _flat,
            lambda js, R: lambda *x: jint._kernel_closest(
                _spec("pallas_interpret", js, R), *x, js.cluster_aabb, js.super_aabb),
            _flat, None),
    "K1 with_n": ("teapot", integrator.KernelClosestN,
                  lambda s: lambda *x: mi.mesh_closest_hit(
                      *x, s.cluster_aabb, _leaf(s), EPSILON),
                  lambda s: (*_flat(s), s.tri_n),
                  lambda js, R: lambda *x: jint._kernel_closest_n(
                      _spec("mxu_interpret", js, R), *x, js.cluster_aabb, js.super_aabb),
                  lambda js: (*_flat(js), js.tri_n), 2),
    "K1 with_n streamed": ("teapot", integrator.KernelClosestN,
                           lambda s: lambda o, d, p1, e1, e2, n: mi.closest_hit_blocked(
                               o, d, p1, e1, e2, s.cluster_aabb, _blocks16(s), _leaf(s),
                               EPSILON, tri_n=n),
                           lambda s: (*_flat(s), s.tri_n),
                           lambda js, R: lambda *x: jint._kernel_closest_n(
                               _spec("mxu_interpret", js, R), *x, js.cluster_aabb,
                               js.super_aabb),
                           lambda js: (*_flat(js), js.tri_n), 2),
    "K1 with_uv streamed": ("teapot_smooth", integrator.KernelClosestUv,
                            lambda s: lambda *x: mi.closest_hit_blocked(
                                *x, s.cluster_aabb, _blocks16(s), _leaf(s), EPSILON,
                                want_uv=True),
                            _flat,
                            lambda js, R: lambda *x: jint._kernel_closest_uv(
                                _spec("mxu_interpret", js, R), *x, js.cluster_aabb,
                                js.super_aabb),
                            _flat, 2),
    "K1 with_sn": ("teapot_smooth", integrator.KernelClosestSn,
                   lambda s: lambda *x: mi.mesh_closest_hit_sn(
                       *x, s.cluster_aabb, _leaf(s), EPSILON),
                   lambda s: (*_flat(s), _snc(s)),
                   lambda js, R: lambda *x: jint._kernel_closest_sn(
                       _spec("mxu_interpret", js, R), *x, js.cluster_aabb, js.super_aabb),
                   lambda js: (*_flat(js), _snc(js)), 2),
    "K3": ("teapot", integrator.KernelClosestShadow,
           lambda s: lambda *x: mi.mesh_closest_shadow(
               *x, s.cluster_aabb, s.light_pos, _leaf(s), EPSILON, occ=s.occ),
           lambda s: (*_flat(s), s.tri_n),
           lambda js, R: lambda *x: jint._kernel_closest_shadow(
               _spec("mxu_interpret", js, R), *x, js.cluster_aabb, js.light_pos),
           lambda js: (*_flat(js), js.tri_n), 2),
    "K3 with_sn": ("teapot_smooth", integrator.KernelClosestShadowSn,
                   lambda s: lambda *x: mi.mesh_closest_shadow_sn(
                       *x, s.cluster_aabb, s.light_pos, _leaf(s), EPSILON, occ=s.occ),
                   lambda s: (*_flat(s), _snc(s)),
                   lambda js, R: lambda *x: jint._kernel_closest_shadow_sn(
                       _spec("mxu_interpret", js, R), *x, js.cluster_aabb, js.light_pos),
                   lambda js: (*_flat(js), _snc(js)), 2),
}


def _tlas_case(smooth):
    fn = integrator.KernelClosestTlasSn if smooth else integrator.KernelClosestTlas
    kernel = mi.mesh_closest_hit_tlas_sn if smooth else mi.mesh_closest_hit_tlas
    jfn = jint._kernel_closest_tlas_sn if smooth else jint._kernel_closest_tlas

    def search(s):
        tl, st = s.tlas, s.static
        return lambda o, d, p1, e1, e2, pay, ab: kernel(
            o, d, p1, e1, e2, pay, tl.caabb, ab, tl.inst_aabb, tl.inst_mesh,
            tl.inst_obj, st.cluster_size, st.tlas_cm, EPSILON)

    def jax_fn(js, R):
        tl = js.tlas
        return lambda o, d, p1, e1, e2, pay, ab: jfn(
            _tlas_spec(js), o, d, p1, e1, e2, pay, tl.caabb, ab, tl.inst_rf,
            tl.inst_aabb, tl.inst_mesh, tl.inst_obj)

    inputs = lambda s: (s.tlas.p1, s.tlas.e1, s.tlas.e2,
                        s.tlas.sn if smooth else s.tlas.n, s.tlas.inst_ab)
    return ("herd_smooth" if smooth else "herd", fn, search, inputs, jax_fn, inputs, 3)


CASES["K5"] = _tlas_case(False)
CASES["K5 with_sn"] = _tlas_case(True)


def _loss(outs, vec, w, keep, where):
    """sum(t on hits) + sum(n * w), over the rays in keep."""
    t, win = outs[0], outs[1]
    loss = where(keep & (win >= 0), t, 0.0).sum()
    if vec is None:
        return loss
    return loss + where(keep[:, None], outs[vec] * w[:, :outs[vec].shape[1]], 0.0).sum()


def _port_grads(call, inputs, vec, w, keep):
    xs = [x.detach().clone().requires_grad_() for x in inputs]
    loss = _loss(call(*xs), vec, w, keep, torch.where)
    return [g.numpy() for g in torch.autograd.grad(loss, xs)]


@pytest.mark.parametrize("case", list(CASES))
def test_function_grads_match_rtc_tpu_and_plain(scenes, case):
    """The Function's gradients, against jax.grad through rtc_tpu's JVP and
    against autograd through the dense plain sweep in float64 (on the same
    float32 values: the Function's backward evaluates in float64), on the
    rays whose winner all three agree on."""
    name, fn, search, inputs, jax_fn, jax_inputs, vec = CASES[case]
    js, scene, o, d = scenes[name]
    w = np.random.default_rng(0).normal(size=(RAYS, 3)).astype(np.float32)
    tins = (torch.from_numpy(o), torch.from_numpy(d), *inputs(scene))
    lead = ((scene.static.tlas_cm * scene.static.cluster_size, scene.tlas.inst_mesh)
            if scene.tlas is not None else ())
    found = search(scene)
    function = lambda *x: fn.apply(found, EPSILON, *lead, *x)
    jins = tuple(np.asarray(x, np.float64) for x in (o, d, *jax_inputs(js)))
    call = jax_fn(js, RAYS)

    outs = function(*tins)
    assert all(torch.equal(a, b) for a, b in zip(outs, found(*tins)))
    win = outs[1]
    win64 = found(*(x.double() for x in tins))[1]
    jwin = torch.from_numpy(np.asarray(call(*jins)[1]))
    assert torch.equal(win >= 0, jwin >= 0) and torch.equal(win >= 0, win64 >= 0)
    keep = (win == jwin) & (win == win64)
    assert float(keep.float().mean()) > 0.95
    assert int((keep & (win >= 0)).sum()) > RAYS // 4, "too few hits for a gradient test"

    got = _port_grads(function, tins, vec, torch.from_numpy(w), keep)
    plain = _port_grads(found, [x.double() for x in tins], vec,
                        torch.from_numpy(w).double(), keep)
    for k, (a, b) in enumerate(zip(got, plain)):
        np.testing.assert_allclose(a, b, **TOL, err_msg=f"input {k} vs plain")

    jkeep = jnp.asarray(keep.numpy())
    jgot = jax.grad(lambda *x: _loss(call(*x), vec, w, jkeep, jnp.where),
                    argnums=tuple(range(len(jins))))(*jins)
    for k, (a, b) in enumerate(zip(got, jgot)):
        np.testing.assert_allclose(a, np.asarray(b), **TOL, err_msg=f"input {k} vs rtc_tpu")
    assert any(np.abs(a).sum() > 0 for a in got[2:])  # the tables get gradients


def test_functions_need_no_graph_without_grads(scenes):
    """Under no_grad, or with no input that requires grad, a Function
    returns the search's outputs and keeps no graph."""
    _, scene, o, d = scenes["teapot"]
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    found = CASES["K3"][2](scene)
    want = found(o, d, *_flat(scene), scene.tri_n)
    got = integrator.KernelClosestShadow.apply(found, EPSILON, o, d, *_flat(scene),
                                               scene.tri_n)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(x.grad_fn is None for x in got)
    p1 = scene.tri_p1.clone().requires_grad_()
    t, idx, n, sh = integrator.KernelClosestShadow.apply(
        found, EPSILON, o, d, p1, scene.tri_e1, scene.tri_e2, scene.tri_n)
    assert t.grad_fn is not None and n.grad_fn is not None
    assert not idx.requires_grad and not sh.requires_grad


# --- inject_params and the tables derived from the triangle rows ---------------

@pytest.fixture(scope="module")
def cow():
    world, cam = REGISTRY["cow"](32)
    return compile_scene(world, device="cpu"), cam


def test_inject_rows_rebuilds_boxes_and_occlusion_tables(cow):
    scene, _ = cow
    leaf = scene.static.cluster_size
    p1 = scene.tri_p1.clone()
    moved = torch.tensor([5, 700, 3001])
    p1[moved] += torch.tensor([0.8, -0.6, 0.7])
    new = RG.inject_params(scene, {"tri_p1": p1})
    rows = (p1, new.tri_e1, new.tri_e2)
    # the boxes of the clusters whose rows moved bound their real rows (f64
    # vertex sums, rounded to f32 as compile_scene rounds them); the others
    # are untouched
    changed = torch.zeros(scene.static.n_clusters, dtype=torch.bool)
    changed[moved // leaf] = True
    assert torch.equal(new.cluster_aabb[~changed], scene.cluster_aabb[~changed])
    for c in torch.nonzero(changed)[:, 0].tolist():
        r = slice(c * leaf, (c + 1) * leaf)
        a, e1, e2 = (x[r].double() for x in rows)
        real = (e1 != 0).any(1) | (e2 != 0).any(1)
        verts = torch.cat([a[real], (a + e1)[real], (a + e2)[real]])
        box = torch.cat([verts.amin(0), verts.amax(0)]).float()
        assert torch.equal(new.cluster_aabb[c], box)
    assert not torch.equal(new.cluster_aabb[changed], scene.cluster_aabb[changed])
    sup = new.super_aabb
    for g in range(sup.shape[0]):
        block = new.cluster_aabb[g * 8:(g + 1) * 8]
        block = block[block[:, 0] <= block[:, 3]]
        if len(block):
            assert torch.equal(sup[g, :3], block[:, :3].amin(0))
            assert torch.equal(sup[g, 3:], block[:, 3:].amax(0))
    want = occlusion_tables(*rows, new.cluster_aabb, leaf, tri_cid=scene.tri_cid)
    for f in want._fields:
        assert torch.equal(getattr(new.occ, f), getattr(want, f)), f
    assert not torch.equal(new.occ.rows, scene.occ.rows)
    assert new.occ.tri_cid is scene.tri_cid
    # the occlusion walk's rows are the new triangles
    assert set(new.occ.rows[:, :3].reshape(-1).tolist()) >= set(p1[moved].reshape(-1).tolist())


def test_inject_same_rows_keeps_tables(cow):
    scene, _ = cow
    params = RG.extract_params(scene, RG.DEFAULT_PARAMS + ("tri_p1", "tri_e1"))
    new = RG.inject_params(scene, params)
    assert new.occ is scene.occ and new.cluster_aabb is scene.cluster_aabb
    assert new.tri_p1 is params["tri_p1"]


def test_inject_rows_refused_on_instanced_scene():
    scene = compile_scene(cow_herd_world(3, 3), device="cpu")
    assert scene.tlas is not None
    same = RG.inject_params(scene, RG.extract_params(scene, ("tri_p1",)))
    assert same.tlas_occ is scene.tlas_occ
    with pytest.raises(ValueError, match="instanced scene"):
        RG.inject_params(scene, {"tri_p1": scene.tri_p1 + 0.01})


def test_cow_gradients_through_color_at_match_rtc_tpu():
    """The mesh slice as a whole: the f64 cow's loss_and_grad, material,
    light and triangle rows, on the plain path of both packages."""
    world, cam = JAX_REGISTRY["cow"](16)
    js = jax_compile_scene(world, dtype=np.float64)
    dt = jnp.float64
    o, d = jax_camera_rays(jnp.asarray(cam.transform_inverse, dt), cam.hsize, cam.vsize,
                           cam.half_width, cam.half_height, cam.pixel_size, dt)
    target = jnp.zeros_like(o) + 0.25
    names = RG.DEFAULT_PARAMS + ("tri_p1", "tri_e1", "tri_e2", "tri_n")
    jparams = JRG.extract_params(js, names)
    jloss, jgrads = JRG.loss_and_grad(jparams, js, o, d, target,
                                      JaxRenderConfig(dtype="float64",
                                                      mesh_impl="bruteforce"))
    params = params_from_numpy({k: np.asarray(v) for k, v in jparams.items()}, "cpu")
    t = lambda a: torch.from_numpy(np.array(a))
    loss, grads = RG.loss_and_grad(params, _carry(js), t(o), t(d), t(target),
                                   RenderConfig(dtype="float64", mesh_impl="bruteforce"))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-12)
    for k in names:
        np.testing.assert_allclose(grads[k].numpy(), np.asarray(jgrads[k]),
                                   rtol=1e-6, atol=1e-10, err_msg=k)
    assert float(grads["tri_p1"].abs().sum()) > 0
