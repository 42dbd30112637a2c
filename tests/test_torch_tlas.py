"""Instanced meshes (TLAS) in rtc_tpu_torch against rtc_tpu, on the 3x3 herd
(cow_herd_world(3, 3): 52,236 world triangles, 9 instances padded to 16,
TLAS-eligible in both packages): the compiled tables element for element,
the gid map, the plain versions of K5 (flat and with_sn) and K6 against
rtc_tpu's Pallas kernels in interpret mode on identical tables and rays,
color_at through the instanced route against rtc_tpu's, the route's
wrappers, the f64 render, and the padding instances. The CUDA kernels are
held against these plain versions on the GPU (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rtc_tpu.models.scenes import _cam as jax_cam
from rtc_tpu.models.scenes import cow_herd_world as jax_cow_herd_world
from rtc_tpu.ops.pallas.mesh_intersect import (mesh_any_hit_tlas_mxu,
                                               mesh_closest_hit_tlas_mxu)
from rtc_tpu.render import integrator as jax_integrator
from rtc_tpu.render.camera import camera_rays as jax_camera_rays
from rtc_tpu.render.renderer import render as jax_render
from rtc_tpu.scene.compile import compile_scene as jax_compile_scene
from rtc_tpu.utils.config import RenderConfig as JaxRenderConfig
from rtc_tpu_torch.models.scenes import REGISTRY, _cam, cow_herd_world
from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
from rtc_tpu_torch.render import integrator
from rtc_tpu_torch.render.renderer import render
from rtc_tpu_torch.scene.compile import (TENSOR_FIELDS, TlasTables,
                                         compile_scene, scene_from_numpy)
from rtc_tpu_torch.utils.config import RenderConfig
from rtc_tpu_torch.utils.constants import BIG

torch.set_num_threads(2)


def _compile(world, **kw):
    """The port's compile_scene on the CPU: its default device is the card."""
    return compile_scene(world, device="cpu", **kw)


# tests/test_tlas.py's camera for the 3x3 herd
EYE, LOOK = [0, 10, -18], [0, 3, 2]
JAX_KERN = JaxRenderConfig(dtype="float32", mesh_impl="mxu_interpret")
TLAS_WRAPPERS = ("mesh_closest_hit_tlas", "mesh_closest_hit_tlas_sn",
                 "mesh_any_hit_tlas")
FLAT_WRAPPERS = ("mesh_closest_hit", "mesh_closest_hit_sn", "mesh_any_hit",
                 "mesh_closest_shadow", "mesh_closest_shadow_sn",
                 "mesh_crossing_count")


def _jax_rays(width):
    cam = jax_cam(width, EYE, LOOK)
    dt = jnp.float32
    o, d = jax_camera_rays(jnp.asarray(cam.transform_inverse, dt), cam.hsize,
                           cam.vsize, jnp.asarray(cam.half_width, dt),
                           jnp.asarray(cam.half_height, dt),
                           jnp.asarray(cam.pixel_size, dt), dt)
    return np.array(o), np.array(d)


def _numpy_tables(js):
    arrays = {f: np.array(getattr(js, f)) for f in TENSOR_FIELDS}
    arrays["tlas"] = {k: np.array(v) for k, v in js.tlas._asdict().items()}
    return arrays


@pytest.fixture(scope="module")
def herds():
    """Per shading ("flat", "smooth"): rtc_tpu's f32 scene of the 3x3 herd,
    the port's scene carried from its tables, the port's own compile, and
    the 64x32 camera rays of tests/test_tlas.py as numpy."""
    o, d = _jax_rays(64)
    out = {}
    for kind in ("flat", "smooth"):
        smooth = kind == "smooth"
        js = jax_compile_scene(jax_cow_herd_world(3, 3, smooth),
                               dtype=np.float32)
        carried = scene_from_numpy(_numpy_tables(js), js.static._asdict(),
                                   device="cpu")
        out[kind] = (js, carried, _compile(cow_herd_world(3, 3, smooth)),
                     o, d)
    return out


def _k5_args(scene):
    tl, st = scene.tlas, scene.static
    return (tl.p1, tl.e1, tl.e2, tl.sn if st.tlas_sn else tl.n, tl.inst_ab,
            tl.inst_aabb, tl.inst_mesh, tl.inst_obj, st.cluster_size, st.tlas_cm)


def _k6_args(scene):
    tl, st = scene.tlas, scene.static
    return (tl.p1, tl.e1, tl.e2, tl.inst_ab, tl.inst_aabb, tl.inst_mesh,
            st.cluster_size, st.tlas_cm)


def _plain_k5(scene, o, d):
    fn = mi.closest_hit_tlas_sn_plain if scene.static.tlas_sn else mi.closest_hit_tlas_plain
    return fn(torch.from_numpy(o), torch.from_numpy(d), *_k5_args(scene))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_tlas_tables_match_rtc_tpu(dtype):
    """TlasTables and the TLAS statics equal rtc_tpu's element for element
    (inst_rf, rtc_tpu's Plücker feature transform, is not kept)."""
    np_dt, torch_dt = {"float32": (np.float32, torch.float32),
                       "float64": (np.float64, torch.float64)}[dtype]
    js = jax_compile_scene(jax_cow_herd_world(3, 3), dtype=np_dt)
    scene = _compile(cow_herd_world(3, 3), dtype=torch_dt)
    st = scene.static
    assert (st.tlas_n_inst, st.tlas_n_mesh, st.tlas_cm, st.tlas_sn) == (16, 1, 48, False)
    assert st == type(st)(**{f: getattr(js.static, f) for f in type(st)._fields})
    assert set(TlasTables._fields) == set(js.tlas._fields) - {"inst_rf"}
    for field in TlasTables._fields:
        ref = np.asarray(getattr(js.tlas, field))
        got = getattr(scene.tlas, field).numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape, field
        assert np.array_equal(got, ref), field


def test_registry_herds_compile_to_tlas():
    """cow_herd and cow_herd_smooth: 90 instances padded to 96 of one
    unique 5,804-triangle mesh of 48 clusters, over a 4,088-cluster world
    table."""
    for name in ("cow_herd", "cow_herd_smooth"):
        st = _compile(REGISTRY[name](32)[0]).static
        assert (st.tlas_n_inst, st.tlas_n_mesh, st.tlas_cm) == (96, 1, 48), name
        assert (st.n_tris, st.n_clusters, st.n_objects) == (523264, 4088, 90), name
        assert st.tlas_sn == (name == "cow_herd_smooth")


def test_tlas_gid_roundtrip(herds):
    """Instance-local rows map to the world-table rows that hold the same
    triangle pushed through the instance's transform (test_tlas.py)."""
    _, _, scene, _, _ = herds["flat"]
    tl, st = scene.tlas, scene.static
    tm = st.tlas_cm * st.cluster_size
    ab = tl.inst_ab.double().numpy()
    up1, ue1, gid = tl.p1.numpy(), tl.e1.numpy(), tl.gid.numpy()
    p1w = scene.tri_p1.double().numpy()
    for i in range(9):
        m = int(tl.inst_mesh[i])
        real = np.abs(ue1[m * tm:(m + 1) * tm]).sum(1) > 0
        back = p1w[gid[i][real]] @ ab[i, :9].reshape(3, 3).T + ab[i, 9:]
        np.testing.assert_allclose(back, up1[m * tm:(m + 1) * tm][real], atol=1e-4)
        # and to the rows of instance i's own object
        assert (scene.tri_obj[torch.from_numpy(gid[i][real]).long()] == i).all()


@pytest.mark.parametrize("kind", ["flat", "smooth"])
def test_scene_from_numpy_carries_tlas(herds, kind):
    _, carried, scene, _, _ = herds[kind]
    assert carried.static == scene.static
    for field in TENSOR_FIELDS:
        assert torch.equal(getattr(carried, field), getattr(scene, field)), field
    for field in TlasTables._fields:
        assert torch.equal(getattr(carried.tlas, field),
                           getattr(scene.tlas, field)), field


@pytest.fixture(scope="module")
def k5_parity(herds):
    """Plain K5 and rtc_tpu's interpret-mode K5 on the 64x32 rays."""
    out = {}
    for kind, (js, scene, _, o, d) in herds.items():
        jt = js.tlas
        pay = dict(tri_sn=jt.sn) if kind == "smooth" else dict(tri_n=jt.n)
        ref = mesh_closest_hit_tlas_mxu(
            o, d, jt.p1, jt.e1, jt.e2, jt.caabb, jt.inst_ab, jt.inst_rf,
            jt.inst_aabb, jt.inst_mesh, jt.inst_obj,
            leaf=js.static.cluster_size, cm=js.static.tlas_cm, interpret=True,
            **pay)
        out[kind] = ([x.numpy() for x in _plain_k5(scene, o, d)],
                     [np.asarray(x) for x in ref])
    return out


def _unit(n):
    return n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30)


@pytest.mark.parametrize("kind", ["flat", "smooth"])
def test_k5_plain_matches_rtc_tpu(k5_parity, kind):
    """tests/test_tlas.py's tolerances: equal hit masks, |dt| <= 5e-4, enc
    equal on > 0.999 of hits, obj equal; unit n within 1e-3 (flat), or
    dot > 0.999 on > 0.995 of hits (smooth, where the port's (u, v) from a
    direct Möller-Trumbore and rtc_tpu's from its Plücker matmul differ in
    the last digits)."""
    (t, enc, obj, n), (rt, renc, robj, rn) = k5_parity[kind]
    hit = enc >= 0
    np.testing.assert_array_equal(hit, renc >= 0)
    assert hit.sum() > 100
    np.testing.assert_allclose(t[hit], rt[hit], rtol=0, atol=5e-4)
    assert (t[~hit] == np.float32(BIG)).all() and (n[~hit] == 0).all()
    assert (enc[hit] == renc[hit]).mean() > 0.999
    np.testing.assert_array_equal(obj, robj)
    if kind == "flat":
        np.testing.assert_allclose(_unit(n)[hit], _unit(rn)[hit], rtol=0, atol=1e-3)
    else:
        dots = (_unit(n) * _unit(rn)).sum(1)
        assert (dots[hit] > 0.999).mean() > 0.995


def test_k6_plain_matches_rtc_tpu(herds, k5_parity):
    """Free-space occlusion queries (bench.py:84-96) from the flat herd's
    hits: halfway to each hit toward the light, and from the light toward
    each hit, stopping 0.05 short. Agreement on > 0.999 of the rays."""
    js, scene, _, o, d = herds["flat"]
    (t, enc, _, _), _ = k5_parity["flat"]
    hit = enc >= 0
    o, d, t = o[hit], d[hit], t[hit][:, None]
    light = np.asarray(scene.light_pos, np.float32)[None]
    half, target = o + d * (t * 0.5), o + d * t
    v = np.concatenate([light - half, target - light])
    dist = np.sqrt((v * v).sum(1))
    so = np.concatenate([half, np.broadcast_to(light, target.shape)]).astype(np.float32)
    sd = (v / dist[:, None]).astype(np.float32)
    max_t = np.concatenate([dist[:len(half)], dist[len(half):] - 0.05]).astype(np.float32)
    got = mi.any_hit_tlas_plain(torch.from_numpy(so), torch.from_numpy(sd),
                                torch.from_numpy(max_t), *_k6_args(scene)).numpy()
    jt = js.tlas
    ref = np.asarray(mesh_any_hit_tlas_mxu(
        so, sd, max_t, jt.p1, jt.e1, jt.e2, jt.caabb, jt.inst_rf, jt.inst_aabb,
        jt.inst_mesh, leaf=js.static.cluster_size, cm=js.static.tlas_cm,
        interpret=True))
    assert 10 < got.sum() < len(got)
    assert (got == ref).mean() > 0.999


@pytest.fixture(scope="module")
def tlas_colors(herds):
    """color_at of each herd through the port's instanced route (forced on
    the CPU: the wrappers then run their plain versions), with every mesh
    wrapper wrapped in a spy that counts its calls, and rtc_tpu's
    interpret-mode color_at on the same tables and rays."""
    out = {}
    for kind, (js, scene, _, o, d) in herds.items():
        calls = dict.fromkeys(TLAS_WRAPPERS + FLAT_WRAPPERS, 0)

        def spy(name, fn):
            def wrapped(*args, **kwargs):
                calls[name] += 1
                return fn(*args, **kwargs)
            return wrapped

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(integrator, "mesh_impl_for", lambda *a: "kernel")
            for name in calls:
                mp.setattr(mi, name, spy(name, getattr(mi, name)))
            mi.reset_launch_counts()
            got = integrator.color_at(scene, torch.from_numpy(o),
                                      torch.from_numpy(d), RenderConfig())
            launches = dict(mi.LAUNCHES)
        ref = np.asarray(jax_integrator.color_at(js, o, d, JAX_KERN))
        out[kind] = got.numpy(), ref, calls, launches
    return out


@pytest.mark.parametrize("kind", ["flat", "smooth"])
def test_color_at_tlas_route_matches_rtc_tpu(tlas_colors, kind):
    """Flat: max |d| < 1e-3 (test_tlas_color_parity). Smooth: rtc_tpu's
    budget for smooth normals' knife edges, 99.9th percentile below 2e-3
    and at most 2 pixels above 0.05 (test_tlas_smooth_color_parity)."""
    got, ref, _, _ = tlas_colors[kind]
    assert got.max() > 0.1
    err = np.abs(got - ref).max(axis=1)
    if kind == "flat":
        assert err.max() < 1e-3
    else:
        assert np.quantile(err, 0.999) < 2e-3 and (err > 0.05).sum() <= 2


@pytest.mark.parametrize("kind", ["flat", "smooth"])
def test_tlas_route_calls_only_tlas_wrappers(tlas_colors, kind):
    """One node (the herd is not reflective): one K5 call of the scene's
    payload mode and one K6 call; no K1-K4 wrapper (K3 would sweep the
    whole world table); no launch on CPU tensors."""
    _, _, calls, launches = tlas_colors[kind]
    k5 = "mesh_closest_hit_tlas_sn" if kind == "smooth" else "mesh_closest_hit_tlas"
    want = dict.fromkeys(calls, 0)
    want.update({k5: 1, "mesh_any_hit_tlas": 1})
    assert calls == want
    assert launches == dict.fromkeys(mi.LAUNCHES, 0)


def test_render_f64_matches_rtc_tpu():
    """The f64 render of the 3x3 herd (bruteforce over the world table in
    both packages) at width 32 equals rtc_tpu's at 1e-9."""
    cam = _cam(32, EYE, LOOK)
    img = render(_compile(cow_herd_world(3, 3), dtype=torch.float64), cam,
                 RenderConfig(dtype="float64", ray_tile=512)).numpy()
    ref = np.asarray(jax_render(
        jax_compile_scene(jax_cow_herd_world(3, 3), dtype=np.float64),
        jax_cam(32, EYE, LOOK),
        JaxRenderConfig(dtype="float64", ray_tile=512)))
    assert img.max() > 0.1
    np.testing.assert_allclose(img, ref, atol=1e-9, rtol=0)


def test_padding_instances_are_ignored(herds):
    """Padding instances carry the identity transform and mesh 0: only their
    empty box keeps the untransformed cow at the world origin out. Rays
    aimed at the origin hit that cow in object space, yet the plain K5 and
    K6 report what the world-table sweep reports."""
    _, _, scene, _, _ = herds["flat"]
    assert scene.static.tlas_n_inst > 9  # 7 padding instances
    rng = np.random.default_rng(5)
    origin = rng.normal(size=(256, 3))
    origin *= 30.0 / np.linalg.norm(origin, axis=1, keepdims=True)
    d = rng.uniform(-1.0, 1.0, (256, 3)) - origin
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = (torch.tensor(a, dtype=torch.float32) for a in (origin, d))
    tl, st = scene.tlas, scene.static
    tm = st.tlas_cm * st.cluster_size
    _, trap = mi.closest_hit_plain(o, d, tl.p1[:tm], tl.e1[:tm], tl.e2[:tm],
                                   tl.n[:tm])[:2]
    world = mi.closest_hit_plain(o, d, scene.tri_p1, scene.tri_e1,
                                 scene.tri_e2, scene.tri_n)
    assert int((trap >= 0).sum()) > 100 > int((world[1] >= 0).sum())
    t, enc, obj, _ = mi.closest_hit_tlas_plain(o, d, *_k5_args(scene))
    hit = enc >= 0
    assert torch.equal(hit, world[1] >= 0)
    torch.testing.assert_close(t[hit], world[0][hit], rtol=0, atol=5e-4)
    assert (obj[hit] < 9).all()
    max_t = torch.full((256,), 60.0)
    assert torch.equal(
        mi.any_hit_tlas_plain(o, d, max_t, *_k6_args(scene)),
        mi.any_hit_plain(o, d, max_t, scene.tri_p1, scene.tri_e1, scene.tri_e2))
