"""Superblock streaming and K1's t0 and (u, v) modes, in rtc_tpu_torch
against rtc_tpu on the CPU. The drivers (closest_hit_blocked,
any_hit_blocked, crossing_count_blocked) are device-agnostic PyTorch that
call the wrappers once per block, so here they run the plain versions block
by block; they are held against rtc_tpu's blocked calls in interpret mode
at a budget of two clusters (tests/test_pallas_mesh.py:113-135, 329-348,
404-420, 450-478, 481-505) and against the port's own single call. Then
the block order, and the one-mesh 3x3 herd (52,236 triangles in one mesh
leaf: two superblocks, so no fused kernel) through color_at's streamed
branch against rtc_tpu's. The CUDA kernels are held against the same
plain versions on the GPU (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rtc_tpu.models.scenes import REGISTRY as JAX_REGISTRY
from rtc_tpu.models.scenes import _cam as jax_cam
from rtc_tpu.ops.pallas.mesh_intersect import _block_order as jax_block_order
from rtc_tpu.ops.pallas.mesh_intersect import _block_tables as jax_block_tables
from rtc_tpu.ops.pallas.mesh_intersect import _blocked as jax_blocked
from rtc_tpu.ops.pallas.mesh_intersect import (mesh_any_hit_mxu,
                                               mesh_closest_hit_mxu,
                                               mesh_crossing_count_mxu)
from rtc_tpu.render import integrator as jax_integrator
from rtc_tpu.render.camera import camera_rays as jax_camera_rays
from rtc_tpu.scene import shapes as jax_shapes
from rtc_tpu.scene.compile import compile_scene as jax_compile_scene
from rtc_tpu.scene.materials import Material as JaxMaterial
from rtc_tpu.scene.world import PointLight as JaxPointLight
from rtc_tpu.scene.world import World as JaxWorld
from rtc_tpu.utils.config import RenderConfig as JaxRenderConfig
from rtc_tpu_torch.models.scenes import (REGISTRY, baked_meshes,
                                         cow_herd_mesh_world, cow_herd_world)
from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
from rtc_tpu_torch.render import integrator
from rtc_tpu_torch.scene.compile import compile_scene
from rtc_tpu_torch.utils.config import RenderConfig
from rtc_tpu_torch.utils.constants import BIG, FAR, PARK, VMEM_TRI_BUDGET

torch.set_num_threads(2)

# tests/test_tlas.py's camera for the 3x3 herd
EYE, LOOK = [0, 10, -18], [0, 3, 2]


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


def _pair(name, step):
    """rtc_tpu's f32 scene of a registry scene at 32 px, the port's own
    compile of it, and every step-th of rtc_tpu's camera rays (256 at
    most), as numpy and as torch."""
    world, cam = JAX_REGISTRY[name](32)
    js = jax_compile_scene(world, dtype=np.float32)
    scene = _compile(REGISTRY[name](32)[0])
    o, d = (a[::step][:256] for a in jax_rays(cam))
    return js, scene, o, d, torch.from_numpy(o), torch.from_numpy(d)


@pytest.fixture(scope="module")
def teapot():
    return _pair("teapot", 5)


def _jax_args(js):
    return (js.tri_p1, js.tri_e1, js.tri_e2, js.cluster_aabb, js.super_aabb)


def _kw(js, **extra):
    return dict(n_super=js.static.n_super, leaf=js.static.cluster_size,
                interpret=True, **extra)


def _tabs(scene):
    return scene.tri_p1, scene.tri_e1, scene.tri_e2


def _assert_same_winners(t, idx, t_ref, idx_ref, exact: bool):
    """Equal hit masks; t bit-equal (exact) or within rtc_tpu's kernel
    tolerance (rtol 1e-5, atol 1e-6: its Plücker matmul rounds otherwise);
    idx equal on more than 99% of hits. Returns the rays with equal idx."""
    t, idx, t_ref, idx_ref = (np.asarray(a) for a in (t, idx, t_ref, idx_ref))
    hit = idx >= 0
    np.testing.assert_array_equal(hit, idx_ref >= 0)
    assert 10 < hit.sum() < len(hit)
    if exact:
        np.testing.assert_array_equal(t, t_ref)
    else:
        np.testing.assert_allclose(t[hit], t_ref[hit], rtol=1e-5, atol=1e-6)
    assert (t[~hit] == np.float32(BIG)).all()
    same = hit & (idx == idx_ref)
    assert same.sum() > 0.99 * hit.sum()
    return same


def test_streamed_closest_with_normal(teapot):
    """Flat payload (test_blocked_streaming_with_normal_payload): the
    streamed plain K1 at 2 clusters a block against rtc_tpu's blocked call
    and against the port's single call; the normal bit-equal wherever the
    winners agree."""
    js, scene, o, d, ot, dt = teapot
    leaf = scene.static.cluster_size
    args = (*_tabs(scene), scene.tri_n, scene.cluster_aabb, leaf)
    assert mi._blocked(scene.tri_p1, leaf, 2 * leaf) == 28
    t, idx, n = mi.closest_hit_blocked(ot, dt, *_tabs(scene), scene.cluster_aabb, 28,
                                       leaf, tri_n=scene.tri_n)
    t1, i1, n1 = mi.mesh_closest_hit(ot, dt, *args)
    same = _assert_same_winners(t, idx, t1, i1, exact=True)
    assert torch.equal(n[same], n1[same])
    tr, ir, nr = mesh_closest_hit_mxu(o, d, *_jax_args(js), **_kw(
        js, tri_n=js.tri_n, vmem_tri_budget=2 * leaf))
    same = _assert_same_winners(t, idx, tr, ir, exact=False)
    np.testing.assert_array_equal(n.numpy()[same], np.asarray(nr)[same])


def test_streamed_any_hit(teapot):
    """test_blocked_streaming_matches_single's occlusion query (max_t 50):
    the streamed plain K2 equals the port's single call, and rtc_tpu's
    blocked call on more than 0.995 of the rays."""
    js, scene, o, d, ot, dt = teapot
    leaf = scene.static.cluster_size
    mt = np.full((o.shape[0],), 50.0, np.float32)
    mt[::4] = -1.0  # dead lanes
    args = (*_tabs(scene), scene.cluster_aabb, leaf)
    h = mi.any_hit_blocked(ot, dt, torch.from_numpy(mt), *_tabs(scene),
                           scene.cluster_aabb, mi._blocked(scene.tri_p1, leaf, 2 * leaf),
                           leaf)
    assert torch.equal(h, mi.mesh_any_hit(ot, dt, torch.from_numpy(mt), *args))
    ref = np.asarray(mesh_any_hit_mxu(o, d, mt, *_jax_args(js), **_kw(
        js, vmem_tri_budget=2 * leaf)))
    assert 10 < int(h.sum()) and not h[::4].any()
    assert (h.numpy() == ref).mean() > 0.995


def test_streamed_census():
    """test_crossing_kernel_blocked_matches_single on glass_teapot, with
    its primary rays' hits as census bounds, and on whole lines (t_hit =
    BIG, no hit triangle) so that crossings are counted: the streamed plain
    K4 (counts summed, latest crossing maxed, hit_gid rebased per block)
    equals the port's single call exactly, and rtc_tpu's blocked call on
    more than 0.995 of the rays (t == t_hit knife edges)."""
    js, scene, o, d, ot, dt = _pair("glass_teapot", 5)
    leaf = scene.static.cluster_size
    t, idx = mi.closest_hit_plain(ot, dt, *_tabs(scene), scene.tri_n)[:2]
    gid = torch.where(idx >= 0, idx, -2).to(torch.int32)
    args = (*_tabs(scene), scene.cluster_aabb, scene.tri_cid, 1, leaf)
    n_blocks = mi._blocked(scene.tri_p1, leaf, 2 * leaf)
    crossings = 0
    for t_hit, g in ((t, gid), (torch.full_like(t, BIG), torch.full_like(gid, -2))):
        cnt, last = mi.crossing_count_blocked(ot, dt, t_hit, g, *_tabs(scene),
                                              scene.cluster_aabb, scene.tri_cid, 1,
                                              n_blocks, leaf)
        c1, l1 = mi.mesh_crossing_count(ot, dt, t_hit, g, *args)
        assert torch.equal(cnt, c1) and torch.equal(last, l1)
        crossings += int(cnt.sum())
        cr, lr = mesh_crossing_count_mxu(
            o, d, t_hit.numpy(), g.numpy(), js.tri_p1, js.tri_e1, js.tri_e2,
            js.cluster_aabb, js.tri_cid, n_containers=1, leaf=leaf,
            interpret=True, vmem_tri_budget=2 * leaf)
        same = (cnt.numpy() == np.asarray(cr)).all(1)
        assert same.mean() > 0.995
        np.testing.assert_allclose(last.numpy()[same], np.asarray(lr)[same],
                                   rtol=1e-5, atol=1e-5)
    assert crossings > 30


def test_streamed_uv():
    """test_uv_blocked_streaming_matches_single on teapot_smooth: the
    streamed plain K1 with_uv against the port's single call (t bit-equal,
    (u, v) bit-equal at equal winners) and rtc_tpu's blocked call ((u, v)
    within 1e-4 at equal winners: its Plücker matmul rounds otherwise)."""
    js, scene, o, d, ot, dt = _pair("teapot_smooth", 5)
    leaf = scene.static.cluster_size
    args = (*_tabs(scene), scene.cluster_aabb, leaf)
    t, idx, uv = mi.closest_hit_blocked(ot, dt, *_tabs(scene), scene.cluster_aabb,
                                        mi._blocked(scene.tri_p1, leaf, 2 * leaf), leaf,
                                        want_uv=True)
    t1, i1, uv1 = mi.mesh_closest_hit_uv(ot, dt, *args)
    same = _assert_same_winners(t, idx, t1, i1, exact=True)
    assert torch.equal(uv[same], uv1[same])
    assert (uv[idx < 0] == 0).all()
    tr, ir, uvr = mesh_closest_hit_mxu(o, d, *_jax_args(js), **_kw(
        js, want_uv=True, vmem_tri_budget=2 * leaf))
    same = _assert_same_winners(t, idx, tr, ir, exact=False)
    np.testing.assert_allclose(uv.numpy()[same], np.asarray(uvr)[same],
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("payload", ["n", "uv"])
def test_carried_t0_contract(teapot, payload):
    """test_carried_t0_bound_semantics: with t0, only hits strictly before
    it are reported; a bound below every hit reports t = BIG, idx = -1
    (and a zero payload); a bound above every hit gives the free winners
    back exactly. rtc_tpu's t0 call agrees on the winners. A streamed call
    takes no t0: the driver carries its own."""
    js, scene, o, d, ot, dt = teapot
    leaf = scene.static.cluster_size
    if payload == "n":
        call = lambda t0: mi.mesh_closest_hit(ot, dt, *_tabs(scene), scene.tri_n,
                                              scene.cluster_aabb, leaf, t0=t0)
    else:
        call = lambda t0: mi.mesh_closest_hit_uv(ot, dt, *_tabs(scene),
                                                 scene.cluster_aabb, leaf, t0=t0)
    t_free, i_free, p_free = call(None)
    hit = i_free >= 0
    assert hit.any() and (~hit).any()
    t, i, p = call(torch.where(hit, t_free * 0.5, 1e-3))
    assert (i == -1).all() and (t == BIG).all() and (p == 0).all()
    t0_high = torch.where(hit, t_free * 1.5, BIG)
    t, i, p = call(t0_high)
    assert torch.equal(t, t_free) and torch.equal(i, i_free)
    assert torch.equal(p, p_free)
    # a bound AT the hit: strictly before, so nothing
    assert (call(torch.where(hit, t_free, 1e-3))[1] == -1).all()
    tr, ir = mesh_closest_hit_mxu(o, d, *_jax_args(js), **_kw(
        js, t0=t0_high.numpy()))
    assert (np.asarray(ir)[hit.numpy()] == i.numpy()[hit.numpy()]).mean() > 0.99
    with pytest.raises(TypeError, match="t0"):
        mi.closest_hit_blocked(ot, dt, *_tabs(scene), scene.cluster_aabb,
                               mi._blocked(scene.tri_p1, leaf, 2 * leaf), leaf,
                               tri_n=scene.tri_n, t0=t_free)


def _herd_pair(smooth: bool):
    """The one-mesh 3x3 herd in both packages, from the same baked arrays,
    with the 64x32 camera rays of tests/test_tlas.py."""
    world = cow_herd_mesh_world(3, 3, smooth)
    m, light = world.objects[0].material, world.light
    jax_world = JaxWorld(objects=[jax_shapes.mesh(
        *baked_meshes(cow_herd_world(3, 3, smooth)),
        material=JaxMaterial(color=m.color, ambient=m.ambient, diffuse=m.diffuse,
                             specular=m.specular, shininess=m.shininess))],
        light=JaxPointLight(light.position, light.intensity))
    js = jax_compile_scene(jax_world, dtype=np.float32)
    scene = _compile(world)
    return js, scene, *jax_rays(jax_cam(64, EYE, LOOK))


@pytest.fixture(scope="module")
def herds():
    return {kind: _herd_pair(kind == "smooth") for kind in ("flat", "smooth")}


@pytest.mark.parametrize("where", ["teapot", "herd"])
def test_block_order_matches_rtc_tpu(teapot, herds, where):
    """_block_order (views, stable argsort) equals rtc_tpu's (padded
    blocks) on the same tables and rays, parked and dead lanes included:
    they enter no block. Teapot at 2 clusters a block (an all-padding
    block among them); the one-mesh herd at the default budget."""
    if where == "teapot":
        js, scene, o, d = teapot[:4]
        budget = 2 * scene.static.cluster_size
    else:
        js, scene, o, d = herds["flat"]
        budget = VMEM_TRI_BUDGET
    leaf = scene.static.cluster_size
    n_blocks = mi._blocked(scene.tri_p1, leaf, budget)
    assert n_blocks == jax_blocked(js.tri_p1, leaf, budget) > 1
    o = np.concatenate([o, np.full((8, 3), FAR, np.float32)])
    d = np.concatenate([d, np.full((8, 3), PARK, np.float32)])
    aabbb = jax_block_tables(js.tri_p1, js.tri_e1, js.tri_e2,
                             js.cluster_aabb, n_blocks, leaf)[3]
    ref = np.asarray(jax_block_order(o, d, aabbb))
    per_block = -(-scene.static.n_clusters // n_blocks)
    got = mi._block_order(torch.from_numpy(o), torch.from_numpy(d),
                          scene.cluster_aabb, per_block)
    np.testing.assert_array_equal(got.numpy(), ref)
    # the parked lanes alone: every block they could enter is an
    # all-padding one (its union box is inverted, so rtc_tpu's slab test
    # gives it entry 0); the rest keep table order
    far = mi._block_order(torch.from_numpy(o[-8:]), torch.from_numpy(d[-8:]),
                          scene.cluster_aabb, per_block)
    empty = (scene.cluster_aabb[:, :3] > scene.cluster_aabb[:, 3:]).any(1)
    padding = [bool(empty[b * per_block:(b + 1) * per_block].all())
               for b in range(n_blocks)]
    assert far.tolist() == sorted(range(n_blocks), key=lambda b: (not padding[b], b))


def test_one_mesh_herd_compiles_to_two_blocks(herds):
    """One leaf is never instanced (fewer than 2 triangle leaves), and its
    53,248-row table is over the budget: two superblocks, and so no fused
    kernel, flat or smooth."""
    for kind, (js, scene, _, _) in herds.items():
        st = scene.static
        assert (st.tlas_n_inst, st.n_tris, st.n_clusters) == (0, 53248, 416)
        assert st.any_smooth == (kind == "smooth")
        p = integrator.plan(scene, RenderConfig(), "cuda", torch.float32)
        assert mi._blocked(scene.tri_p1, st.cluster_size, VMEM_TRI_BUDGET) == 2
        assert p.blocks == 2 and not p.fused
        for field in ("tri_p1", "tri_e1", "tri_e2", "cluster_aabb"):
            assert np.array_equal(getattr(scene, field).numpy(),
                                  np.asarray(getattr(js, field))), field
    teapot = _compile(REGISTRY["teapot"](16)[0])
    assert integrator.plan(teapot, RenderConfig(), "cuda", torch.float32).fused


@pytest.fixture(scope="module")
def herd_colors(herds):
    """color_at of each one-mesh herd through the port's streamed kernel
    branch (forced on the CPU: the wrappers run their plain versions), with
    every mesh wrapper counted, and rtc_tpu's interpret-mode color_at on the
    same tables and rays (its streamed K1/K2 in interpret mode)."""
    out = {}
    names = ("mesh_closest_hit", "mesh_closest_hit_uv", "mesh_closest_hit_sn",
             "mesh_any_hit", "mesh_closest_shadow", "mesh_closest_shadow_sn",
             "mesh_crossing_count", "mesh_closest_hit_elementwise",
             "mesh_any_hit_elementwise", "closest_hit_blocked", "any_hit_blocked",
             "crossing_count_blocked")
    for kind, (js, scene, o, d) in herds.items():
        calls = dict.fromkeys(names, 0)

        def spy(name, fn):
            def wrapped(*args, **kwargs):
                calls[name] += 1
                return fn(*args, **kwargs)
            return wrapped

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(integrator, "mesh_impl_for", lambda *a: "kernel")
            for name in names:
                mp.setattr(mi, name, spy(name, getattr(mi, name)))
            got = integrator.color_at(scene, torch.from_numpy(o),
                                      torch.from_numpy(d), RenderConfig())
        ref = np.asarray(jax_integrator.color_at(
            js, o, d, JaxRenderConfig(dtype="float32",
                                      mesh_impl="mxu_interpret")))
        out[kind] = got.numpy(), ref, calls
    return out


@pytest.mark.parametrize("kind", ["flat", "smooth"])
def test_one_mesh_herd_color_at_matches_rtc_tpu(herd_colors, kind):
    """The streamed branch against rtc_tpu's: the 99.9th-percentile error
    below 2e-3 and at most 2 pixels above 0.05 (rtc_tpu's smooth-normal
    knife-edge budget, test_tlas_smooth_color_parity)."""
    got, ref, _ = herd_colors[kind]
    assert got.max() > 0.1
    err = np.abs(got - ref).max(axis=1)
    assert np.quantile(err, 0.999) < 2e-3 and (err > 0.05).sum() <= 2


@pytest.mark.parametrize("kind", ["flat", "smooth"])
def test_one_mesh_herd_streams(herd_colors, kind):
    """One node (the herd is not reflective): the integrator calls the
    closest-hit driver and K2's once each, and each driver calls its
    wrapper (K1 with_n flat, K1 with_uv smooth; K2) once per block; no
    fused kernel."""
    _, _, calls = herd_colors[kind]
    closest = "mesh_closest_hit_uv" if kind == "smooth" else "mesh_closest_hit"
    want = dict.fromkeys(calls, 0)
    want.update({"closest_hit_blocked": 1, closest: 2, "any_hit_blocked": 1,
                 "mesh_any_hit": 2})
    assert calls == want
