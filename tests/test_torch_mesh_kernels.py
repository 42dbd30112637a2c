"""The plain PyTorch versions of K1-K3 against rtc_tpu's Pallas kernels
(interpret mode on the CPU), on identical tables and rays; and the
wrappers' CPU behaviour. The CUDA kernels themselves are held against
these plain versions on the GPU (tests/test_torch_cuda.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rtc_tpu.models.scenes import REGISTRY as JAX_REGISTRY
from rtc_tpu.ops.pallas.mesh_intersect import (mesh_any_hit_mxu,
                                               mesh_closest_hit_mxu,
                                               mesh_closest_shadow_mxu)
from rtc_tpu.render.camera import camera_rays as jax_camera_rays
from rtc_tpu.scene.compile import compile_scene as jax_compile_scene
from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
from rtc_tpu_torch.scene.compile import TENSOR_FIELDS, scene_from_numpy
from rtc_tpu_torch.utils.constants import BIG

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def cow():
    """rtc_tpu's f32 cow tables and 64x32 camera rays, as numpy, and the
    port's scene built from the same tables."""
    world, cam = JAX_REGISTRY["cow"](64)
    js = jax_compile_scene(world, dtype=np.float32)
    dt = jnp.float32
    o, d = jax_camera_rays(jnp.asarray(cam.transform_inverse, dt), cam.hsize,
                           cam.vsize, jnp.asarray(cam.half_width, dt),
                           jnp.asarray(cam.half_height, dt),
                           jnp.asarray(cam.pixel_size, dt), dt)
    arrays = {f: np.asarray(getattr(js, f)) for f in TENSOR_FIELDS}
    scene = scene_from_numpy(arrays, js.static._asdict(), device="cpu")
    return js, scene, np.asarray(o), np.asarray(d)


def _tables(scene):
    return scene.tri_p1, scene.tri_e1, scene.tri_e2


def _jax_tables(js):
    return js.tri_p1, js.tri_e1, js.tri_e2


def _assert_closest_parity(t, idx, n, jt, jidx, jn):
    """Equal hit masks; t within rtol 1e-5 / atol 1e-6; idx equal on >= 99%
    of hits, mismatches only at ties; n within 1e-6 where idx agrees."""
    t, idx, n = t.numpy(), idx.numpy(), n.numpy()
    jt, jidx, jn = map(np.asarray, (jt, jidx, jn))
    hit, jhit = idx >= 0, jidx >= 0
    np.testing.assert_array_equal(hit, jhit)
    np.testing.assert_array_equal(hit, t < BIG / 2)
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-5, atol=1e-6)
    same = idx == jidx
    assert same[hit].mean() >= 0.99
    tie = hit & ~same
    assert (np.abs(t - jt)[tie] <= 1e-6).all()
    np.testing.assert_allclose(n[same & hit], jn[same & hit], rtol=0, atol=1e-6)
    assert (n[~hit] == 0).all() and (t[~hit] == np.float32(BIG)).all()
    return hit


def test_k1_plain_matches_rtc_tpu(cow):
    js, scene, o, d = cow
    t, idx, n = mi.closest_hit_plain(torch.from_numpy(o), torch.from_numpy(d),
                                     *_tables(scene), scene.tri_n)
    jt, jidx, jn = mesh_closest_hit_mxu(
        o, d, *_jax_tables(js), js.cluster_aabb, js.super_aabb,
        n_super=js.static.n_super, leaf=js.static.cluster_size,
        interpret=True, tri_n=js.tri_n)
    hit = _assert_closest_parity(t, idx, n, jt, jidx, jn)
    assert hit.sum() > 200  # the cow covers about a seventh of the frame


def test_k2_plain_matches_rtc_tpu(cow):
    """Occlusion from free-space points halfway to each hit, toward the
    light (on-surface origins are self-intersection knife edges); and from
    the light toward each hit, stopping 0.05 short of the surface, where
    the cow's near side occludes its far side."""
    js, scene, o, d = cow
    t, idx, _ = mi.closest_hit_plain(torch.from_numpy(o), torch.from_numpy(d),
                                     *_tables(scene), scene.tri_n)
    hit = (idx >= 0).numpy()
    t = t.numpy()
    light = np.asarray(js.light_pos)[None, :]
    point = o + d * np.where(hit, t * 0.5, 1.0)[:, None]
    target = o + d * np.where(hit, t, 1.0)[:, None]
    v = np.concatenate([light - point, target - light])
    dist = np.sqrt((v * v).sum(axis=1)).astype(np.float32)
    direction = (v / dist[:, None]).astype(np.float32)
    live = np.concatenate([hit, hit])
    margin = np.r_[np.zeros_like(t), np.full_like(t, 0.05)]
    max_t = np.where(live, dist - margin, -1.0).astype(np.float32)
    origin = np.concatenate([point, np.broadcast_to(light, point.shape)]
                            ).astype(np.float32)
    occ = mi.any_hit_plain(torch.from_numpy(origin), torch.from_numpy(direction),
                           torch.from_numpy(max_t), *_tables(scene)).numpy()
    jocc = np.asarray(mesh_any_hit_mxu(
        origin, direction, max_t, *_jax_tables(js), js.cluster_aabb,
        js.super_aabb, n_super=js.static.n_super, leaf=js.static.cluster_size,
        interpret=True))
    assert not occ[~live].any()  # dead lanes never hit
    assert occ.sum() > 20
    R = len(origin)
    assert int((occ != jocc).sum()) <= max(2, R // 2048)


def test_k3_plain_matches_rtc_tpu(cow):
    js, scene, o, d = cow
    t, idx, n, sh = mi.closest_shadow_plain(
        torch.from_numpy(o), torch.from_numpy(d), *_tables(scene),
        scene.tri_n, scene.light_pos)
    jt, jidx, jn, jsh = mesh_closest_shadow_mxu(
        o, d, *_jax_tables(js), js.tri_n, js.cluster_aabb, js.light_pos,
        leaf=js.static.cluster_size, interpret=True)
    hit = _assert_closest_parity(t, idx, n, jt, jidx, jn)
    assert sh.numpy().sum() > 5
    assert not sh.numpy()[~hit].any()
    assert int((sh.numpy() != np.asarray(jsh)).sum()) <= max(2, hit.sum() // 1000)


def test_wrappers_take_plain_versions_on_cpu(cow):
    """On CPU tensors each wrapper returns its plain version's result and
    launches nothing."""
    _, scene, o, d = cow
    o, d = torch.from_numpy(o[::7]), torch.from_numpy(d[::7])
    leaf = scene.static.cluster_size
    mi.reset_launch_counts()
    got = mi.mesh_closest_hit(o, d, *_tables(scene), scene.tri_n,
                              scene.cluster_aabb, leaf)
    ref = mi.closest_hit_plain(o, d, *_tables(scene), scene.tri_n)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    max_t = torch.where(got[1] >= 0, got[0] * 0.5, -1.0)
    assert torch.equal(
        mi.mesh_any_hit(o, d, max_t, *_tables(scene), scene.cluster_aabb, leaf),
        mi.any_hit_plain(o, d, max_t, *_tables(scene)))
    got = mi.mesh_closest_shadow(o, d, *_tables(scene), scene.tri_n,
                                 scene.cluster_aabb, scene.light_pos, leaf)
    ref = mi.closest_shadow_plain(o, d, *_tables(scene), scene.tri_n,
                                  scene.light_pos)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert mi.LAUNCHES == dict.fromkeys(mi.LAUNCHES, 0)


def test_shadow_rays_park_misses_and_kill_back_faces():
    """Phase 2 on hand-made hits: a miss is parked at 1e12 and dead; a hit
    facing away from the light is dead; a facing hit gets the unit
    direction to the light and the distance as its bound."""
    o = torch.zeros((3, 3))
    d = torch.tensor([[0.0, 0.0, 1.0]] * 3)
    t = torch.tensor([BIG, 2.0, 2.0])
    idx = torch.tensor([-1, 5, 6], dtype=torch.int32)
    n = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    light = torch.tensor([0.0, 0.0, -8.0])
    so, sd, max_t = mi.shadow_rays_plain(o, d, t, idx, n, light, 1e-5)
    assert (so[0] == 1e12).all() and max_t[0] == -1.0
    # ray 1 hits from the back (n along d): the flip makes it face the eye,
    # and the light sits on the eye's side
    assert max_t[1] > 0 and torch.allclose(sd[1], torch.tensor([0.0, 0.0, -1.0]))
    assert torch.allclose(so[1], torch.tensor([0.0, 0.0, 2.0 - 1e-5]))
    assert max_t[2] > 0
    light_behind = torch.tensor([0.0, 0.0, 8.0])
    _, _, max_t = mi.shadow_rays_plain(o, d, t, idx, n, light_behind, 1e-5)
    assert (max_t == -1.0).all()


def test_smooth_blend_weights_the_corners():
    """K1 with_sn's payload on one triangle p1 (0,1,0), p2 (-1,0,0),
    p3 (1,0,0): at each corner the blend is that corner's normal, at
    u = 0.45, v = 0.25 it is (1-u-v) sn1 + u sn2 + v sn3 unnormalized, and
    a miss gets zeros."""
    p1 = torch.tensor([[0.0, 1.0, 0.0]], dtype=torch.float64)
    e1 = torch.tensor([[-1.0, -1.0, 0.0]], dtype=torch.float64)
    e2 = torch.tensor([[1.0, -1.0, 0.0]], dtype=torch.float64)
    sn = torch.tensor([[0.0, 1.0, 0.0, -1.0, 0.0, 0.0, 1.0, 0.0, 0.0]],
                      dtype=torch.float64)
    u, v = 0.45, 0.25
    o = torch.tensor([[0.0, 1.0, -2.0], [-1.0, 0.0, -2.0], [1.0, 0.0, -2.0],
                      [-u + v, 1 - u - v, -2.0], [5.0, 5.0, -2.0]],
                     dtype=torch.float64)
    d = torch.tensor([[0.0, 0.0, 1.0]] * 5, dtype=torch.float64)
    t, idx, n = mi.closest_hit_sn_plain(o, d, p1, e1, e2, sn)
    assert idx.tolist() == [0, 0, 0, 0, -1] and float(t[4]) == BIG
    want = [[0, 1, 0], [-1, 0, 0], [1, 0, 0], [-u + v, 1 - u - v, 0], [0, 0, 0]]
    np.testing.assert_allclose(n.numpy(), want, atol=1e-12)
    # K3 with_sn's shadow ray uses the normalized blend, its n stays raw
    light = torch.tensor([0.0, 0.0, -8.0], dtype=torch.float64)
    t3, idx3, n3, sh = mi.closest_shadow_sn_plain(o, d, p1, e1, e2, sn, light)
    assert torch.equal(n3, n) and not sh.any()
    unit = torch.nn.functional.normalize(n, dim=1)
    for a, b in zip(mi.shadow_rays_plain(o, d, t, idx, n, light, unit_n=False),
                    mi.shadow_rays_plain(o, d, t, idx, unit, light)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


def test_census_wrapper_takes_plain_version_on_cpu(cow):
    """mesh_crossing_count on CPU tensors is crossing_count_plain, with
    the cow's triangles split into two container slots by parity of id,
    on the whole line of each ray (t_hit = BIG) but its own hit."""
    _, scene, o, d = cow
    o, d = torch.from_numpy(o[::5]), torch.from_numpy(d[::5])
    cid = (torch.arange(scene.tri_cid.shape[0]) % 2).to(torch.int32)
    cid[scene.tri_e1.abs().sum(1) == 0] = -1  # padding rows hold no slot
    t, idx, _ = mi.closest_hit_plain(o, d, *_tables(scene), scene.tri_n)
    gid = torch.where(idx >= 0, idx, -2)
    t_hit = torch.full_like(t, BIG)
    mi.reset_launch_counts()
    got = mi.mesh_crossing_count(o, d, t_hit, gid, *_tables(scene),
                                 scene.cluster_aabb, cid, 2,
                                 scene.static.cluster_size)
    ref = mi.crossing_count_plain(o, d, t_hit, gid, *_tables(scene), cid, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert int(got[0].sum()) > 50 and (got[0][:, 0] != got[0][:, 1]).any()
    assert mi.LAUNCHES == dict.fromkeys(mi.LAUNCHES, 0)
