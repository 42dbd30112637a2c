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
from rtc_tpu_torch.scene import compile as compile_mod
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
        mp.setattr(integrator, "mesh_impl_for", lambda *a: "elementwise")
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
    f32 = torch.float32
    p = integrator.plan(scene, RenderConfig(mesh_impl="elementwise"), "cuda", f32)
    assert scene.static.tlas_n_inst
    assert p.impl == "elementwise" and not p.tlas and not p.fused
    assert integrator.plan(scene, RenderConfig(), "cuda", f32).tlas


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


# --- K7's tile walk, replayed in PyTorch -------------------------------------
#
# csrc/mesh_intersect.cu elementwise_kernel, step by step on CPU tensors: per
# tile of ELEMENTWISE_TILE rays, a block vote per super and per cluster of an
# entered super, on each lane's own bound (K7a's running t_best, K7b's max_t
# on a live lane not yet found); the copy of the next cluster that passes
# the vote made before the tested cluster's results are in, voted on again
# after them and dropped when no lane enters it; the listed lanes' rows in
# rounds of 32 lanes, lane l holding rows l, l + 32, ...; K7a's lane-local
# strict < and the warp's lexicographic (t, row) min (the least of t's
# bits with the sign cleared, then the least row at it, then that row's t),
# then t_best by a strict < across clusters; K7b's stop after the
# round that finds an occluder, and the tile's exit once every lane is
# found or dead.

WARP = 32
NO_ROW = 2**31 - 1


def tile_walk(o, d, p1, e1, e2, aabb, sup, leaf, eps=1e-5, max_t=None,
              tile=mi.ELEMENTWISE_TILE, lane_min=mi.ELEMENTWISE_LANE_MIN):
    """K7a's (t, idx), or with max_t K7b's flags, by the tile walk; and its
    tallies: {"tested": clusters tested a tile, "staged", "dropped",
    "rounds", "by_lane"} (copies started, copies dropped, 32-row rounds run
    a warp a ray, clusters tested a lane a ray: those whose entered lanes
    number at least lane_min times the warps holding any)."""
    R, C = o.shape[0], aabb.shape[0]
    any_hit = max_t is not None
    ent_s = mi.box_entries(o, d, sup)                     # (R, S)
    ent_c = mi.box_entries(o, d, aabb)                    # (R, C)
    t_all, ok_all = mi._pair_tests(o, d, p1, e1, e2, eps)  # (R, T)
    ok_all = ok_all & (t_all >= 0.0)
    n_rounds = -(-leaf // WARP)
    pad = n_rounds * WARP - leaf
    t_out = torch.full((R,), BIG, dtype=o.dtype)
    idx_out = torch.full((R,), -1, dtype=torch.int32)
    hit_out = torch.zeros((R,), dtype=torch.bool)
    stats = {"tested": [], "staged": 0, "dropped": 0, "rounds": 0, "by_lane": 0}
    for a in range(0, R, tile):
        lanes = torch.arange(a, min(a + tile, R))
        if any_hit:
            mt = max_t[lanes]
            bound = torch.where(mt > 0, mt, torch.full_like(mt, -1.0))
        else:
            bound = torch.full((lanes.numel(),), BIG, dtype=o.dtype)
        best = torch.full((lanes.numel(),), -1, dtype=torch.int64)
        found = torch.zeros((lanes.numel(),), dtype=torch.bool)
        state = {"s": -1, "in": torch.zeros_like(found)}

        def scan(c):
            while c < C:
                s = c // mi.SUPER_WIDTH
                if s != state["s"]:
                    state["s"] = s
                    state["in"] = (bound > 0) & (ent_s[lanes, s] < bound)
                    if not state["in"].any():
                        c = (s + 1) * mi.SUPER_WIDTH
                        continue
                e = torch.where(state["in"] & (bound > 0), ent_c[lanes, c], BIG)
                if (e < bound).any():
                    return c, e
                c += 1
            return C, None

        tested = 0
        cur, e_cur = (scan(0) if not any_hit or (bound > 0).any() else (C, None))
        stats["staged"] += cur < C
        while cur < C:
            mine = e_cur < bound
            if not mine.any():
                stats["dropped"] += 1
                cur, e_cur = scan(cur + 1)
                stats["staged"] += cur < C
                continue
            nxt, e_next = scan(cur + 1)
            stats["staged"] += nxt < C
            q = mine.nonzero()[:, 0]                        # the list
            rows = cur * leaf + torch.arange(leaf)
            t = torch.nn.functional.pad(t_all[lanes[q]][:, rows], (0, pad))
            ok = torch.nn.functional.pad(ok_all[lanes[q]][:, rows], (0, pad))
            warps = (q // WARP).unique().numel()
            if q.numel() >= lane_min * warps:
                # a lane a ray: its rows in order, a strict < (K7a), the
                # first occluder (K7b)
                stats["by_lane"] += 1
                tt = t[:, :leaf]
                okb = ok[:, :leaf] & (tt < bound[q, None])
                if any_hit:
                    hit = okb.any(1)
                    bound[q[hit]] = -1.0
                    found[q[hit]] = True
                else:
                    tt = torch.where(okb, tt, BIG)
                    j = tt.argmin(1)        # the first row at the least t
                    won = okb.any(1)
                    bound[q[won]] = tt[won, j[won]]
                    best[q[won]] = cur * leaf + j[won]
                tested += 1
                if any_hit and not (bound > 0).any():
                    break
                cur, e_cur = nxt, e_next
                continue
            t = t.view(-1, n_rounds, WARP)
            ok = ok.view(-1, n_rounds, WARP)
            if any_hit:
                ok = ok & (t < bound[q, None, None])
                live = torch.ones((q.numel(),), dtype=torch.bool)
                hit = torch.zeros_like(live)
                for k in range(n_rounds):
                    stats["rounds"] += int(live.sum())
                    hit |= live & ok[:, k].any(1)
                    live &= ~hit
                bound[q[hit]] = -1.0
                found[q[hit]] = True
            else:
                bt = bound[q, None].expand(-1, WARP).clone()
                bj = torch.full(bt.shape, NO_ROW, dtype=torch.int64)
                col = torch.arange(WARP)
                for k in range(n_rounds):
                    stats["rounds"] += q.numel()
                    better = ok[:, k] & (t[:, k] < bt)
                    bt = torch.where(better, t[:, k], bt)
                    bj = torch.where(better, k * WARP + col, bj)
                # the warp's least key (t's bits, sign cleared), the least
                # row at that key, and t from the lane holding that row
                key = torch.where(bj == NO_ROW, 2**32 - 1,
                                  bt.view(torch.int32).long() & 0x7FFFFFFF)
                least = key.amin(1, keepdim=True)
                row = torch.where(key == least, bj, 2**32 - 1).amin(1)
                won = least[:, 0] != 2**32 - 1
                t_row = bt.gather(1, (row % WARP)[:, None])[:, 0]
                bound[q[won]] = t_row[won]
                best[q[won]] = cur * leaf + row[won]
            tested += 1
            if any_hit and not (bound > 0).any():
                break
            cur, e_cur = nxt, e_next
        stats["tested"].append(tested)
        if any_hit:
            hit_out[lanes] = found
        else:
            t_out[lanes] = bound
            idx_out[lanes] = best.to(torch.int32)
    return (hit_out if any_hit else (t_out, idx_out)), stats


def k7_tables(p1, e1, e2, leaf):
    """K7's tables of rows p1, e1, e2 (T, 3) f32 in the order given: clusters
    of leaf rows, padded with zero rows to a multiple of SUPER_WIDTH
    clusters, their boxes and the supers' union boxes (compile.py's, in
    f64 from the rows, then f32; empty boxes for padding)."""
    T = p1.shape[0]
    n_clusters = -(-T // leaf)
    C = -(-n_clusters // mi.SUPER_WIDTH) * mi.SUPER_WIDTH
    rows = [np.concatenate([x, np.zeros((C * leaf - T, 3), np.float32)])
            for x in (p1, e1, e2)]
    aabb = compile_mod._empty_boxes(C)
    for c in range(n_clusters):
        s = slice(c * leaf, min((c + 1) * leaf, T))
        a, b, e = (x[s].astype(np.float64) for x in (p1, e1, e2))
        verts = np.concatenate([a, a + b, a + e])
        aabb[c, :3], aabb[c, 3:] = verts.min(0), verts.max(0)
    sup = compile_mod._group_boxes(aabb)
    f32 = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return [f32(x) for x in rows] + [f32(aabb), f32(sup)]


def occlusion_queries(o, d, t, idx, light):
    """Free-space occlusion rays (chip_smoke.py occlusion_rays): from halfway
    to each hit toward the light, and from the light toward each hit,
    stopping 0.05 short of it; misses are dead lanes."""
    hit = idx >= 0
    t_safe = torch.where(hit, t, 1.0)[:, None]
    half, target = o + d * (t_safe * 0.5), o + d * t_safe
    v = torch.cat([light[None] - half, target - light[None]])
    dist = torch.sqrt((v * v).sum(1))
    margin = torch.cat([torch.zeros_like(t), torch.full_like(t, 0.05)])
    max_t = torch.where(torch.cat([hit, hit]), dist - margin, -1.0)
    origin = torch.cat([half, light[None].expand_as(target)])
    return origin.contiguous(), (v / dist[:, None]).contiguous(), max_t.contiguous()


def scene_wavefront(name, width, n_rays):
    """The port's f32 scene at width, its first n_rays camera rays (a
    ragged last tile unless n_rays is a multiple of the tile) and K7's
    tables."""
    world, cam = REGISTRY[name](width)
    scene = _compile(world)
    from rtc_tpu_torch.render.camera import camera_rays
    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize,
                       cam.half_width, cam.half_height, cam.pixel_size)
    tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2, scene.cluster_aabb,
            scene.super_aabb)
    return scene, o[:n_rays].contiguous(), d[:n_rays].contiguous(), tabs


def _assert_k7a(o, d, tabs, leaf):
    """K7a's tile walk against _closest_plain, bit for bit. Returns the
    walk's tallies."""
    (t, idx), stats = tile_walk(o, d, *tabs, leaf)
    pt, pidx = mi._closest_plain(o, d, *tabs[:3], 1e-5)
    assert torch.equal(t, pt) and torch.equal(idx, pidx)
    return stats


def _assert_k7b(o, d, max_t, tabs, leaf):
    """K7b's tile walk against any_hit_plain, bit for bit, no dead lane
    occluded. Returns the walk's tallies."""
    hit, stats = tile_walk(o, d, *tabs, leaf, max_t=max_t)
    assert torch.equal(hit, mi.any_hit_plain(o, d, max_t, *tabs[:3]))
    assert not hit[~(max_t > 0)].any()
    return stats


def _assert_k7_equal(o, d, tabs, leaf, max_t):
    return _assert_k7a(o, d, tabs, leaf), _assert_k7b(o, d, max_t, tabs, leaf)


@pytest.mark.parametrize("name", ["teapot", "cow"])
def test_tile_walk_equals_plain_on_a_ragged_wavefront(name):
    """Width 32: 475 camera rays (a full tile and a ragged one of 219).
    K7a's replay equals _closest_plain bit for bit; K7b's, on their 950
    free-space occlusion rays (three tiles and a ragged one) with every 5th
    lane dead (max_t -1, 0 and NaN in turn), equals any_hit_plain."""
    scene, o, d, tabs = scene_wavefront(name, 32, 475)
    leaf = scene.static.cluster_size
    t, idx = mi._closest_plain(o, d, *tabs[:3], 1e-5)
    qo, qd, qmax = occlusion_queries(o, d, t, idx, scene.light_pos)
    qmax[::5] = torch.tensor([-1.0, 0.0, float("nan")]).repeat(190)[:qmax[::5].numel()]
    st_a = _assert_k7a(o, d, tabs, leaf)
    st_b = _assert_k7b(qo, qd, qmax, tabs, leaf)
    assert len(st_a["tested"]) == 2 and min(st_a["tested"]) > 0
    assert len(st_b["tested"]) == 4 and st_b["rounds"] > 0
    assert int((idx >= 0).sum()) > 50


def test_tile_walk_matches_rtc_tpu_pallas(teapot32):
    """The replay against rtc_tpu's interpret-mode kernels on teapot's
    32-px wavefront, with test_k7a_plain_matches_rtc_tpu_pallas's and
    test_k7b_plain_matches_rtc_tpu_pallas's gates."""
    js, scene, o, d = teapot32
    st = js.static
    leaf = scene.static.cluster_size
    tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2, scene.cluster_aabb,
            scene.super_aabb)
    ot, od = torch.from_numpy(o), torch.from_numpy(d)
    t_r, i_r = (np.asarray(x) for x in mesh_closest_hit_pallas(
        o, d, js.tri_p1, js.tri_e1, js.tri_e2, js.cluster_aabb, js.super_aabb,
        n_super=st.n_super, leaf=st.cluster_size, interpret=True))
    (t, idx), _ = tile_walk(ot, od, *tabs, leaf)
    t, idx = t.numpy(), idx.numpy()
    hit = idx >= 0
    np.testing.assert_array_equal(hit, i_r >= 0)
    assert 100 < hit.sum() < len(hit)
    np.testing.assert_allclose(t[hit], t_r[hit], rtol=1e-5, atol=1e-6)
    assert (t[~hit] == np.float32(BIG)).all()
    assert (idx[hit] == i_r[hit]).mean() > 0.99

    # test_k7b_plain_matches_rtc_tpu_pallas's query: shadow rays from the
    # primary hit points toward the light, max_t their distance
    pts = o + d * np.where(hit, t, 1.0)[:, None]
    v = np.asarray(js.light_pos, np.float32)[None] - pts
    dist = np.sqrt((v * v).sum(1)).astype(np.float32)
    sd = (v / dist[:, None]).astype(np.float32)
    max_t = np.where(hit, dist, -1.0).astype(np.float32)
    ref = np.asarray(mesh_any_hit_pallas(
        pts, sd, max_t, js.tri_p1, js.tri_e1, js.tri_e2, js.cluster_aabb,
        js.super_aabb, n_super=st.n_super, leaf=st.cluster_size, interpret=True))
    got, _ = tile_walk(torch.from_numpy(pts), torch.from_numpy(sd), *tabs, leaf,
                       max_t=torch.from_numpy(max_t))
    got = got.numpy()
    assert not got[~hit].any() and not ref[~hit].any()
    assert 10 < got.sum() < hit.sum()
    assert (got == ref)[hit].mean() > 0.995


def test_tile_walk_tile_that_enters_nothing():
    """cow at 32 px with the first tile's rays turned around (they leave the
    mesh behind): that tile stages and tests no cluster and reports misses
    and no occlusion; the second tile walks as before; both equal plain."""
    scene, o, d, tabs = scene_wavefront("cow", 32, 512)
    leaf = scene.static.cluster_size
    o = o.clone()
    d = d.clone()
    tile = mi.ELEMENTWISE_TILE
    o[:tile] = o[:tile] - d[:tile] * 1e3
    d[:tile] = -d[:tile]
    max_t = torch.full((512,), 1e4)
    st_a, st_b = _assert_k7_equal(o, d, tabs, leaf, max_t)
    assert st_a["tested"][0] == 0 and st_b["tested"][0] == 0
    assert st_a["tested"][1] > 0
    (t, idx), _ = tile_walk(o, d, *tabs, leaf)
    assert (idx[:tile] == -1).all() and (t[:tile] == BIG).all()
    assert (idx[tile:] >= 0).any()


def test_tile_walk_dead_and_all_found_tiles():
    """K7b: a tile of dead lanes only (max_t -1, 0, NaN) walks nothing; a
    tile whose every live lane is occluded by its first cluster leaves its
    walk there (the all-found exit), with the flags of any_hit_plain."""
    scene, o, d, tabs = scene_wavefront("teapot", 32, 512)
    leaf = scene.static.cluster_size
    tile = mi.ELEMENTWISE_TILE
    t, idx = mi._closest_plain(o, d, *tabs[:3], 1e-5)
    hit = idx >= 0
    max_t = torch.where(hit, t * 2.0, -1.0)      # every hit ray is occluded
    max_t[:tile] = torch.tensor([-1.0, 0.0, float("nan")]).repeat(tile)[:tile]
    flags, st = tile_walk(o, d, *tabs, leaf, max_t=max_t)
    assert torch.equal(flags, mi.any_hit_plain(o, d, max_t, *tabs[:3]))
    assert st["tested"][0] == 0
    assert torch.equal(flags[tile:], hit[tile:]) and flags[tile:].any()
    # without the found lanes' exit the tile would test every cluster one of
    # its live lanes enters before its max_t
    entered = mi.box_entries(o[tile:], d[tile:], tabs[3]) < max_t[tile:, None]
    assert 0 < st["tested"][1] < int(entered.any(0).sum())


def _soup_rows(rng, n, spread=2.0, size=0.6):
    c = rng.uniform(-spread, spread, (n, 3))
    v = [c + rng.normal(0.0, size, (n, 3)) for _ in range(3)]
    return [x.astype(np.float32) for x in (v[0], v[1] - v[0], v[2] - v[0])]


def _soup_rays(rng, n):
    origin = rng.normal(size=(n, 3))
    origin *= 8.0 / np.linalg.norm(origin, axis=1, keepdims=True)
    d = rng.uniform(-1.5, 1.5, (n, 3)) - origin
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(origin.astype(np.float32)),
            torch.from_numpy(d.astype(np.float32)))


@pytest.mark.parametrize("leaf", [48, 100, 7])
def test_tile_walk_leaf_not_a_multiple_of_32(leaf):
    """A 700-triangle soup in clusters of 48, 100 and 7 rows (the last
    round's tail lanes hold no row), 300 rays: K7a and K7b (a third of the
    lanes dead) equal plain bit for bit."""
    rng = np.random.default_rng(leaf)
    p1, e1, e2 = _soup_rows(rng, 700)
    tabs = k7_tables(p1, e1, e2, leaf)
    o, d = _soup_rays(rng, 300)
    max_t = torch.full((300,), 8.0)
    max_t[::3] = -1.0
    st_a, st_b = _assert_k7_equal(o, d, tabs, leaf, max_t)
    assert sum(st_a["tested"]) > 0 and st_b["rounds"] > 0


def test_tile_walk_duplicate_rows_tie_to_the_earliest():
    """Every triangle four times: rows j and j + 1 (another lane of the same
    round), j + 32 (the same lane, a round later) and the same rows one
    cluster later. K7a's replay gives the earliest copy, as the plain sweep,
    on every hit; K7b equals plain."""
    rng = np.random.default_rng(21)
    leaf = 128
    rows = []
    for x in _soup_rows(rng, 16, spread=1.0, size=1.0):
        pair = np.repeat(x, 2, axis=0)          # rows 2m, 2m + 1: lanes side by side
        block = np.tile(pair, (leaf // 32, 1))  # again each round, on the same lanes
        rows.append(np.tile(block, (2, 1)))     # and in the next cluster
    tabs = k7_tables(*rows, leaf)
    o, d = _soup_rays(rng, 400)
    _assert_k7_equal(o, d, tabs, leaf, torch.full((400,), 20.0))
    (t, idx), _ = tile_walk(o, d, *tabs, leaf)
    hit = idx >= 0
    assert int(hit.sum()) > 20
    p1 = tabs[0]
    first = torch.tensor([int((p1 == p1[i]).all(1).nonzero()[0]) for i in idx[hit].tolist()])
    assert torch.equal(idx[hit].long(), first)


@pytest.mark.parametrize("name", ["teapot", "cow"])
def test_tile_walk_dense_and_sparse_tiles(name):
    """A tile of rays that all aim at the mesh's middle from one side (every
    lane enters the same clusters: they go a lane a ray) and a ragged tile
    of rays aimed around it (few lanes a cluster: a warp a ray). K7a equals
    _closest_plain and K7b (max_t past the middle; dead lanes: every 3rd of
    the second tile, three of the first) any_hit_plain, bit for bit, with
    both mappings in the walk."""
    scene, _, _, tabs = scene_wavefront(name, 8, 0)
    leaf = scene.static.cluster_size
    box = scene.cluster_aabb[:scene.static.n_clusters]
    real = box[:, 0] <= box[:, 3]
    lo, hi = box[real, :3].amin(0), box[real, 3:].amax(0)
    mid, size = (lo + hi) / 2, float((hi - lo).amax())
    rng = np.random.default_rng(31)
    n = mi.ELEMENTWISE_TILE + 150
    spread = np.where(np.arange(n)[:, None] < mi.ELEMENTWISE_TILE, 0.002, 0.6) * size
    target = mid.numpy() + rng.normal(0.0, 1.0, (n, 3)) * spread
    o = np.broadcast_to(mid.numpy() + np.array([0.3, 0.2, -3.0]) * size, (n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = (torch.tensor(x, dtype=torch.float32) for x in (o, d))
    st_a = _assert_k7a(o, d, tabs, leaf)
    max_t = torch.full((n,), 3.0 * size)
    max_t[mi.ELEMENTWISE_TILE::3] = -1.0
    max_t[:4] = torch.tensor([-1.0, 0.0, float("nan"), 1e-3])
    st_b = _assert_k7b(o, d, max_t, tabs, leaf)
    for st in (st_a, st_b):
        assert st["by_lane"] > 0 and st["rounds"] > 0
