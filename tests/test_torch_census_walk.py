"""The walks of K2 (the occlusion walk, over a whole table or one streamed
superblock's cluster range) and of K4 (the census walk, a signed box test)
over the occlusion tables (rtc_tpu_torch/scene/compile.py
OcclusionTables), on glass_teapot at width 32 in plain PyTorch with
box_slabs' arithmetic:

- the census fields: each packed row's table row and container slot, and
  the clusters and groups that hold a container row, on the scene's device,
  and the slots they were built from;
- the slab arithmetic pair by pair equals box_slabs' dense interval;
- the signed cull never drops a crossing, negative t included, at any level;
- a walk over a cluster range whose ends fall inside a group keeps every
  hitting row of the range;
- the empty box the signed test can enter reaches only padding rows;
- a replay of each walk equals the plain sweep bit for bit
  (any_hit_plain, crossing_count_plain), and on one small wavefront
  rtc_tpu's interpret-mode K2 and K4 within rtc_tpu's own gate.

The CUDA kernels are held to the plain versions on the GPU
(tests/test_torch_cuda.py, chip_smoke.py).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_census_walk.py -q
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rtc_tpu.models.scenes import REGISTRY as JAX_REGISTRY
from rtc_tpu.ops.pallas.mesh_intersect import (mesh_any_hit_mxu,
                                               mesh_crossing_count_mxu)
from rtc_tpu.render.camera import camera_rays as jax_camera_rays
from rtc_tpu.scene.compile import compile_scene as jax_compile_scene
from rtc_tpu_torch.models.scenes import REGISTRY, cow_herd_world
from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
from rtc_tpu_torch.scene.compile import (EMPTY_BOX, GROUP, compile_scene,
                                        occlusion_tables)
from rtc_tpu_torch.utils.constants import BIG

torch.set_num_threads(2)

EPS = 1e-5


@pytest.fixture(scope="module")
def glass():
    """rtc_tpu's f32 glass_teapot tables and width-32 camera rays (numpy),
    and the port's own compile of the scene (its tables equal rtc_tpu's
    element for element, tests/test_torch_compile.py)."""
    world, cam = JAX_REGISTRY["glass_teapot"](32)
    js = jax_compile_scene(world, dtype=np.float32)
    dt = jnp.float32
    o, d = jax_camera_rays(jnp.asarray(cam.transform_inverse, dt), cam.hsize,
                           cam.vsize, jnp.asarray(cam.half_width, dt),
                           jnp.asarray(cam.half_height, dt),
                           jnp.asarray(cam.pixel_size, dt), dt)
    scene = compile_scene(REGISTRY["glass_teapot"](32)[0], device="cpu")
    return js, scene, np.asarray(o), np.asarray(d)


def _census_inputs(scene, o, d):
    """{kind: (o, d, t_hit, hit_gid)}: the primary rays with their hits as
    bounds and their hit rows (dead lanes at -BIG where they miss), as the
    root node's census takes them; the same rays with t_hit = BIG and their
    hit row excluded, so every later crossing along the line counts; and,
    as chip_smoke.py builds them, the rays re-seated 1e-3 past their hit
    with t_hit = BIG and no hit row, so crossings behind the origin count."""
    o, d = torch.from_numpy(o.copy()), torch.from_numpy(d.copy())
    t, idx = mi._closest_plain(o, d, scene.tri_p1, scene.tri_e1, scene.tri_e2, EPS)
    hit = idx >= 0
    gid = torch.where(hit, idx, -2).to(torch.int32)
    o2 = o + d * (torch.where(hit, t, 0.0)[:, None] + 1e-3)
    far = torch.full_like(t, BIG)
    return {"main": (o, d, torch.where(hit, t, -BIG), gid),
            "through": (o, d, far, gid),
            "reseated": (o2, d, far, torch.full_like(gid, -2))}


def _occlusion_rays(scene, o, d):
    """K2's input, chip_smoke.py's free-space occlusion queries: from
    halfway to each primary hit toward the light, and from the light toward
    each hit stopping 0.05 short of it; misses are dead lanes (max_t -1)."""
    o, d = torch.from_numpy(o.copy()), torch.from_numpy(d.copy())
    t, idx = mi._closest_plain(o, d, scene.tri_p1, scene.tri_e1, scene.tri_e2, EPS)
    hit = idx >= 0
    light = scene.light_pos[None, :]
    t_safe = torch.where(hit, t, 1.0)[:, None]
    half, target = o + d * (t_safe * 0.5), o + d * t_safe
    v = torch.cat([light - half, target - light])
    dist = torch.sqrt((v * v).sum(1))
    margin = torch.cat([torch.zeros_like(t), torch.full_like(t, 0.05)])
    max_t = torch.where(torch.cat([hit, hit]), dist - margin, -1.0)
    return torch.cat([half, light.expand_as(target)]), v / dist[:, None], max_t


def _levels(occ, leaf):
    C = occ.cluster_box.shape[0]
    n_sub = occ.sub_box.shape[0] // C
    return C, n_sub, leaf // n_sub


def _enter(o, d, boxes, limit, signed):
    """(R, n) whether each ray enters each widened box: the census's
    signed test (the slab interval starts before limit, behind the origin
    included) or the occlusion walk's (at some t in [0, limit))."""
    tmin, tmax, _ = mi.box_slabs(o, d, boxes, widen=False)
    ok = (tmax >= tmin) & (tmin < limit[:, None])
    return ok if signed else ok & (tmax >= 0.0)


def _reached(o, d, occ, leaf, limit, signed, clusters=None):
    """(R, T) the packed rows the walk reaches: rows of an entered sub-box
    of an entered cluster of an entered group, inside the cluster range;
    the census skips the clusters and groups without a container row."""
    C, _, sub_rows = _levels(occ, leaf)
    c0, c1 = (0, C) if clusters is None else clusters
    grp = _enter(o, d, occ.group_box, limit, signed)
    clus = _enter(o, d, occ.cluster_box, limit, signed)
    sub = _enter(o, d, occ.sub_box, limit, signed)
    if signed:
        grp &= occ.group_census[None]
        clus &= occ.cluster_census[None]
    c = torch.arange(C)
    clus &= grp[:, c // GROUP] & ((c >= c0) & (c < c1))[None]
    row = torch.arange(occ.rows.shape[0])
    return sub[:, row // sub_rows] & clus[:, row // leaf]


def _packed(occ):
    return occ.rows[:, 0:3], occ.rows[:, 4:7], occ.rows[:, 8:11]


def walk_any_hit(o, d, max_t, occ, leaf, clusters=None):
    """K2's walk replayed: any reached row at t in [0, max_t); dead lanes
    (max_t <= 0) reach nothing."""
    reach = _reached(o, d, occ, leaf, max_t, False, clusters) & (max_t > 0)[:, None]
    t, valid = mi._pair_tests(o, d, *_packed(occ), EPS)
    return (reach & valid & (t >= 0.0) & (t < max_t[:, None])).any(1)


def walk_census(o, d, t_hit, hit_gid, occ, leaf, K, clusters=None):
    """K4's walk replayed: per slot k, the reached container rows other
    than the hit row that cross at t < t_hit, counted, and the latest such
    t (-BIG where none); dead lanes (t_hit <= -BIG) reach nothing."""
    reach = (_reached(o, d, occ, leaf, t_hit, True, clusters)
             & (t_hit > -BIG)[:, None] & (occ.row_cid >= 0)[None]
             & (occ.row_id[None] != hit_gid[:, None]))
    t, valid = mi._pair_tests(o, d, *_packed(occ), EPS)
    before = reach & valid & (t < t_hit[:, None])
    cnt = torch.stack([(before & (occ.row_cid == k)).sum(1, dtype=torch.int32)
                       for k in range(K)], 1)
    last = torch.stack([torch.where(before & (occ.row_cid == k), t, -BIG).amax(1)
                        for k in range(K)], 1)
    return cnt, last


# --- the census fields --------------------------------------------------------

@pytest.mark.parametrize("name", ["glass_teapot", "cow", "cow_herd"])
def test_census_fields(glass, name):
    """Scene.occ carries, on the scene's device, each packed row's table
    row and its slot tri_cid[row_id], and which clusters and groups hold a
    container row (glass_teapot: the teapot's; cow: none); an instanced
    scene's unique meshes (Scene.tlas_occ) carry none."""
    if name == "glass_teapot":
        scene = glass[1]
    else:
        world = cow_herd_world(3, 3) if name == "cow_herd" else REGISTRY[name](16)[0]
        scene = compile_scene(world, device="cpu")
    occ, leaf = scene.occ, scene.static.cluster_size
    assert occ.row_id.device == occ.row_cid.device == scene.tri_p1.device
    assert occ.row_id.dtype == occ.row_cid.dtype == torch.int32
    assert torch.equal(occ.row_cid, scene.tri_cid[occ.row_id.long()])
    has = (scene.tri_cid.view(-1, leaf) >= 0).any(1)
    assert torch.equal(occ.cluster_census, has)
    assert torch.equal(occ.group_census, has.view(-1, GROUP).any(1))
    assert bool(has.any()) == (name == "glass_teapot")
    if name == "cow_herd":
        for field in ("row_cid", "cluster_census", "group_census"):
            assert getattr(scene.tlas_occ, field).numel() == 0


def test_census_tables_keep_their_slots(glass):
    """Scene.occ keeps the container slots its census fields were built
    from: the scene's own tri_cid tensor, which a K4 launch then knows by
    identity; equal values when built from numpy; none without slots."""
    scene = glass[1]
    leaf = scene.static.cluster_size
    assert scene.occ.tri_cid is scene.tri_cid
    tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2, scene.cluster_aabb)
    again = occlusion_tables(*(t.numpy() for t in tabs), leaf, "cpu",
                             tri_cid=scene.tri_cid.numpy())
    assert again.tri_cid is not scene.tri_cid
    assert again.tri_cid.dtype == torch.int32
    assert torch.equal(again.tri_cid, scene.tri_cid)
    assert torch.equal(again.row_cid, scene.occ.row_cid)
    assert occlusion_tables(*tabs, leaf, "cpu").tri_cid.numel() == 0


@pytest.mark.parametrize("level", ["cluster_box", "sub_box"])
def test_pairwise_slabs_equal_dense(glass, level):
    """The slab arithmetic taken pair by pair (mi.slab_interval on gathered
    rays and boxes, as chip_smoke.py's bound model takes it) equals
    box_slabs' dense (R, C) interval bit for bit, on the stored boxes of a
    level, for the camera rays and axis-aligned rays (the near-zero guard)."""
    scene = glass[1]
    boxes = getattr(scene.occ, level)
    o = torch.from_numpy(glass[2].copy())
    d = torch.from_numpy(glass[3].copy())
    axes = torch.cat([torch.eye(3), -torch.eye(3)])
    o = torch.cat([o, o[:6]])
    d = torch.cat([d, axes])
    tmin, tmax, _ = mi.box_slabs(o, d, boxes, widen=False)
    gen = torch.Generator().manual_seed(7)
    r = torch.randint(0, o.shape[0], (200_000,), generator=gen)
    r[:6 * 64] = (o.shape[0] - 6 + torch.arange(6)).repeat_interleave(64)
    c = torch.randint(0, boxes.shape[0], (r.numel(),), generator=gen)
    pmin, pmax = mi.slab_interval(o[r], mi.slab_reciprocal(d)[r], boxes[c, :3],
                                  boxes[c, 3:])
    assert torch.equal(pmin, tmin[r, c]) and torch.equal(pmax, tmax[r, c])
    assert bool((tmax[r, c] >= tmin[r, c]).any())


# --- the signed cull never drops a crossing ---------------------------------------

@pytest.mark.parametrize("kind", ["through", "reseated"])
def test_signed_cull_never_drops_a_crossing(glass, kind):
    """Every (ray, container row) pair other than the ray's own hit that
    crosses at t < t_hit on a live lane, negative t included, has its
    sub-box, cluster box and group box pass the signed test, and its
    cluster and group census flags set."""
    scene = glass[1]
    o, d, t_hit, gid = _census_inputs(scene, *glass[2:])[kind]
    occ, leaf = scene.occ, scene.static.cluster_size
    _, _, sub_rows = _levels(occ, leaf)
    t, valid = mi._pair_tests(o, d, *_packed(occ), EPS)
    cross = (valid & (t < t_hit[:, None]) & (t_hit > -BIG)[:, None]
             & (occ.row_cid >= 0)[None] & (occ.row_id[None] != gid[:, None]))
    rays, rows = cross.nonzero(as_tuple=True)
    assert rays.numel() > 100
    if kind == "reseated":
        assert int((t[rays, rows] < 0).sum()) > 50  # crossings behind the origin
    for boxes, which in ((occ.sub_box, rows // sub_rows), (occ.cluster_box, rows // leaf),
                         (occ.group_box, rows // (leaf * GROUP))):
        tmin, tmax, _ = mi.box_slabs(o[rays], d[rays], boxes[which], widen=False)
        tmin, tmax = tmin.diagonal(), tmax.diagonal()
        assert ((tmax >= tmin) & (tmin < t_hit[rays])).all()
    assert occ.cluster_census[rows // leaf].all()
    assert occ.group_census[rows // (leaf * GROUP)].all()


# --- a walk over a cluster range --------------------------------------------------

RANGES = [(3, 13), (5, 29), (12, 45), (0, 56)]


@pytest.mark.parametrize("clusters", RANGES)
def test_ranged_walks_keep_every_hit_of_the_range(glass, clusters):
    """Cluster ranges whose ends fall inside a group (the streamed
    superblocks' case): K2's walk over the range equals any_hit_plain on
    the range's rows, and K4's equals crossing_count_plain there (hit row
    rebased), bit for bit; so does each wrapper's CPU path given the
    range."""
    scene = glass[1]
    occ, leaf = scene.occ, scene.static.cluster_size
    assert occ.cluster_box.shape[0] == 56
    c0, c1 = clusters
    rows = slice(c0 * leaf, c1 * leaf)
    tabs = (scene.tri_p1[rows], scene.tri_e1[rows], scene.tri_e2[rows])
    so, sd, max_t = _occlusion_rays(scene, *glass[2:])
    flags = walk_any_hit(so, sd, max_t, occ, leaf, clusters)
    assert torch.equal(flags, mi.any_hit_plain(so, sd, max_t, *tabs, EPS))
    assert torch.equal(flags, mi.mesh_any_hit(
        so, sd, max_t, scene.tri_p1, scene.tri_e1, scene.tri_e2, scene.cluster_aabb,
        leaf, EPS, clusters=clusters))
    counted = 0
    for o, d, t_hit, gid in _census_inputs(scene, *glass[2:]).values():
        cnt, last = walk_census(o, d, t_hit, gid, occ, leaf, 1, clusters)
        pcnt, plast = mi.crossing_count_plain(o, d, t_hit, gid - c0 * leaf, *tabs,
                                              scene.tri_cid[rows], 1, EPS)
        assert torch.equal(cnt, pcnt) and torch.equal(last, plast)
        wcnt, wlast = mi.mesh_crossing_count(
            o, d, t_hit, gid, scene.tri_p1, scene.tri_e1, scene.tri_e2,
            scene.cluster_aabb, scene.tri_cid, 1, leaf, EPS, clusters=clusters)
        assert torch.equal(cnt, wcnt) and torch.equal(last, wlast)
        counted += int(cnt.sum())
    assert counted > 0 and (c1 - c0 < 56 or int(flags.sum()) > 0)


# --- padding ---------------------------------------------------------------------

def test_signed_test_enters_empty_boxes_but_reaches_no_row(glass):
    """Without tmax >= 0, EMPTY_BOX (a point at 1e30) is entered by a ray
    whose three slabs meet there at a t in [-BIG, BIG]: not by a unit
    direction (1e30 / 0.577 lies past BIG, where the slab starts), but by
    direction -2 on every axis, at t = -5e29. Every empty box the census
    could enter holds only padding rows: an empty sub-box's rows have zero
    edges and slot -1; an empty cluster or group has no census flag. So a
    census on such rays counts what the plain sweep counts."""
    scene = glass[1]
    occ, leaf = scene.occ, scene.static.cluster_size
    _, _, sub_rows = _levels(occ, leaf)
    centre = scene.tri_p1[scene.tri_cid >= 0].mean(0)
    point = torch.full((1, 6), EMPTY_BOX)
    unit = torch.tensor([[0.5773502692] * 3, [-0.5773502692] * 3])
    for origin in (torch.full((3,), 1e12), centre):
        tmin, tmax, _ = mi.box_slabs(origin.expand(2, 3), unit, point, widen=False)
        assert not ((tmax >= tmin) & (tmin < BIG)).any()
    o = torch.stack([torch.full((3,), 1e12), centre, centre + 0.05])
    d = torch.full((3, 3), -2.0)
    t_hit = torch.full((3,), BIG)
    tmin, tmax, _ = mi.box_slabs(o, d, point, widen=False)
    assert ((tmax >= tmin) & (tmin < t_hit[:, None])).all()  # the trap is real
    empty_sub = (occ.sub_box == EMPTY_BOX).all(1)
    assert 0 < int(empty_sub.sum()) < empty_sub.numel()
    row_of_empty = empty_sub.repeat_interleave(sub_rows)
    p1, e1, e2 = _packed(occ)
    assert (e1[row_of_empty] == 0).all() and (e2[row_of_empty] == 0).all()
    assert (occ.row_cid[row_of_empty] == -1).all()
    assert not occ.cluster_census[(occ.cluster_box == EMPTY_BOX).all(1)].any()
    assert not occ.group_census[(occ.group_box == EMPTY_BOX).all(1)].any()
    gid = torch.full((3,), -2, dtype=torch.int32)
    cnt, last = walk_census(o, d, t_hit, gid, occ, leaf, 1)
    pcnt, plast = mi.crossing_count_plain(o, d, t_hit, gid, scene.tri_p1, scene.tri_e1,
                                          scene.tri_e2, scene.tri_cid, 1, EPS)
    assert torch.equal(cnt, pcnt) and torch.equal(last, plast)
    assert int(cnt[1:].sum()) >= 2  # from inside the teapot, both ways


# --- the replays against the plain sweeps and rtc_tpu ------------------------------

@pytest.mark.parametrize("kind", ["main", "through", "reseated"])
def test_census_walk_equals_plain(glass, kind):
    """K4's walk over the whole table equals crossing_count_plain bit for
    bit: every count and every latest crossing (the root node's primary
    rays cross nothing before their first hit)."""
    scene = glass[1]
    o, d, t_hit, gid = _census_inputs(scene, *glass[2:])[kind]
    cnt, last = walk_census(o, d, t_hit, gid, scene.occ, scene.static.cluster_size, 1)
    pcnt, plast = mi.crossing_count_plain(o, d, t_hit, gid, scene.tri_p1, scene.tri_e1,
                                          scene.tri_e2, scene.tri_cid, 1, EPS)
    assert torch.equal(cnt, pcnt) and torch.equal(last, plast)
    assert int((t_hit > -BIG).sum()) > 50
    if kind != "main":
        assert int(cnt.sum()) > 100


def test_any_hit_walk_equals_plain(glass):
    """K2's walk over the whole table equals any_hit_plain bit for bit on
    glass_teapot's free-space occlusion queries and on its primary rays as
    occlusion queries up to t = 100, a quarter of the lanes dead."""
    scene = glass[1]
    occ, leaf = scene.occ, scene.static.cluster_size
    tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2)
    so, sd, max_t = _occlusion_rays(scene, *glass[2:])
    o, d = (torch.from_numpy(x.copy()) for x in glass[2:])
    far = torch.full((o.shape[0],), 100.0)
    far[::4] = -1.0
    for oo, dd, mt in ((so, sd, max_t), (o, d, far)):
        flags = walk_any_hit(oo, dd, mt, occ, leaf)
        assert torch.equal(flags, mi.any_hit_plain(oo, dd, mt, *tabs, EPS))
        assert 0 < int(flags.sum()) < int((mt > 0).sum())


def test_walks_agree_with_rtc_tpu(glass):
    """On every 4th of the 512 camera rays, the walks against rtc_tpu's K2
    and K4 in interpret mode (mesh_any_hit_mxu, mesh_crossing_count_mxu).
    Their Plücker matmul rounds t otherwise, so rtc_tpu's own gate applies
    (tests/test_pallas_mesh.py, tests/test_torch_refraction.py): flags and
    counts equal on more than 99.5% of rays, the latest crossing within
    1e-4 where the counts agree."""
    js, scene, o, d = glass
    o, d = o[::4].copy(), d[::4].copy()
    occ, leaf = scene.occ, scene.static.cluster_size
    jargs = (js.tri_p1, js.tri_e1, js.tri_e2, js.cluster_aabb)
    max_t = np.full((o.shape[0],), 100.0, np.float32)
    max_t[::4] = -1.0
    flags = walk_any_hit(torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(max_t),
                         occ, leaf)
    ref = np.asarray(mesh_any_hit_mxu(o, d, max_t, *jargs, js.super_aabb,
                                      n_super=js.static.n_super, leaf=leaf,
                                      interpret=True))
    assert (flags.numpy() == ref).mean() > 0.995 and 0 < int(flags.sum())
    crossings = 0
    for oo, dd, t_hit, gid in _census_inputs(scene, o, d).values():
        cnt, last = walk_census(oo, dd, t_hit, gid, occ, leaf, 1)
        jcnt, jlast = mesh_crossing_count_mxu(
            oo.numpy(), dd.numpy(), t_hit.numpy(), gid.numpy(), *jargs, js.tri_cid,
            n_containers=1, leaf=leaf, interpret=True)
        same = (cnt.numpy() == np.asarray(jcnt)).all(1)
        assert same.mean() > 0.995
        close = np.abs(last.numpy() - np.asarray(jlast)) < 1e-4
        assert (close | ~same[:, None]).mean() > 0.995
        crossings += int(cnt.sum())
    assert crossings > 20
