"""The occlusion walk's tables (rtc_tpu_torch/scene/compile.py
OcclusionTables), which K3's shadow phase and K6 read, on the cow, a
208-cluster triangle soup and the 3x3 instanced herd: the packed copy is a
permutation of each cluster's rows, every box contains its rows, the boxes
are widened as the kernels' cluster_slab widens them, the instance slots
cover every real instance once, and the cull never drops a hit: in plain
PyTorch with box_slabs' arithmetic, every (ray, row) pair whose pair test
hits in [0, max_t) lies in a sub-box, a cluster box and a group box (and an
instance box and an instance group) that the ray enters before max_t. So
the walk's flags equal a dense sweep's; the kernels are held to it on the
GPU (tests/test_torch_cuda.py, chip_smoke.py).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_occlusion_tables.py -q
"""

import numpy as np
import pytest
import torch

from rtc_tpu.models.scenes import REGISTRY as JAX_REGISTRY
from rtc_tpu.scene.compile import compile_scene as jax_compile_scene
from rtc_tpu_torch.models.scenes import REGISTRY, _cam, cow_herd_world
from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
from rtc_tpu_torch.render.camera import camera_rays
from rtc_tpu_torch.scene.compile import (EMPTY_BOX, GROUP, TENSOR_FIELDS,
                                         compile_scene, scene_from_numpy)
from rtc_tpu_torch.scene.shapes import mesh
from rtc_tpu_torch.scene.world import PointLight, World
from rtc_tpu_torch.utils.constants import BIG

torch.set_num_threads(2)

EPS = 1e-5
SCENES = ("cow", "soup", "cow_herd")


def _rays(cam):
    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize,
                       cam.half_width, cam.half_height, cam.pixel_size)
    return o.float().contiguous(), d.float().contiguous()


@pytest.fixture(scope="module")
def scenes():
    """name -> (f32 scene, camera rays): the cow at 96x48, a
    soup of 26,000 random triangles (208 clusters, as chip_smoke.py's) with
    1,000 rays from a sphere around it, and the 3x3 herd (TLAS tables) at
    64x32."""
    out = {}
    world, cam = REGISTRY["cow"](96)
    out["cow"] = world, _rays(cam)
    rng = np.random.default_rng(0)
    centers = rng.uniform(-4.0, 4.0, (26000, 3))
    v = [centers + rng.normal(0.0, 0.2, (26000, 3)) for _ in range(3)]
    world = World(objects=[mesh(*v)], light=PointLight((0.0, 6.9, -5.0), (1, 1, 1)))
    o = rng.normal(size=(1000, 3))
    o *= 12.0 / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-4.0, 4.0, (1000, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    out["soup"] = world, (torch.tensor(o, dtype=torch.float32),
                          torch.tensor(d, dtype=torch.float32))
    out["cow_herd"] = cow_herd_world(3, 3), _rays(_cam(64, [0, 10, -18], [0, 3, 2]))
    return {name: (compile_scene(w, device="cpu"), rays) for name, (w, rays) in out.items()}


def _tables(scene):
    """(occlusion tables, p1, e1, e2, cluster boxes): the world table's, or
    for an instanced scene the unique meshes'."""
    if scene.tlas is not None:
        tl = scene.tlas
        return scene.tlas_occ, tl.p1, tl.e1, tl.e2, tl.caabb
    return scene.occ, scene.tri_p1, scene.tri_e1, scene.tri_e2, scene.cluster_aabb


def _replay_widening(box):
    """cluster_slab's widening in torch f32, operation by operation:
    scale = max over the axes of max(|lo|, |hi|), pad = 4e-6f * scale,
    lo - pad and hi + pad; empty boxes (lo > hi) as EMPTY_BOX."""
    box = box.float()
    lo, hi = box[:, :3], box[:, 3:]
    m = [torch.maximum(lo[:, k].abs(), hi[:, k].abs()) for k in range(3)]
    scale = torch.maximum(torch.maximum(m[0], m[1]), m[2])
    pad = torch.tensor(4e-6, dtype=torch.float32) * scale
    out = torch.cat([lo - pad[:, None], hi + pad[:, None]], 1)
    return torch.where((lo > hi).any(1, keepdim=True), EMPTY_BOX, out)


@pytest.mark.parametrize("name", SCENES)
def test_copy_is_a_permutation_of_each_cluster(scenes, name):
    """The packed rows equal the table's rows at row_id bit for bit (w = 0),
    and row_id permutes the rows of each cluster among themselves."""
    scene, _ = scenes[name]
    occ, p1, e1, e2, aabb = _tables(scene)
    leaf = scene.static.cluster_size
    rid = occ.row_id.long()
    assert torch.equal(rid.view(-1, leaf).sort(1).values,
                       torch.arange(rid.numel()).view(-1, leaf))
    for k, x in enumerate((p1, e1, e2)):
        assert torch.equal(occ.rows[:, 4 * k:4 * k + 3], x[rid])
        assert (occ.rows[:, 4 * k + 3] == 0).all()
    assert occ.cluster_box.shape[0] == aabb.shape[0]


def test_copy_permutes_rtc_tpus_rows():
    """The cow's packed rows are rtc_tpu's f32 world rows, each cluster's
    in another order."""
    jax_world, _ = JAX_REGISTRY["cow"](32)
    js = jax_compile_scene(jax_world, dtype=np.float32)
    world, _ = REGISTRY["cow"](32)
    occ = compile_scene(world, device="cpu").occ
    leaf = js.static.cluster_size
    rid = occ.row_id.numpy()
    for k, f in enumerate(("tri_p1", "tri_e1", "tri_e2")):
        ref = np.asarray(getattr(js, f))
        np.testing.assert_array_equal(occ.rows[:, 4 * k:4 * k + 3].numpy(), ref[rid])
        assert (rid // leaf == np.arange(len(rid)) // leaf).all()


@pytest.mark.parametrize("name", SCENES)
def test_boxes_contain_their_rows(scenes, name):
    """Every sub-box and cluster box holds the vertices of its real rows
    and every group box its clusters' boxes; a sub-box of padding rows
    (zero edges) is EMPTY_BOX; the instance groups hold their slots'
    boxes."""
    scene, _ = scenes[name]
    occ = _tables(scene)[0]
    leaf = scene.static.cluster_size
    rows = occ.rows.double()
    p1, e1, e2 = rows[:, 0:3], rows[:, 4:7], rows[:, 8:11]
    verts = torch.stack([p1, p1 + e1, p1 + e2], 1)            # (T, 3, 3)
    real = (e1 != 0).any(1) | (e2 != 0).any(1)
    sub_rows = rows.shape[0] // occ.sub_box.shape[0]

    def inside(points, box):  # points (n, k, 3) in boxes (n, 6)
        box = box.double()[:, None]
        return ((points >= box[..., :3]) & (points <= box[..., 3:])).all(-1)

    row = torch.arange(rows.shape[0])
    assert inside(verts, occ.sub_box[row // sub_rows])[real].all()
    assert inside(verts, occ.cluster_box[row // leaf])[real].all()
    filled = occ.sub_box[:, 0] < EMPTY_BOX
    assert int(filled.sum()) == int(real.view(-1, sub_rows).any(1).sum())
    corners = lambda b: torch.stack([b[:, :3], b[:, 3:]], 1).double()
    grp = occ.group_box[torch.arange(occ.cluster_box.shape[0]) // GROUP]
    filled = occ.cluster_box[:, 0] < EMPTY_BOX
    assert inside(corners(occ.cluster_box), grp)[filled].all()
    if scene.tlas is not None:
        slots = occ.inst_perm >= 0
        igrp = occ.inst_group[torch.arange(occ.inst_box.shape[0]) // GROUP]
        assert inside(corners(occ.inst_box), igrp)[slots].all()
        assert (occ.inst_box[~slots] == EMPTY_BOX).all()


@pytest.mark.parametrize("name", SCENES)
def test_widening_replays_cluster_slab(scenes, name):
    """The stored cluster, group and sub-boxes equal a torch f32 replay of
    cluster_slab's widening of the unwidened boxes, bit for bit: cluster
    boxes from the table's, group boxes from the union of 8 cluster boxes
    (super_aabb for a world table), sub-boxes from the f64 vertices of
    their rows' f32 values."""
    scene, _ = scenes[name]
    occ, _, _, _, aabb = _tables(scene)
    assert torch.equal(occ.cluster_box, _replay_widening(aabb))
    g = aabb.view(-1, GROUP, 6)
    real = (g[:, :, :3] <= g[:, :, 3:]).all(2, keepdim=True)
    union = torch.cat([torch.where(real, g[:, :, :3], float("inf")).amin(1),
                       torch.where(real, g[:, :, 3:], -float("inf")).amax(1)], 1)
    assert real.all(1).any() and not real.all()  # whole groups and padded ones
    assert torch.equal(occ.group_box, _replay_widening(union))
    if scene.tlas is None:
        assert torch.equal(occ.group_box, _replay_widening(scene.super_aabb))
    rows = occ.rows.double()
    p1, e1, e2 = rows[:, 0:3], rows[:, 4:7], rows[:, 8:11]
    verts = torch.stack([p1, p1 + e1, p1 + e2], 1)
    real = (e1 != 0).any(1) | (e2 != 0).any(1)
    sub_rows = rows.shape[0] // occ.sub_box.shape[0]
    v = verts.view(-1, 3 * sub_rows, 3)
    keep = real.repeat_interleave(3).view(v.shape[:2])[..., None]
    box = torch.cat([torch.where(keep, v, float("inf")).amin(1),
                     torch.where(keep, v, -float("inf")).amax(1)], 1)
    box[~keep.any(1)[:, 0]] = torch.tensor([1.0, 1, 1, -1, -1, -1], dtype=box.dtype)
    assert torch.equal(occ.sub_box, _replay_widening(box))


def test_instance_slots_cover_every_real_instance(scenes):
    """The herd's slots hold each of its 9 instances once, in a k-d order
    of their centres, then -1 for the 7 padding slots; each slot's box is
    its instance's world box widened as cluster_slab widens it."""
    scene = scenes["cow_herd"][0]
    occ, tl = scene.tlas_occ, scene.tlas
    perm = occ.inst_perm
    assert perm.shape == (16,)
    assert sorted(perm[perm >= 0].tolist()) == list(range(9))
    assert (perm[9:] == -1).all()
    real = (tl.inst_aabb[:, :3] <= tl.inst_aabb[:, 3:]).all(1)
    assert int(real.sum()) == 9
    assert torch.equal(occ.inst_box[:9], _replay_widening(tl.inst_aabb[perm[:9].long()]))
    first = tl.inst_aabb[perm[:8].long()]
    union = torch.cat([first[:, :3].amin(0), first[:, 3:].amax(0)])[None]
    assert torch.equal(occ.inst_group[:1], _replay_widening(union))


def test_scene_from_numpy_builds_the_same_tables(scenes):
    """A scene carried from another compiler's numpy tables gets the same
    occlusion tables as the port's own compile, world and instanced."""
    for name in ("cow", "cow_herd"):
        scene = scenes[name][0]
        arrays = {f: getattr(scene, f).numpy() for f in TENSOR_FIELDS}
        if scene.tlas is not None:
            arrays["tlas"] = {k: v.numpy() for k, v in scene.tlas._asdict().items()}
        carried = scene_from_numpy(arrays, scene.static._asdict(), "cpu")
        for mine, theirs in ((scene.occ, carried.occ), (scene.tlas_occ, carried.tlas_occ)):
            assert (mine is None) == (theirs is None)
            if mine is not None:
                for a, b in zip(mine, theirs):
                    assert torch.equal(a, b)


# --- the cull never drops a hit -----------------------------------------------

RAY_KINDS = ("camera", "free_space", "surface", "random")


def _query(name, scene, o, d, kind, rng):
    """(origin, direction, max_t) of one kind of occlusion query: the
    camera rays up to 100; chip_smoke.py's free-space occlusion rays (from
    halfway to each hit toward the light, and from the light toward each
    hit stopping 0.05 short); the surface shadow rays of the closest hits
    (shadow_rays_plain: from over_point toward the light); or random rays
    through the scene's box with random bounds, a tenth of them dead."""
    p1, e1, e2 = scene.tri_p1, scene.tri_e1, scene.tri_e2
    if kind == "camera":
        return o, d, torch.full((o.shape[0],), 100.0)
    if kind == "random":
        lo, hi = p1.amin(0).numpy(), p1.amax(0).numpy()
        R = 600
        origin = rng.uniform(lo - 1.0, hi + 1.0, (R, 3))
        target = rng.uniform(lo, hi, (R, 3))
        dirs = target - origin
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        max_t = rng.uniform(0.0, 2.0 * np.linalg.norm(hi - lo), R)
        max_t[::10] = -1.0
        f = lambda a: torch.tensor(a, dtype=torch.float32)
        return f(origin), f(dirs), f(max_t)
    t, idx = mi._closest_plain(o, d, p1, e1, e2, EPS)
    hit = idx >= 0
    if kind == "surface":
        n = torch.where(hit[:, None], scene.tri_n[idx.clamp_min(0).long()], 0.0)
        so, sd, max_t = mi.shadow_rays_plain(o, d, t, idx, n, scene.light_pos, EPS)
        return so, sd, max_t
    light = scene.light_pos[None, :]
    t_safe = torch.where(hit, t, 1.0)[:, None]
    half, target = o + d * (t_safe * 0.5), o + d * t_safe
    v = torch.cat([light - half, target - light])
    dist = torch.sqrt((v * v).sum(1))
    margin = torch.cat([torch.zeros_like(t), torch.full_like(t, 0.05)])
    max_t = torch.where(torch.cat([hit, hit]), dist - margin, -1.0)
    return torch.cat([half, light.expand_as(target)]), v / dist[:, None], max_t


def _hit_pairs(o, d, max_t, rows):
    """(ray, row) index pairs whose pair test hits at t in [0, max_t)."""
    p1, e1, e2 = rows[:, 0:3], rows[:, 4:7], rows[:, 8:11]
    rays, hits = [], []
    for s in range(0, o.shape[0], 100):
        t, valid = mi._pair_tests(o[s:s + 100], d[s:s + 100], p1, e1, e2, EPS)
        r, j = (valid & (t >= 0.0) & (t < max_t[s:s + 100, None])).nonzero(as_tuple=True)
        rays.append(r + s)
        hits.append(j)
    return torch.cat(rays), torch.cat(hits)


def _entered(o, d, boxes, max_t, rays, which):
    """Whether ray rays[k] enters box which[k] (widened already) before its
    max_t, with box_slabs' arithmetic."""
    out = []
    for s in range(0, rays.numel(), 256):
        r, w = rays[s:s + 256], which[s:s + 256]
        tmin, tmax, _ = mi.box_slabs(o[r], d[r], boxes[w], widen=False)
        tmin, tmax = tmin.diagonal(), tmax.diagonal()
        out.append((tmax >= tmin) & (tmax >= 0.0) & (tmin < max_t[r]))
    return torch.cat(out) if out else torch.zeros((0,), dtype=torch.bool)


def _assert_mesh_levels(o, d, max_t, occ, leaf, rays, rows):
    """Every hit pair's sub-box, cluster box and group box entered."""
    sub_rows = occ.rows.shape[0] // occ.sub_box.shape[0]
    for boxes, which in ((occ.sub_box, rows // sub_rows), (occ.cluster_box, rows // leaf),
                         (occ.group_box, rows // (leaf * GROUP))):
        assert _entered(o, d, boxes, max_t, rays, which).all()


@pytest.mark.parametrize("kind", RAY_KINDS)
@pytest.mark.parametrize("name", SCENES)
def test_cull_never_drops_a_hit(scenes, name, kind):
    scene, (o, d) = scenes[name]
    rng = np.random.default_rng(10 * SCENES.index(name) + RAY_KINDS.index(kind))
    if name == "soup" and kind in ("free_space", "surface"):
        o, d = o[:300], d[:300]
    so, sd, max_t = _query(name, scene, o, d, kind, rng)
    leaf = scene.static.cluster_size
    if scene.tlas is None:
        rays, rows = _hit_pairs(so, sd, max_t, scene.occ.rows)
        _assert_mesh_levels(so, sd, max_t, scene.occ, leaf, rays, rows)
        assert rays.numel() > 20
        return
    occ, tl, st = scene.tlas_occ, scene.tlas, scene.static
    tm = st.tlas_cm * leaf
    slot_of = {int(k): s for s, k in enumerate(occ.inst_perm.tolist()) if k >= 0}
    found = 0
    for k, m in mi._real_instances(tl.p1, tl.inst_aabb, tl.inst_mesh, tm):
        oi, di = mi.instance_rays(so, sd, tl.inst_ab[k])
        rays, rows = _hit_pairs(oi, di, max_t, occ.rows[m * tm:(m + 1) * tm])
        rows = rows + m * tm
        slot = torch.full_like(rays, slot_of[k])
        assert _entered(so, sd, occ.inst_box, max_t, rays, slot).all()
        assert _entered(so, sd, occ.inst_group, max_t, rays, slot // GROUP).all()
        _assert_mesh_levels(oi, di, max_t, occ, leaf, rays, rows)
        found += rays.numel()
    assert found > 20


def test_dead_lanes_and_empty_boxes_enter_nothing(scenes):
    """EMPTY_BOX (padding sub-boxes, padding instance slots) is entered by
    no ray of any kind before a finite max_t, parked lanes included."""
    scene, (o, d) = scenes["cow_herd"]
    occ = scene.tlas_occ
    empty = occ.inst_box[occ.inst_perm < 0]
    assert empty.shape[0] == 7
    park = torch.cat([o, torch.full((8, 3), 1e12)])
    dirs = torch.cat([d, torch.tensor([[0.5773502692] * 3, [0, 0, 1.0], [0, 0, -1.0],
                                       [1.0, 0, 0], [-1.0, 0, 0], [0, 1.0, 0],
                                       [0, -1.0, 0], [0.6, 0.8, 0]])])
    tmin, tmax, _ = mi.box_slabs(park, dirs, empty, widen=False)
    ok = (tmax >= tmin) & (tmax >= 0.0) & (tmin < BIG)
    assert not ok.any()
