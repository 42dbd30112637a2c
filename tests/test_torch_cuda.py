"""The CUDA kernels K1-K6 against their plain PyTorch versions on the card,
at small sizes and on edge cases: ragged ray counts, padding clusters and
padding instances, parked rays, axis-parallel directions, dead lanes,
empty batches and bad inputs; the ordered walk of K1, K3 and K5 on tables
that force its list to refill and its keys to tie; the occlusion walk of
K2, K3 and K6 on rays that graze its boxes, bounds at a triangle's own t,
a world whose every instance group is entered and cluster ranges whose
ends fall inside a group; K4's census walk; launches without their
tables; the smooth, glass and instanced scenes rendered through the
kernels; the closest-hit autograd Functions with each kernel as their
forward against their plain versions; and the tables inject_params
rebuilds from new triangle rows; and the book API on the card:
intersect_all and hit_index against K1 on a cow wavefront, camera_rays
on a card matrix, and the testing helpers' book numbers in float64; and
the compiled frame (render/compiled.py): render() and render_tiles
replayed from CUDA graphs, bit-equal to the eager frame, one capture for
two cameras, a replay's launches equal to the eager frame's, a streamed
table on the eager route, a capture that meets a host sync raising, and
the program's spans of a graphed frame under torch.profiler;
and the compiled gradient step: loss_and_grad and an Adam step replayed
from CUDA graphs against the eager calls, after other graphs too, and
the gradient routes that stay eager; the cuBLAS launches of a graphed
glass_teapot frame and step against cow's; and the object rows' sum
(object_record's gradient) against its index_add_ twin, in a graph, and
in tiles past a block's shared memory.

These tests need a CUDA device and nvcc, and skip elsewhere. This file
imports neither jax nor rtc_tpu, so on the GPU machine it runs without the
repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from rtc_tpu_torch import Camera, default_world, hit_index, intersect_all, testing
from rtc_tpu_torch.diff import render_grad as RG
from rtc_tpu_torch.models.scenes import (REGISTRY, _cam, cow_herd_mesh_world,
                                         cow_herd_world)
from rtc_tpu_torch.ops import matrices
from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
from rtc_tpu_torch.ops import transforms as X
from rtc_tpu_torch.render import compiled, integrator, progressive
from rtc_tpu_torch.render.camera import camera_rays, camera_rays_for_pixels
from rtc_tpu_torch.render.renderer import render
from rtc_tpu_torch.scene.compile import compile_scene, occlusion_tables
from rtc_tpu_torch.scene.shapes import mesh, triangle
from rtc_tpu_torch.scene.world import PointLight, World
from rtc_tpu_torch.utils import profiling
from rtc_tpu_torch.utils.config import RenderConfig
from rtc_tpu_torch.ops.vec import normalize, normalize3
from rtc_tpu_torch.utils.constants import BIG, EPSILON

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the GPU machine)")
    return torch.device("cuda")


def _scene_rays(scene, o, d):
    return (torch.as_tensor(o, dtype=torch.float32, device=scene.tri_p1.device),
            torch.as_tensor(d, dtype=torch.float32, device=scene.tri_p1.device))


def _all_three(scene, o, d, max_t):
    """Each kernel and its plain version on the same inputs."""
    tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2)
    leaf = scene.static.cluster_size
    k1 = mi.mesh_closest_hit(o, d, *tabs, scene.tri_n, scene.cluster_aabb, leaf)
    p1 = mi.closest_hit_plain(o, d, *tabs, scene.tri_n)
    k2 = mi.mesh_any_hit(o, d, max_t, *tabs, scene.cluster_aabb, leaf, occ=scene.occ)
    p2 = mi.any_hit_plain(o, d, max_t, *tabs)
    k3 = mi.mesh_closest_shadow(o, d, *tabs, scene.tri_n, scene.cluster_aabb,
                                scene.light_pos, leaf, occ=scene.occ)
    p3 = mi.closest_shadow_plain(o, d, *tabs, scene.tri_n, scene.light_pos)
    torch.cuda.synchronize()
    return (k1, p1), (k2, p2), (k3, p3)


def _assert_closest_equal(k, p):
    """The kernel rounds as the plain version does: t is bit-equal, and idx
    differs only where two triangles tie at that t."""
    t, idx, n = k[:3]
    assert torch.equal(t, p[0])
    assert torch.equal(idx >= 0, p[1] >= 0)
    same = idx == p[1]
    assert torch.equal(n[same], p[2][same])
    assert float(same.float().mean()) > 0.99


def test_single_triangle_edge_cases(cuda):
    """One triangle (7 of 8 clusters are empty padding boxes); 130 rays,
    so the last block is ragged; straight-on rays with zero x/y direction
    components; parked rays; and a miss."""
    world = World(objects=[triangle([0, 1, 0], [-1, 0, 0], [1, 0, 0])],
                  light=PointLight((0, 0.5, -5), (1, 1, 1)))
    scene = compile_scene(world, device=cuda)
    assert scene.static.n_clusters == 8
    xs = np.linspace(-1.2, 1.2, 120)
    o = np.stack([xs, np.full_like(xs, 0.3), np.full_like(xs, -5.0)], 1)
    d = np.tile([0.0, 0.0, 1.0], (120, 1))
    o = np.concatenate([o, np.full((8, 3), 1e12), [[5, 5, -5], [0, 0.3, 5]]])
    d = np.concatenate([d, np.full((8, 3), 0.5773502692), [[0, 0, 1], [0, 0, -1]]])
    o, d = _scene_rays(scene, o, d)
    max_t = torch.full((130,), 100.0, device=cuda)
    max_t[::3] = -1.0  # dead lanes
    (k1, p1), (k2, p2), (k3, p3) = _all_three(scene, o, d, max_t)
    _assert_closest_equal(k1, p1)
    _assert_closest_equal(k3, p3)
    hits = k1[1] >= 0
    assert 50 < int(hits[:120].sum()) < 120
    assert not hits[120:129].any() and hits[129]  # parked, miss, back face
    assert torch.equal(k2, p2) and not k2[::3].any() and k2.any()
    assert torch.equal(k3[3], p3[3])


def test_random_soup_many_clusters(cuda):
    """A soup of 300 clusters: no array in the kernels is sized by C."""
    rng = np.random.default_rng(1)
    n = 300 * 128
    c = rng.uniform(-4.0, 4.0, (n, 3))
    world = World(objects=[mesh(*(c + rng.normal(0, 0.2, (n, 3)) for _ in range(3)))],
                  light=PointLight((0, 6.9, -5), (1, 1, 1)))
    scene = compile_scene(world, device=cuda)
    assert scene.static.n_clusters == 304
    o = rng.normal(size=(1000, 3))
    o *= 12.0 / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-4, 4, (1000, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = _scene_rays(scene, o, d)
    max_t = torch.full((1000,), 6.0, device=cuda)
    (k1, p1), (k2, p2), (k3, p3) = _all_three(scene, o, d, max_t)
    _assert_closest_equal(k1, p1)
    _assert_closest_equal(k3, p3)
    assert torch.equal(k2, p2)
    assert int((k3[3] != p3[3]).sum()) <= 2


def test_empty_batch_and_bad_inputs(cuda):
    world, _ = REGISTRY["cow"](16)
    scene = compile_scene(world, device=cuda)
    tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2, scene.tri_n,
            scene.cluster_aabb)
    leaf = scene.static.cluster_size
    mi.reset_launch_counts()
    empty = torch.zeros((0, 3), device=cuda)
    t, idx, n = mi.mesh_closest_hit(empty, empty, *tabs, leaf)
    assert t.shape == (0,) and idx.shape == (0,) and n.shape == (0, 3)
    assert mi.LAUNCHES["closest_hit"] == 0
    o = torch.zeros((4, 3), device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        mi.mesh_closest_hit(o.double(), o.double(), *tabs, leaf)
    with pytest.raises(ValueError, match="contiguous"):
        mi.mesh_closest_hit(o.t().contiguous().t(), o, *tabs, leaf)
    with pytest.raises(ValueError, match="shape"):
        mi.mesh_closest_hit(o, o, *tabs, leaf * 2)


def test_render_through_kernels_matches_plain(cuda):
    """cow at 128x64: the kernels' render against the plain render on the
    card, within the f32 budget of tests/test_pallas_mesh.py; each kernel
    launched once per bounce node."""
    world, cam = REGISTRY["cow"](128)
    scene = compile_scene(world, device=cuda)
    for fused, key in ((True, "closest_shadow"), (False, "closest_hit")):
        mi.reset_launch_counts()
        img = render(scene, cam, RenderConfig(ray_tile=4096, fused_shadow=fused))
        assert mi.LAUNCHES[key] == 4  # 2 tiles x 2 bounce nodes
        ref = render(scene, cam, RenderConfig(ray_tile=4096, mesh_impl="bruteforce"))
        err = (img - ref).abs().amax(dim=2).flatten()
        assert float(torch.quantile(err, 0.999)) < 2e-3
        assert int((err > 0.05).sum()) <= 3


def test_camera_rays_on_device(cuda):
    _, cam = REGISTRY["cow"](64)
    args = (cam.transform_inverse, cam.hsize, cam.vsize, cam.half_width,
            cam.half_height, cam.pixel_size)
    o, d = camera_rays(*args, device=cuda)
    oc, dc = camera_rays(*args)
    assert o.device.type == "cuda"
    torch.testing.assert_close(o.cpu(), oc, rtol=0, atol=1e-6)
    torch.testing.assert_close(d.cpu(), dc, rtol=0, atol=1e-6)


def _soup(rng, n_clusters, cuda, smooth=False, n_containers=0):
    """A random triangle soup of n_clusters clusters, with random unit
    corner normals when smooth, and each triangle in container slot
    (id % n_containers) when n_containers; plus 1000 rays from a sphere
    around it toward points inside it."""
    n = n_clusters * 128
    c = rng.uniform(-4.0, 4.0, (n, 3))
    v = [c + rng.normal(0, 0.2, (n, 3)) for _ in range(3)]
    vn = [rng.normal(size=(n, 3)) for _ in range(3)] if smooth else [None] * 3
    scene = compile_scene(World(objects=[mesh(*v, *vn)],
                                light=PointLight((0, 6.9, -5), (1, 1, 1))),
                          device=cuda)
    o = rng.normal(size=(1000, 3))
    o *= 12.0 / np.linalg.norm(o, axis=1, keepdims=True)
    d = rng.uniform(-4, 4, (1000, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if n_containers:
        real = scene.tri_e1.abs().sum(1) > 0
        cid = torch.arange(scene.tri_cid.shape[0], device=cuda) % n_containers
        scene.tri_cid = torch.where(real, cid, -1).to(torch.int32)
        scene.occ = occlusion_tables(scene.tri_p1, scene.tri_e1, scene.tri_e2,
                                     scene.cluster_aabb, 128, cuda, tri_cid=scene.tri_cid)
    return scene, *_scene_rays(scene, o, d)


def _sn_pair(scene, o, d):
    tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2)
    snc = integrator.corner_normals(scene)
    leaf = scene.static.cluster_size
    k1 = mi.mesh_closest_hit_sn(o, d, *tabs, snc, scene.cluster_aabb, leaf)
    p1 = mi.closest_hit_sn_plain(o, d, *tabs, snc)
    k3 = mi.mesh_closest_shadow_sn(o, d, *tabs, snc, scene.cluster_aabb,
                                   scene.light_pos, leaf, occ=scene.occ)
    p3 = mi.closest_shadow_sn_plain(o, d, *tabs, snc, scene.light_pos)
    torch.cuda.synchronize()
    return (k1, p1), (k3, p3)


@pytest.mark.parametrize("where", ["soup", "teapot"])
def test_sn_kernels_match_plain(cuda, where):
    """K1 and K3 with_sn: t bit-equal, idx different only at ties, the raw
    blend bit-equal at equal idx; K3's shadow flags within two flips."""
    if where == "soup":
        scene, o, d = _soup(np.random.default_rng(2), 100, cuda, smooth=True)
    else:
        world, cam = REGISTRY["teapot_smooth"](128)
        scene = compile_scene(world, device=cuda)
        o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize,
                           cam.half_width, cam.half_height, cam.pixel_size,
                           device=cuda)
    assert scene.static.any_smooth
    (k1, p1), (k3, p3) = _sn_pair(scene, o.contiguous(), d.contiguous())
    _assert_closest_equal(k1, p1)
    _assert_closest_equal(k3, p3)
    assert int((k1[1] >= 0).sum()) > 300
    assert int((k3[3] != p3[3]).sum()) <= 2


def test_fused_sn_matches_split(cuda):
    """teapot_smooth at 256x128: K3 with_sn against K1 with_sn, then K2 on
    the shadow rays the integrator derives from the normalized blend. The
    split path normalizes with the same operations, so t, idx and n agree
    bit for bit; shadow flags within max(2, hits/1000)."""
    world, cam = REGISTRY["teapot_smooth"](256)
    scene = compile_scene(world, device=cuda)
    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize,
                       cam.half_width, cam.half_height, cam.pixel_size,
                       device=cuda)
    o, d = o.contiguous(), d.contiguous()
    t, idx, n, sh = mi.mesh_closest_shadow_sn(
        o, d, scene.tri_p1, scene.tri_e1, scene.tri_e2,
        integrator.corner_normals(scene), scene.cluster_aabb, scene.light_pos,
        scene.static.cluster_size, occ=scene.occ)
    cfg = RenderConfig(fused_shadow=False)
    hit = integrator.closest_hit(scene, o, d, cfg)
    comps = integrator.prepare_hit3(scene, o, d, hit, cfg)
    over = torch.stack([torch.where(hit.valid, c, 1e12) for c in comps.over_point], 1)
    lvx, lvy, lvz = normalize3(*(scene.light_pos[k] - comps.point[k]
                                 for k in range(3)))
    nx, ny, nz = comps.normalv
    facing = (lvx * nx + lvy * ny + lvz * nz) >= 0.0
    sh_split = integrator.is_shadowed(scene, over, cfg, live=hit.valid & facing)
    assert torch.equal(t, hit.t) and torch.equal(idx.clamp_min(0), hit.tri)
    assert torch.equal(normalize(n)[hit.valid], hit.tri_n[hit.valid])
    hits = int(hit.valid.sum())
    assert int((sh != sh_split).sum()) <= max(2, hits // 1000)


@pytest.mark.parametrize("where", ["soup", "glass_teapot"])
def test_crossing_count_matches_plain(cuda, where):
    """K4 against its plain version: counts exactly equal, the latest
    crossing equal where counts agree. The glass teapot runs its primary
    rays (t_hit and hit_gid of their hits, dead lanes at -BIG) and the same
    rays re-seated past their hit (t_hit = BIG); the soup runs three
    container slots, on whole lines and on lines cut at the soup's
    center."""
    if where == "soup":
        scene, o, d = _soup(np.random.default_rng(3), 60, cuda, n_containers=3)
        gid = torch.full((1000,), -2, dtype=torch.int32, device=cuda)
        sets = [(o, d, torch.full((1000,), BIG, device=cuda), gid),
                (o, d, torch.full((1000,), 12.0, device=cuda), gid)]
        K = 3
    else:
        world, cam = REGISTRY["glass_teapot"](128)
        scene = compile_scene(world, device=cuda)
        o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize,
                           cam.half_width, cam.half_height, cam.pixel_size,
                           device=cuda)
        o, d = o.contiguous(), d.contiguous()
        t, idx, _ = mi.closest_hit_sn_plain(o, d, scene.tri_p1, scene.tri_e1,
                                            scene.tri_e2,
                                            integrator.corner_normals(scene))
        hit = idx >= 0
        gid = torch.where(hit, idx, -2).to(torch.int32)
        t_hit = torch.where(hit, t, -BIG)
        o2 = (o + d * (torch.where(hit, t, 0.0)[:, None] + 1e-3)).contiguous()
        sets = [(o, d, t_hit.contiguous(), gid.contiguous()),
                (o2, d, torch.full_like(t, BIG), torch.full_like(gid, -2))]
        K = 1
    leaf = scene.static.cluster_size
    crossings = 0
    for oo, dd, t_hit, gid in sets:
        args = (scene.tri_p1, scene.tri_e1, scene.tri_e2)
        cnt, last = mi.mesh_crossing_count(oo, dd, t_hit, gid, *args,
                                           scene.cluster_aabb, scene.tri_cid,
                                           K, leaf, occ=scene.occ)
        pcnt, plast = mi.crossing_count_plain(oo, dd, t_hit, gid, *args,
                                              scene.tri_cid, K)
        torch.cuda.synchronize()
        assert torch.equal(cnt, pcnt)
        assert torch.equal(last, plast)
        crossings += int(cnt.sum())
    assert crossings > 100


def test_crossing_count_bad_inputs(cuda):
    world, _ = REGISTRY["glass_teapot"](16)
    scene = compile_scene(world, device=cuda)
    o = torch.zeros((4, 3), device=cuda)
    t_hit = torch.ones((4,), device=cuda)
    gid = torch.full((4,), -2, dtype=torch.int32, device=cuda)
    args = (scene.tri_p1, scene.tri_e1, scene.tri_e2, scene.cluster_aabb)
    leaf = scene.static.cluster_size
    with pytest.raises(ValueError, match="dtype"):
        mi.mesh_crossing_count(o, o, t_hit, gid.long(), *args, scene.tri_cid, 1, leaf)
    with pytest.raises(ValueError, match="n_containers"):
        mi.mesh_crossing_count(o, o, t_hit, gid, *args, scene.tri_cid, 0, leaf)


def test_crossing_count_holds_tri_cid_to_its_tables(cuda):
    """K4 counts by the occlusion tables' census fields, not by tri_cid:
    a copy of the slots they were built from counts as the scene's own
    tensor, and other slots raise."""
    scene, o, d = _soup(np.random.default_rng(5), 20, cuda, n_containers=2)
    t_hit = torch.full((1000,), BIG, device=cuda)
    gid = torch.full((1000,), -2, dtype=torch.int32, device=cuda)
    args = (o, d, t_hit, gid, scene.tri_p1, scene.tri_e1, scene.tri_e2,
            scene.cluster_aabb)
    leaf = scene.static.cluster_size
    own = mi.mesh_crossing_count(*args, scene.tri_cid, 2, leaf, occ=scene.occ)
    copy = mi.mesh_crossing_count(*args, scene.tri_cid.clone(), 2, leaf, occ=scene.occ)
    assert torch.equal(own[0], copy[0]) and torch.equal(own[1], copy[1])
    other = torch.where(scene.tri_cid >= 0, 1 - scene.tri_cid, -1).to(torch.int32)
    with pytest.raises(ValueError, match="other container slots"):
        mi.mesh_crossing_count(*args, other, 2, leaf, occ=scene.occ)


def test_crossing_count_ignores_slots_past_k(cuda):
    """Rows whose container slot is n_containers or more count nowhere, on
    the card as in the plain version: a soup of three slots counted with
    K = 1 and 2 equals the plain sweep, and the first columns of K = 3."""
    scene, o, d = _soup(np.random.default_rng(6), 30, cuda, n_containers=3)
    t_hit = torch.full((1000,), BIG, device=cuda)
    gid = torch.full((1000,), -2, dtype=torch.int32, device=cuda)
    tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2)
    leaf = scene.static.cluster_size
    full = mi.mesh_crossing_count(o, d, t_hit, gid, *tabs, scene.cluster_aabb,
                                  scene.tri_cid, 3, leaf, occ=scene.occ)
    for K in (1, 2):
        cnt, last = mi.mesh_crossing_count(o, d, t_hit, gid, *tabs, scene.cluster_aabb,
                                           scene.tri_cid, K, leaf, occ=scene.occ)
        pcnt, plast = mi.crossing_count_plain(o, d, t_hit, gid, *tabs, scene.tri_cid, K)
        torch.cuda.synchronize()
        assert torch.equal(cnt, pcnt) and torch.equal(last, plast)
        assert torch.equal(cnt, full[0][:, :K]) and torch.equal(last, full[1][:, :K])
    assert int(full[0][:, 2].sum()) > 0


@pytest.mark.parametrize("name", ["teapot_smooth", "glass_teapot"])
def test_render_slice_scene_through_kernels_matches_plain(cuda, name):
    """128x64 at depth 5: the kernels' render against the plain render on
    the card, within the f32 budget of tests/test_pallas_mesh.py; each
    kernel of the scene's path launched once per bounce node."""
    world, cam = REGISTRY[name](128)
    scene = compile_scene(world, device=cuda)
    mi.reset_launch_counts()
    img = render(scene, cam, RenderConfig(ray_tile=4096))
    # 2 tiles; teapot_smooth has 1 node per tile, glass_teapot 3 (the root
    # and its reflected and refracted children) with the census at the root
    want = ({"closest_shadow_sn": 2} if name == "teapot_smooth" else
            {"closest_hit_sn": 6, "any_hit": 6, "crossing_count": 2})
    assert mi.LAUNCHES == dict(dict.fromkeys(mi.LAUNCHES, 0), **want)
    ref = render(scene, cam, RenderConfig(ray_tile=4096, mesh_impl="bruteforce"))
    err = (img - ref).abs().amax(dim=2).flatten()
    assert float(torch.quantile(err, 0.999)) < 2e-3
    assert int((err > 0.05).sum()) <= 3


# --- instanced meshes (TLAS): K5 flat and with_sn, K6 ----------------------

def _rotation(rng):
    """A random rotation (Rodrigues' formula about a random axis)."""
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    a = rng.uniform(0.0, 2.0 * np.pi)
    return np.eye(3) + np.sin(a) * k + (1.0 - np.cos(a)) * (k @ k)


def _instanced_soup(rng, cuda, smooth=False, n_inst=45, spread=8.0, size=0.15):
    """Two unique random meshes of 10 clusters, instanced n_inst times in
    turn with random rotations, non-uniform scales (0.4-2 per axis) and
    translations within +-spread: at 45 instances 58,368 padded world rows,
    so the scene compiles to TLAS tables (M = 2, cm = 16, the instances
    padded to a multiple of 8). Triangles of corners normal around their
    center with deviation size; random unit corner normals when smooth.
    Plus 2,000 rays from a sphere of radius 25 toward points of the herd's
    box, 64 of them through the world origin, where the padding instances'
    untransformed mesh 0 sits."""
    meshes = []
    for _ in range(2):
        c = rng.uniform(-1.5, 1.5, (1280, 3))
        v = [c + rng.normal(0, size, (1280, 3)) for _ in range(3)]
        vn = [rng.normal(size=(1280, 3)) for _ in range(3)] if smooth else [None] * 3
        meshes.append(v + vn)
    objects = []
    for k in range(n_inst):
        m = np.eye(4)
        m[:3, :3] = _rotation(rng) @ np.diag(rng.uniform(0.4, 2.0, 3))
        m[:3, 3] = rng.uniform(-spread, spread, 3)
        objects.append(mesh(*meshes[k % 2], transform=m))
    scene = compile_scene(World(objects=objects,
                                light=PointLight((0, 30, -20), (1, 1, 1))),
                          device=cuda)
    st = scene.static
    assert (st.tlas_n_inst, st.tlas_n_mesh, st.tlas_cm, st.tlas_sn) == (
        -(-n_inst // 8) * 8, 2, 16, smooth)
    o = rng.normal(size=(2000, 3))
    o *= 25.0 / np.linalg.norm(o, axis=1, keepdims=True)
    target = rng.uniform(-spread, spread, (2000, 3))
    target[:64] = 0.0
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return scene, *_scene_rays(scene, o, d)


def _tlas_args(scene, k5: bool):
    tl, st = scene.tlas, scene.static
    if not k5:
        return (tl.p1, tl.e1, tl.e2, tl.caabb, tl.inst_ab, tl.inst_aabb,
                tl.inst_mesh, st.cluster_size, st.tlas_cm)
    return (tl.p1, tl.e1, tl.e2, tl.sn if st.tlas_sn else tl.n, tl.caabb,
            tl.inst_ab, tl.inst_aabb, tl.inst_mesh, tl.inst_obj,
            st.cluster_size, st.tlas_cm)


def _tlas_pair(scene, o, d, max_t):
    """K5 (of the scene's payload mode) and K6 with their plain versions."""
    args = _tlas_args(scene, True)
    plain_args = args[:4] + args[5:]  # the plain versions take no caabb
    k6_args = _tlas_args(scene, False)
    if scene.static.tlas_sn:
        k5 = mi.mesh_closest_hit_tlas_sn(o, d, *args)
        p5 = mi.closest_hit_tlas_sn_plain(o, d, *plain_args)
    else:
        k5 = mi.mesh_closest_hit_tlas(o, d, *args)
        p5 = mi.closest_hit_tlas_plain(o, d, *plain_args)
    k6 = mi.mesh_any_hit_tlas(o, d, max_t, *k6_args, occ=scene.tlas_occ)
    p6 = mi.any_hit_tlas_plain(o, d, max_t, *(k6_args[:3] + k6_args[4:]))
    torch.cuda.synchronize()
    return (k5, p5), (k6, p6)


@pytest.mark.parametrize("smooth", [False, True])
def test_tlas_kernels_match_plain(cuda, smooth):
    """K5 (flat, with_sn) and K6 on the random instanced soup: K5 and its
    plain version transform the ray and run the pair test in one order, so
    t, enc, obj and n are bit-equal (ties between two triangles at one f32
    t, where the winners could differ, do not occur on this soup); K6
    within max(2, R/2048) flips; a quarter of K6's lanes dead."""
    scene, o, d = _instanced_soup(np.random.default_rng(7), cuda, smooth)
    max_t = torch.rand((2000,), generator=torch.Generator().manual_seed(7)) * 40.0
    max_t[::4] = -1.0
    (k5, p5), (k6, p6) = _tlas_pair(scene, o, d, max_t.to(cuda))
    for got, ref in zip(k5, p5):
        assert torch.equal(got, ref)
    t, enc, obj, n = k5
    hit = enc >= 0
    assert 500 < int(hit.sum()) < 2000
    tm = scene.static.tlas_cm * scene.static.cluster_size
    assert torch.equal(obj[hit], scene.tlas.inst_obj[(enc[hit] // tm).long()])
    assert (enc // tm < 45).all()  # no padding instance ever wins
    assert int((k6 != p6).sum()) <= 2 and not k6[::4].any() and k6.any()


def test_tlas_edge_cases(cuda):
    """A ray that misses every instance box, parked rays, dead lanes
    (max_t <= 0 and NaN), R = 0 launching nothing, and bad inputs raising."""
    scene, _, _ = _instanced_soup(np.random.default_rng(8), cuda)
    o = torch.tensor([[100.0, 100.0, 100.0], [1e12, 1e12, 1e12],
                      [0.0, 0.0, -25.0], [0.0, 0.0, -25.0]], device=cuda)
    d = torch.tensor([[1.0, 0.0, 0.0], [0.5773502692] * 3, [0.0, 0.0, 1.0],
                      [0.0, 0.0, 1.0]], device=cuda)
    max_t = torch.tensor([50.0, 50.0, 0.0, float("nan")], device=cuda)
    (k5, p5), (k6, p6) = _tlas_pair(scene, o, d, max_t)
    for got, ref in zip(k5, p5):
        assert torch.equal(got, ref)
    t, enc, obj, n = k5
    assert (enc[:2] == -1).all() and (t[:2] == BIG).all()
    assert (obj[:2] == 0).all() and (n[:2] == 0).all()
    assert not k6.any() and not p6.any()

    args = _tlas_args(scene, True)
    mi.reset_launch_counts()
    empty = torch.zeros((0, 3), device=cuda)
    out = mi.mesh_closest_hit_tlas(empty, empty, *args)
    assert [tuple(x.shape) for x in out] == [(0,), (0,), (0,), (0, 3)]
    hit = mi.mesh_any_hit_tlas(empty, empty, empty[:, 0], *_tlas_args(scene, False),
                               occ=scene.tlas_occ)
    assert hit.shape == (0,)
    assert mi.LAUNCHES == dict.fromkeys(mi.LAUNCHES, 0)
    o4 = torch.zeros((4, 3), device=cuda)
    tl = scene.tlas
    with pytest.raises(ValueError, match="dtype"):
        mi.mesh_closest_hit_tlas(o4, o4, *args[:7], tl.inst_mesh.long(), *args[8:])
    with pytest.raises(ValueError, match="shape"):
        mi.mesh_closest_hit_tlas(o4, o4, *args[:3], tl.sn, *args[4:])
    with pytest.raises(ValueError, match="cm"):
        mi.mesh_closest_hit_tlas(o4, o4, *args[:-1], 3)
    with pytest.raises(ValueError, match="shape"):
        mi.mesh_any_hit_tlas(o4, o4, max_t[:3], *_tlas_args(scene, False),
                             occ=scene.tlas_occ)


@pytest.mark.parametrize("smooth", [False, True])
def test_render_herd_through_kernels_matches_plain(cuda, smooth):
    """The 3x3 herd at 128x64, depth 5: K5 and K6 render it, one launch of
    each per tile (2 tiles, one node: the herd is not reflective) and no
    other kernel; the image within the f32 budget of
    tests/test_pallas_mesh.py of the plain render, which sweeps the world
    table."""
    scene = compile_scene(cow_herd_world(3, 3, smooth), device=cuda)
    cam = _cam(128, [0, 10, -18], [0, 3, 2])
    mi.reset_launch_counts()
    img = render(scene, cam, RenderConfig(ray_tile=4096))
    k5 = "closest_hit_tlas_sn" if smooth else "closest_hit_tlas"
    assert mi.LAUNCHES == dict(dict.fromkeys(mi.LAUNCHES, 0),
                               **{k5: 2, "any_hit_tlas": 2})
    ref = render(scene, cam, RenderConfig(ray_tile=4096, mesh_impl="bruteforce"))
    assert float(img.amax()) > 0.1
    err = (img - ref).abs().amax(dim=2).flatten()
    assert float(torch.quantile(err, 0.999)) < 2e-3
    assert int((err > 0.05).sum()) <= 3


# --- the elementwise backend (K7a, K7b), K1's t0 and uv modes, streaming ---

def _k7_tables(rows, leaf, cuda):
    """K7's world-table arguments for rows (p1, e1, e2) (T, 3) f32 numpy in
    the order given: clusters of leaf rows padded to a multiple of
    SUPER_WIDTH, their boxes and the supers' (compile.py's helpers)."""
    from rtc_tpu_torch.scene import compile as compile_mod
    T = rows[0].shape[0]
    n_clusters = -(-T // leaf)
    C = -(-n_clusters // mi.SUPER_WIDTH) * mi.SUPER_WIDTH
    rows = [np.concatenate([x, np.zeros((C * leaf - T, 3), np.float32)]) for x in rows]
    aabb = compile_mod._empty_boxes(C)
    for c in range(n_clusters):
        a, b, e = (x[c * leaf:min((c + 1) * leaf, T)].astype(np.float64) for x in rows)
        verts = np.concatenate([a, a + b, a + e])
        aabb[c, :3], aabb[c, 3:] = verts.min(0), verts.max(0)
    dev = lambda x: torch.tensor(np.asarray(x, np.float32), device=cuda)
    return (*map(dev, rows), dev(aabb), dev(compile_mod._group_boxes(aabb)))


def _tied_rows(rng, leaf):
    """16 triangles, each at rows 2m and 2m + 1 (neighbouring lanes), again
    in every later 32-row round of a cluster (the same lanes) and again in
    a second cluster: the closest hit always ties, and the earliest row
    must win."""
    c = rng.uniform(-1.0, 1.0, (16, 3))
    v = [c + rng.normal(0, 1.0, (16, 3)) for _ in range(3)]
    rows = [x.astype(np.float32) for x in (v[0], v[1] - v[0], v[2] - v[0])]
    return [np.tile(np.tile(np.repeat(x, 2, axis=0), (leaf // 32, 1)), (2, 1)) for x in rows]


@pytest.mark.parametrize("where", ["soup", "teapot", "ties", "leaf 50"])
def test_elementwise_kernels_match_plain_and_k1(cuda, where):
    """K7a: t bit-equal to its plain version and to K1 (the same pair
    test), idx equal to the plain version's (both take the earliest row at
    the least t); K7b: flags equal to the plain version's and to K2's. Ray
    counts that leave a ragged last tile; K7b with every 4th lane dead
    (max_t -1, 0 or NaN) and a second run on the rays that hit, max_t past
    every hit, so whole tiles are found and leave their walk. 'ties': every
    triangle eight times (neighbouring lanes, later rounds, the next
    cluster), where K7a must return the first copy; 'leaf 50': clusters of
    50 rows, a last round of 18 lanes, staged by 4-byte copies (no K2 there:
    no occlusion tables)."""
    occ = None
    if where == "soup":
        scene, o, d = _soup(np.random.default_rng(11), 120, cuda)
        tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2, scene.cluster_aabb,
                scene.super_aabb)
        leaf, occ = scene.static.cluster_size, scene.occ
    elif where == "teapot":
        world, cam = REGISTRY["teapot"](128)
        scene = compile_scene(world, device=cuda)
        o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize,
                           cam.half_width, cam.half_height, cam.pixel_size,
                           device=cuda)
        o, d = o[:8000].contiguous(), d[:8000].contiguous()
        tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2, scene.cluster_aabb,
                scene.super_aabb)
        leaf, occ = scene.static.cluster_size, scene.occ
    else:
        rng = np.random.default_rng(12)
        leaf = 128 if where == "ties" else 50
        if where == "ties":
            rows = _tied_rows(rng, leaf)
        else:
            c = rng.uniform(-2.0, 2.0, (1500, 3))
            v = [c + rng.normal(0, 0.4, (1500, 3)) for _ in range(3)]
            rows = [x.astype(np.float32) for x in (v[0], v[1] - v[0], v[2] - v[0])]
        tabs = _k7_tables(rows, leaf, cuda)
        origin = rng.normal(size=(1000, 3))
        origin *= 8.0 / np.linalg.norm(origin, axis=1, keepdims=True)
        direction = rng.uniform(-1.5, 1.5, (1000, 3)) - origin
        direction /= np.linalg.norm(direction, axis=1, keepdims=True)
        o, d = (torch.tensor(x, dtype=torch.float32, device=cuda)
                for x in (origin, direction))
    R = o.shape[0]
    assert R % mi.ELEMENTWISE_TILE
    k7a = mi.mesh_closest_hit_elementwise(o, d, *tabs, leaf)
    t, idx = k7a
    pt, pidx = mi._closest_plain(o, d, *tabs[:3], 1e-5)
    assert torch.equal(t, pt) and torch.equal(idx, pidx)
    assert int((idx >= 0).sum()) > (300 if where in ("soup", "teapot") else 50)
    k1 = mi.mesh_closest_hit(o, d, *tabs[:3], torch.zeros_like(tabs[0]), tabs[3], leaf)
    assert torch.equal(t, k1[0])
    if where == "ties":
        p1 = tabs[0]
        hit = idx >= 0
        first = torch.tensor([int((p1 == p1[i]).all(1).nonzero()[0])
                              for i in idx[hit].tolist()], device=cuda)
        assert torch.equal(idx[hit].long(), first)
    # occlusion up to the scene's middle, or up to past the teapot
    reach = {"soup": 6.0, "teapot": 30.0}.get(where, 8.0)
    max_t = torch.full((R,), reach, device=cuda)
    max_t[::4] = torch.tensor([-1.0, 0.0, float("nan")], device=cuda).repeat(R)[:max_t[::4].numel()]
    past = torch.where(idx >= 0, t * 2.0, -1.0)      # every live lane occluded
    for mt in (max_t, past):
        hit = mi.mesh_any_hit_elementwise(o, d, mt, *tabs, leaf)
        assert torch.equal(hit, mi.any_hit_plain(o, d, mt, *tabs[:3]))
        if occ is not None:
            assert torch.equal(hit, mi.mesh_any_hit(o, d, mt, *tabs[:3], tabs[3], leaf,
                                                    occ=occ))
    hit = mi.mesh_any_hit_elementwise(o, d, max_t, *tabs, leaf)
    assert hit.any() and not hit[::4].any()
    assert torch.equal(mi.mesh_any_hit_elementwise(o, d, past, *tabs, leaf), idx >= 0)
    torch.cuda.synchronize()


def test_elementwise_bad_inputs(cuda):
    world, _ = REGISTRY["cow"](16)
    scene = compile_scene(world, device=cuda)
    o = torch.zeros((4, 3), device=cuda)
    tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2, scene.cluster_aabb)
    with pytest.raises(ValueError, match="super"):
        mi.mesh_closest_hit_elementwise(o, o, *tabs, scene.super_aabb[:-1],
                                        scene.static.cluster_size)
    mi.reset_launch_counts()
    empty = torch.zeros((0, 3), device=cuda)
    t, idx = mi.mesh_closest_hit_elementwise(empty, empty, *tabs,
                                             scene.super_aabb,
                                             scene.static.cluster_size)
    assert t.shape == (0,) and mi.LAUNCHES["closest_hit_elementwise"] == 0
    # a leaf past the rows the tile walk stages: refused by the wrapper, and
    # by the library's entry points when called past the wrapper
    leaf = mi.ELEMENTWISE_MAX_LEAF + 1
    rng = np.random.default_rng(13)
    rows = [rng.normal(size=(leaf, 3)).astype(np.float32) for _ in range(3)]
    big = _k7_tables(rows, leaf, cuda)
    max_t = torch.ones((4,), device=cuda)
    with pytest.raises(ValueError, match="leaf"):
        mi.mesh_closest_hit_elementwise(o, o, *big, leaf)
    with pytest.raises(ValueError, match="leaf"):
        mi.mesh_any_hit_elementwise(o, o, max_t, *big, leaf)
    out = torch.empty((4,), device=cuda)
    err = mi.library().rtc_closest_hit_elementwise(
        0, mi._stream(o.device), o.data_ptr(), o.data_ptr(), 4, big[0].data_ptr(),
        big[1].data_ptr(), big[2].data_ptr(), big[3].data_ptr(), big[3].shape[0],
        big[4].data_ptr(), big[4].shape[0], leaf, 1e-5, out.data_ptr(),
        torch.empty((4,), dtype=torch.int32, device=cuda).data_ptr())
    assert err != 0
    assert mi.LAUNCHES == dict.fromkeys(mi.LAUNCHES, 0)
    # the largest leaf it takes (dynamic shared memory past the 48 KB default)
    leaf = mi.ELEMENTWISE_MAX_LEAF
    tabs = _k7_tables([x[:leaf] for x in rows], leaf, cuda)
    o = torch.tensor(rng.normal(size=(300, 3)) * 0.2 - [0.0, 0.0, 6.0], dtype=torch.float32,
                     device=cuda)
    d = torch.tensor(rng.normal(size=(300, 3)) * 0.1 + [0.0, 0.0, 1.0], dtype=torch.float32,
                     device=cuda)
    d = (d / d.norm(dim=1, keepdim=True)).contiguous()
    t, idx = mi.mesh_closest_hit_elementwise(o, d, *tabs, leaf)
    pt, pidx = mi._closest_plain(o, d, *tabs[:3], 1e-5)
    assert torch.equal(t, pt) and torch.equal(idx, pidx) and bool((idx >= 0).any())
    max_t = torch.full((300,), 12.0, device=cuda)
    assert torch.equal(mi.mesh_any_hit_elementwise(o, d, max_t, *tabs, leaf),
                       mi.any_hit_plain(o, d, max_t, *tabs[:3]))


def test_t0_and_uv_modes_match_plain(cuda):
    """K1 t0 (flat payload) and K1 uv, with and without t0, against their
    plain versions on a 120-cluster soup: bounds above, at and below each
    hit, BIG, -1 and NaN. t bit-equal, idx equal off ties, the payload
    bit-equal at equal idx."""
    scene, o, d = _soup(np.random.default_rng(12), 120, cuda)
    tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2)
    leaf = scene.static.cluster_size
    t_free = mi._closest_plain(o, d, *tabs, 1e-5)[0]
    gen = torch.Generator().manual_seed(12)
    scale = (torch.rand((o.shape[0],), generator=gen) + 0.5).to(cuda)
    t0 = t_free * scale
    t0[::7] = t_free[::7]
    t0[1::11] = BIG
    t0[2::13] = -1.0
    t0[3::17] = float("nan")
    t0 = t0.contiguous()
    mi.reset_launch_counts()
    k = mi.mesh_closest_hit(o, d, *tabs, scene.tri_n, scene.cluster_aabb,
                            leaf, t0=t0)
    p = mi.closest_hit_plain(o, d, *tabs, scene.tri_n, t0=t0)
    _assert_closest_equal(k, p)
    assert 200 < int((k[1] >= 0).sum()) < int((t_free < BIG).sum())
    for bound in (None, t0):
        k = mi.mesh_closest_hit_uv(o, d, *tabs, scene.cluster_aabb, leaf,
                                   t0=bound)
        p = mi.closest_hit_uv_plain(o, d, *tabs, t0=bound)
        _assert_closest_equal(k, p)
    torch.cuda.synchronize()
    assert (mi.LAUNCHES["closest_hit_t0"], mi.LAUNCHES["closest_hit_uv"]) == (1, 2)


def test_streamed_matches_single_launch(cuda):
    """A 120-cluster soup at 2 clusters a block (60 blocks): streamed K1
    (t0 launches), K1 uv, K2 and K4 against one launch each: t bit-equal,
    flags and counts equal, the latest crossings bit-equal."""
    scene, o, d = _soup(np.random.default_rng(13), 120, cuda, n_containers=2)
    tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2)
    leaf = scene.static.cluster_size
    small = dict(block_budget=2 * leaf)
    args = (*tabs, scene.tri_n, scene.cluster_aabb, leaf)
    mi.reset_launch_counts()
    streamed = mi.mesh_closest_hit(o, d, *args, **small)
    assert mi.LAUNCHES["closest_hit_t0"] == 60
    single = mi.mesh_closest_hit(o, d, *args)
    assert torch.equal(streamed[0], single[0])
    same = streamed[1] == single[1]
    assert float(same.float().mean()) > 0.99
    assert torch.equal(streamed[2][same], single[2][same])
    uv_s = mi.mesh_closest_hit_uv(o, d, *tabs, scene.cluster_aabb, leaf, **small)
    uv_1 = mi.mesh_closest_hit_uv(o, d, *tabs, scene.cluster_aabb, leaf)
    assert torch.equal(uv_s[0], uv_1[0])
    same = uv_s[1] == uv_1[1]
    assert torch.equal(uv_s[2][same], uv_1[2][same])
    max_t = torch.full((o.shape[0],), 8.0, device=cuda)
    max_t[::5] = -1.0
    k2 = (o, d, max_t, *tabs, scene.cluster_aabb, leaf)
    occ = dict(occ=scene.occ)
    assert torch.equal(mi.mesh_any_hit(*k2, **small, **occ), mi.mesh_any_hit(*k2, **occ))
    gid = torch.where(single[1] >= 0, single[1], -2).to(torch.int32)
    for t_hit in (single[0], torch.full_like(single[0], BIG)):
        k4 = (o, d, t_hit.contiguous(), gid.contiguous(), *tabs,
              scene.cluster_aabb, scene.tri_cid, 2, leaf)
        cnt_s, last_s = mi.mesh_crossing_count(*k4, **small, **occ)
        cnt_1, last_1 = mi.mesh_crossing_count(*k4, **occ)
        assert torch.equal(cnt_s, cnt_1) and torch.equal(last_s, last_1)
    assert int(cnt_1.sum()) > 100


@pytest.mark.parametrize("name", ["cow", "cow_herd_mesh", "cow_herd_mesh_smooth",
                                  "teapot", "pumpkin"])
def test_new_routes_render_and_match_plain(cuda, name):
    """128x64, depth 5, two tiles: cow under 'elementwise' (K7a and K7b, 2
    nodes a tile); the one-mesh 3x3 herd, flat and smooth, streamed in 2
    blocks (K1 t0 or K1 uv, and K2, once per block and tile); teapot and
    pumpkin on the default path (K3 flat and with_sn). Each image within
    the f32 budget of tests/test_pallas_mesh.py of the plain render."""
    cfg = RenderConfig(ray_tile=4096)
    if name.startswith("cow_herd_mesh"):
        smooth = name.endswith("smooth")
        scene = compile_scene(cow_herd_mesh_world(3, 3, smooth), device=cuda)
        cam = _cam(128, [0, 10, -18], [0, 3, 2])
        want = {"closest_hit_uv" if smooth else "closest_hit_t0": 4,
                "any_hit": 4}
    else:
        world, cam = REGISTRY[name](128)
        scene = compile_scene(world, device=cuda)
        want = {"cow": {"closest_hit_elementwise": 4, "any_hit_elementwise": 4},
                "teapot": {"closest_shadow": 2},
                "pumpkin": {"closest_shadow_sn": 2}}[name]
        if name == "cow":
            cfg = RenderConfig(ray_tile=4096, mesh_impl="elementwise")
    mi.reset_launch_counts()
    img = render(scene, cam, cfg)
    assert mi.LAUNCHES == dict(dict.fromkeys(mi.LAUNCHES, 0), **want)
    ref = render(scene, cam, RenderConfig(ray_tile=4096, mesh_impl="bruteforce"))
    assert float(img.amax()) > 0.1
    err = (img - ref).abs().amax(dim=2).flatten()
    assert float(torch.quantile(err, 0.999)) < 2e-3
    assert int((err > 0.05).sum()) <= 3


# --- the ordered walk (K1, K3's phase 1, K5): list refills and ties ---------

EPS = 1e-5
LIGHT = (0.0, 6.9, -5.0)


def _visits(o, d, aabb, t):
    """Boxes each ray enters by its final t: what a closest-hit walk over
    them visits."""
    e = mi.box_entries(o, d, aabb)
    return ((e < BIG) & (e <= t[:, None])).sum(1)


def _walk_winner(o, d, p1, e1, e2, aabb, leaf, t0=None):
    """The row an ordered walk returns: of the rows at the least t >= 0
    (below t0), the one whose cluster comes first in (entry, cluster id)
    order, then the lowest row; -1 on a miss. The dense sweep's argmin
    takes the lowest row instead, which differs where two clusters hold a
    triangle at the same t."""
    t, valid = mi._pair_tests(o, d, p1, e1, e2, EPS)
    hit = valid & (t >= 0.0)
    if t0 is not None:
        hit &= t < t0[:, None]
    t_min = torch.where(hit, t, float("inf")).amin(1)
    tie = hit & (t == t_min[:, None])
    row_e = mi.box_entries(o, d, aabb).repeat_interleave(leaf, dim=1)
    e_min = torch.where(tie, row_e, float("inf")).amin(1)
    rows = torch.arange(p1.shape[0], device=o.device).expand_as(tie)
    first = torch.where(tie & (row_e == e_min[:, None]), rows, p1.shape[0]).amin(1)
    return torch.where(tie.any(1), first, -1).to(torch.int32)


def _fill_boxes(rng, lo, hi, leaf, size):
    """leaf random triangles inside each box [lo, hi] (n, 3): corners
    within size of a point at least size inside the box. Returns the
    tables (p1, e1, e2, tri_n, tri_sn, aabb) on the CPU, in f32."""
    n = lo.shape[0]
    base = rng.uniform(lo[:, None] + size, hi[:, None] - size, (n, leaf, 3))
    v = [base + rng.uniform(-size, size, (n, leaf, 3)) for _ in range(2)]
    f = lambda a: torch.tensor(np.asarray(a).reshape(-1, a.shape[-1]), dtype=torch.float32)
    return (f(base), f(v[0] - base), f(v[1] - base),
            f(rng.normal(size=(n, leaf, 3))), f(rng.normal(size=(n, leaf, 9))),
            f(np.concatenate([lo, hi], 1)))


def _layers(rng, cuda):
    """96 overlapping slabs stacked along z (each 2 deep, one every 0.25),
    8 triangles in each; 2,000 rays from below, tilted up to 0.1 off +z:
    a ray enters most slabs before its hit, or all it crosses on a miss."""
    k = np.arange(96)[:, None]
    lo = np.concatenate([np.full((96, 2), -4.0), 0.25 * k], 1)
    hi = np.concatenate([np.full((96, 2), 4.0), 0.25 * k + 2.0], 1)
    tabs = [x.to(cuda) for x in _fill_boxes(rng, lo, hi, 8, 0.35)]
    o = np.concatenate([rng.uniform(-3, 3, (2000, 2)), np.full((2000, 1), -5.0)], 1)
    d = np.concatenate([rng.uniform(-0.1, 0.1, (2000, 2)), np.ones((2000, 1))], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tabs, 8, *(torch.tensor(x, dtype=torch.float32, device=cuda) for x in (o, d))


def _lattice(rng, cuda):
    """Ties in entry and in t. A 4x4x4 lattice of unit cells in [-2, 2]^3,
    three times over: A, the cells themselves (neighbours share faces), 4
    triangles each; B, the same boxes and triangles in reversed rows (each
    box ties A's entry on every ray, so the id decides, and each triangle
    ties A's t); C, the cells widened by 0.02 with A's triangles rotated by
    a row (entered before A and B from outside, after them by rays that
    start inside, where every entry is 0). 2,000 rays: a quarter from
    inside the lattice, 200 along the axes in lattice planes, the rest from
    a sphere of radius 6 toward lattice points, half of them integer."""
    g = np.arange(-2.0, 2.0)
    lo = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    p1, e1, e2, n, sn, box = _fill_boxes(rng, lo, lo + 1.0, 4, 0.45)
    rows = lambda x, order: x.view(64, 4, -1)[:, order].reshape(x.shape)
    rev, rot = [3, 2, 1, 0], [1, 2, 3, 0]
    wide = box + torch.tensor([-0.02] * 3 + [0.02] * 3)
    tabs = [torch.cat([x, rows(x, rev), rows(x, rot)]) for x in (p1, e1, e2, n, sn)]
    tabs.append(torch.cat([box, box, wide]))
    R = 2000
    o = rng.normal(size=(R, 3))
    o *= 6.0 / np.linalg.norm(o, axis=1, keepdims=True)
    target = rng.uniform(-2, 2, (R, 3))
    target[::2] = np.round(target[::2])
    o[:500] = rng.uniform(-2, 2, (500, 3))
    d = target - o
    axis = np.eye(3)[rng.integers(0, 3, 200)] * rng.choice([-1.0, 1.0], (200, 1))
    o[500:700] = np.round(rng.uniform(-2, 2, (200, 3))) - 3.0 * axis
    d[500:700] = axis
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return ([x.to(cuda) for x in tabs], 4,
            *(torch.tensor(x, dtype=torch.float32, device=cuda) for x in (o, d)))


def _walk_table(where, cuda):
    """(tables (p1, e1, e2, tri_n, tri_sn, aabb), leaf, o, d) of a named
    table on the card."""
    rng = np.random.default_rng(21)
    if where == "layers":
        return _layers(rng, cuda)
    if where == "lattice":
        return _lattice(rng, cuda)
    if where == "soup":  # 26,000 triangles, 208 clusters, made as chip_smoke.py's
        centers = rng.uniform(-4.0, 4.0, (26000, 3))
        v = [centers + rng.normal(0.0, 0.2, (26000, 3)) for _ in range(3)]
        vn = [rng.normal(size=(26000, 3)) for _ in range(3)]
        scene = compile_scene(World(objects=[mesh(*v, *vn)],
                                    light=PointLight(LIGHT, (1, 1, 1))), device=cuda)
        o = rng.normal(size=(2000, 3))
        o *= 12.0 / np.linalg.norm(o, axis=1, keepdims=True)
        d = rng.uniform(-4.0, 4.0, (2000, 3)) - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o, d = _scene_rays(scene, o, d)
    else:  # the one-mesh 3x3 herd: 416 clusters, in one launch
        scene = compile_scene(cow_herd_mesh_world(3, 3, smooth=True), device=cuda)
        cam = _cam(128, [0, 10, -18], [0, 3, 2])
        o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize,
                           cam.half_width, cam.half_height, cam.pixel_size,
                           device=cuda)
    tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2, scene.tri_n,
            integrator.corner_normals(scene), scene.cluster_aabb)
    return tabs, scene.static.cluster_size, o.contiguous(), d.contiguous()


def _k1_every_mode_and_k3(tabs, leaf, o, d, cuda):
    """K1 flat, with_sn, with_t0 and with_uv (with and without t0), and K3
    flat and with_sn, in one launch each over the whole table. Returns
    ({mode: K1 outputs}, {mode: K3 outputs}, t0)."""
    p1, e1, e2, n, sn, aabb = tabs
    whole = dict(block_budget=p1.shape[0])
    t_free = mi._closest_plain(o, d, p1, e1, e2, EPS)[0]
    gen = torch.Generator().manual_seed(5)
    t0 = t_free * (torch.rand((o.shape[0],), generator=gen) + 0.5).to(cuda)
    t0[::7] = t_free[::7]
    t0[1::11] = BIG
    t0[2::13] = float("nan")
    t0 = t0.contiguous()
    k1 = {"flat": mi.mesh_closest_hit(o, d, p1, e1, e2, n, aabb, leaf, **whole),
          "sn": mi.mesh_closest_hit_sn(o, d, p1, e1, e2, sn, aabb, leaf),
          "t0": mi.mesh_closest_hit(o, d, p1, e1, e2, n, aabb, leaf, t0=t0, **whole),
          "uv": mi.mesh_closest_hit_uv(o, d, p1, e1, e2, aabb, leaf, **whole),
          "uv_t0": mi.mesh_closest_hit_uv(o, d, p1, e1, e2, aabb, leaf, t0=t0,
                                          **whole)}
    light = torch.tensor(LIGHT, device=cuda)
    occ = occlusion_tables(p1, e1, e2, aabb, leaf, cuda)
    k3 = {"flat": mi.mesh_closest_shadow(o, d, p1, e1, e2, n, aabb, light, leaf, occ=occ),
          "sn": mi.mesh_closest_shadow_sn(o, d, p1, e1, e2, sn, aabb, light, leaf,
                                          occ=occ)}
    torch.cuda.synchronize()
    return k1, k3, t0


def _assert_k3_is_split(k3, k1, tabs, leaf, o, d):
    """Fused K3 against split K1 + K2: t, idx and n equal to K1's bit for
    bit, and every shadow flag equal to K2's on the shadow rays of K1's
    hits (shadow_rays_plain, which rounds as K3's phase 2)."""
    p1, e1, e2 = tabs[:3]
    light = torch.tensor(LIGHT, device=o.device)
    for mode, unit_n in (("flat", True), ("sn", False)):
        t, idx, n, sh = k3[mode]
        assert torch.equal(t, k1[mode][0]) and torch.equal(idx, k1[mode][1])
        assert torch.equal(n, k1[mode][2])
        so, sd, max_t = mi.shadow_rays_plain(o, d, t, idx, n, light, EPS, unit_n)
        k2 = mi.mesh_any_hit(so.contiguous(), sd.contiguous(), max_t.contiguous(),
                             p1, e1, e2, tabs[5], leaf, block_budget=p1.shape[0],
                             occ=occlusion_tables(p1, e1, e2, tabs[5], leaf, o.device))
        assert torch.equal(sh, k2)


@pytest.mark.parametrize("where", ["layers", "soup", "herd_mesh"])
def test_walk_k1_every_mode_and_k3_match_plain(cuda, where):
    """The ordered walk on three tables, each in one launch: a stack of
    overlapping slabs whose rays enter more than twice the list's length
    of boxes (so the list refills at least twice), a 208-cluster soup of
    its own made as chip_smoke.py's, and the one-mesh 3x3 herd (416
    clusters). K1 in
    every mode against its plain version (t bit-equal, idx off ties, the
    payload bit-equal at equal idx); K3 flat and with_sn against split K1
    + K2 bit for bit."""
    tabs, leaf, o, d = _walk_table(where, cuda)
    p1, e1, e2, n, sn, aabb = tabs
    k1, k3, t0 = _k1_every_mode_and_k3(tabs, leaf, o, d, cuda)
    plain = {"flat": mi.closest_hit_plain(o, d, p1, e1, e2, n),
             "sn": mi.closest_hit_sn_plain(o, d, p1, e1, e2, sn),
             "t0": mi.closest_hit_plain(o, d, p1, e1, e2, n, t0=t0),
             "uv": mi.closest_hit_uv_plain(o, d, p1, e1, e2),
             "uv_t0": mi.closest_hit_uv_plain(o, d, p1, e1, e2, t0=t0)}
    for mode in k1:
        _assert_closest_equal(k1[mode], plain[mode])
    _assert_k3_is_split(k3, k1, tabs, leaf, o, d)
    hits = k1["flat"][1] >= 0
    assert int(hits.sum()) > 200
    if where == "layers":
        L = mi.walk_list()[0]  # K1's list
        visits = _visits(o, d, aabb, k1["flat"][0])
        assert float((visits > 2 * L).float().mean()) > 0.25


def test_walk_ties_follow_entry_then_id(cuda):
    """The lattice of _lattice, where boxes tie in entry and triangles tie
    in t across clusters: K1 in every mode returns the row of the cluster
    first in (entry, id) order (_walk_winner), which the dense sweep's
    lowest-row rule misses on many rays; t bit-equal to the plain version,
    the payload that row's; K3 equal to split K1 + K2."""
    tabs, leaf, o, d = _walk_table("lattice", cuda)
    p1, e1, e2, n, sn, aabb = tabs
    k1, k3, t0 = _k1_every_mode_and_k3(tabs, leaf, o, d, cuda)
    free = _walk_winner(o, d, p1, e1, e2, aabb, leaf)
    bounded = _walk_winner(o, d, p1, e1, e2, aabb, leaf, t0)
    plain = mi._closest_plain(o, d, p1, e1, e2, EPS)
    assert int((free != plain[1]).sum()) > 50  # ties the walk's order decides
    assert int((free >= 0).sum()) > 400
    for mode, want in (("flat", free), ("sn", free), ("uv", free),
                       ("t0", bounded), ("uv_t0", bounded)):
        t, idx, pay = k1[mode]
        assert torch.equal(idx, want), mode
        ref = mi._closest_plain(o, d, p1, e1, e2, EPS, t0 if want is bounded else None)
        assert torch.equal(t, ref[0]), mode
    hit = free >= 0
    assert torch.equal(k1["flat"][2][hit], n[free[hit].long()])
    blend = mi.smooth_blend(o, d, p1, e1, e2, sn, free)
    assert torch.equal(k1["sn"][2], blend)
    _assert_k3_is_split(k3, k1, tabs, leaf, o, d)


@pytest.mark.parametrize("smooth", [False, True])
def test_walk_refills_k5_match_plain(cuda, smooth):
    """K5 on 90 instances (padded to 96) packed within +-4 with small
    triangles, so that rays enter more than twice the list's length of
    instance boxes before their hit: t, enc, obj and n bit-equal to the
    plain version, which sweeps every instance."""
    scene, o, d = _instanced_soup(np.random.default_rng(23), cuda, smooth,
                                  n_inst=90, spread=4.0, size=0.02)
    args = _tlas_args(scene, True)
    plain_args = args[:4] + args[5:]
    if smooth:
        k5 = mi.mesh_closest_hit_tlas_sn(o, d, *args)
        p5 = mi.closest_hit_tlas_sn_plain(o, d, *plain_args)
    else:
        k5 = mi.mesh_closest_hit_tlas(o, d, *args)
        p5 = mi.closest_hit_tlas_plain(o, d, *plain_args)
    torch.cuda.synchronize()
    for got, ref in zip(k5, p5):
        assert torch.equal(got, ref)
    assert int((k5[1] >= 0).sum()) > 100
    L = mi.walk_list()[1]  # each of K5's lists
    visits = _visits(o, d, scene.tlas.inst_aabb, k5[0])
    assert float((visits > 2 * L).float().mean()) > 0.25


# --- the occlusion walk (K3's phase 3, K6): forced edge cases -----------------

def _lattice_mesh(rng, n=8, step=0.5):
    """One axis-aligned right triangle in each cell of an n^3 lattice of
    cells of side step from -n * step / 2: in the plane of one of the
    cell's lower faces (its axis at random), with legs along the other two
    axes, so every vertex lies on a lattice point and every box face on a
    lattice plane. Returns (p1, e1, e2, tri_n) as numpy f64, rows in cell
    order (2 slabs of cells a cluster of 128)."""
    g = np.arange(n) * step - n * step / 2
    corner = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    axis = rng.integers(0, 3, len(corner))
    eye = np.eye(3) * step
    e1, e2 = eye[(axis + 1) % 3], eye[(axis + 2) % 3]
    return corner, e1, e2, np.eye(3)[axis]


def _table(p1, e1, e2, leaf, cuda, n=None):
    """p1, e1, e2 (and n) padded to whole groups of clusters of leaf rows
    with their cluster boxes, as f32 tensors on the card."""
    T = len(p1)
    C = -(-(-(-T // leaf)) // 8) * 8
    pad = lambda a: np.concatenate([a, np.zeros((C * leaf - T, a.shape[1]))])
    p1, e1, e2 = pad(p1), pad(e1), pad(e2)
    aabb = np.tile([1.0, 1, 1, -1, -1, -1], (C, 1))
    verts = np.stack([p1, p1 + e1, p1 + e2], 1)
    for c in range(-(-T // leaf)):
        v = verts[c * leaf:min((c + 1) * leaf, T)].reshape(-1, 3)
        aabb[c] = np.concatenate([v.min(0), v.max(0)])
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda)
    out = [f(p1), f(e1), f(e2), f(aabb)]
    return out + ([f(pad(n))] if n is not None else [])


def _grazing_rays(rng, R, half):
    """R rays of the lattice's edge cases, a quarter each: in a lattice
    plane (one direction component exactly 0, so a reciprocal of +-BIG);
    along a lattice line (two components 0, of either sign); through
    lattice points; and random. Origins outside the lattice's half-width
    half, on lattice values where the ray lies in lattice planes."""
    q = R // 4
    lattice = lambda k: np.round(rng.uniform(-half, half, (k, 3)) * 2) / 2
    o, d = np.zeros((R, 3)), np.zeros((R, 3))
    axis = rng.integers(0, 3, R)
    # in a lattice plane: o on it, d without that component
    o[:q] = rng.uniform(-half, half, (q, 3))
    o[:q, 1] = 2 * half
    d[:q] = rng.normal(size=(q, 3))
    o[np.arange(q), axis[:q]] = lattice(q)[:, 0]
    d[np.arange(q), axis[:q]] = 0.0
    d[:q, 1] = -np.abs(d[:q, 1]) - 0.1
    # along a lattice line: from outside, +-e_axis
    o[q:2 * q] = lattice(q)
    sign = rng.choice([-1.0, 1.0], q)
    o[np.arange(q, 2 * q), axis[q:2 * q]] = -sign * 2 * half
    d[np.arange(q, 2 * q), axis[q:2 * q]] = sign
    # through lattice points from a sphere around the lattice
    o[2 * q:] = rng.normal(size=(R - 2 * q, 3))
    o[2 * q:] *= 3 * half / np.linalg.norm(o[2 * q:], axis=1, keepdims=True)
    target = lattice(R - 2 * q)
    target[q:] = rng.uniform(-half, half, (R - 3 * q, 3))
    d[2 * q:] = target - o[2 * q:]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _tlas_lattice(rng, cuda):
    """The lattice mesh instanced 12 times (16 slots): identity, scaled by
    0.5 (so |d'| = 2 in object space), by (1, 2, 0.5), turned a quarter
    about y, and translated by whole lattice steps; its tables, occlusion
    tables and the world->object maps."""
    leaf, cm = 128, 8
    p1, e1, e2, _ = _lattice_mesh(rng)
    p1, e1, e2, caabb = _table(p1, e1, e2, leaf, cuda)
    box = caabb[:4].cpu().numpy()
    lo, hi = box[:, :3].min(0), box[:, 3:].max(0)
    corners = np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                        for z in (lo[2], hi[2])])
    turn = np.array([[0.0, 0, 1], [0, 1, 0], [-1, 0, 0]])
    o2w = [np.eye(3), np.eye(3) * 0.5, np.diag([1.0, 2.0, 0.5]), turn] + [np.eye(3)] * 8
    shift = [np.zeros(3), np.array([4.5, 0, 0]), np.array([0, 0, 4.5]),
             np.array([-4.5, 0, 0])] + [np.array([x, 0.5 * k, z]) * 4.5
                                        for k, (x, z) in enumerate(
                                            [(1, 1), (-1, 1), (1, -1), (-1, -1),
                                             (0, 2), (2, 0), (0, -2), (-2, 0)])]
    I = 16
    inst_ab = np.tile([1.0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0], (I, 1))
    inst_aabb = np.tile([1.0, 1, 1, -1, -1, -1], (I, 1))
    for k, (m, t) in enumerate(zip(o2w, shift)):
        inv = np.linalg.inv(m)
        inst_ab[k, :9] = inv.reshape(9)
        inst_ab[k, 9:] = -inv @ t
        w = corners @ m.T + t
        inst_aabb[k] = np.concatenate([w.min(0), w.max(0)])
    f = lambda a: torch.tensor(a, dtype=torch.float32, device=cuda)
    inst_mesh = torch.zeros((I,), dtype=torch.int32, device=cuda)
    occ = occlusion_tables(p1, e1, e2, caabb, leaf, cuda, inst_aabb, inst_mesh.cpu(), 1)
    return (p1, e1, e2, caabb, f(inst_ab), f(inst_aabb), inst_mesh, leaf, cm), occ


def test_occlusion_walk_k6_edge_cases(cuda):
    """K6 on the lattice mesh instanced 12 times (scaled 0.5 and
    non-uniformly, turned, shifted by lattice steps): rays in lattice planes
    and along lattice lines (+-BIG reciprocals, grazing box faces), through
    lattice points; max_t at a triangle's own t (not occluded by it) and
    one ulp above it; dead lanes (-1, 0, NaN) and parked origins. Flags
    equal the plain sweep's on every ray: 0 flips."""
    rng = np.random.default_rng(31)
    args, occ = _tlas_lattice(rng, cuda)
    p1, e1, e2, caabb, inst_ab, inst_aabb, inst_mesh, leaf, cm = args
    o, d = _grazing_rays(rng, 4000, 9.0)
    o[:2000:7] *= 0.25  # some origins inside the instances
    o, d = (torch.tensor(x, dtype=torch.float32, device=cuda) for x in (o, d))
    plain_args = (p1, e1, e2, inst_ab, inst_aabb, inst_mesh, leaf, cm)
    t_hit = mi.closest_hit_tlas_plain(o, d, p1, e1, e2, e1, inst_ab, inst_aabb, inst_mesh,
                                      inst_mesh, leaf, cm)[0]
    lane = torch.arange(4000, device=cuda)
    special = lane % 50 < 4  # dead lanes and parked origins
    hit = (t_hit < BIG) & ~special
    at_t = hit & (lane % 3 == 1)      # max_t = the nearest triangle's t
    above = hit & (lane % 3 == 2)     # one ulp above it
    max_t = torch.full((4000,), 40.0, device=cuda)
    max_t = torch.where(at_t, t_hit, max_t)
    max_t = torch.where(above, torch.nextafter(t_hit, torch.full_like(t_hit, BIG)), max_t)
    max_t[::50], max_t[1::50], max_t[2::50] = -1.0, 0.0, float("nan")
    o[3::50] = 1e12
    o, d, max_t = o.contiguous(), d.contiguous(), max_t.contiguous()
    got = mi.mesh_any_hit_tlas(o, d, max_t, p1, e1, e2, caabb, inst_ab, inst_aabb,
                               inst_mesh, leaf, cm, occ=occ)
    ref = mi.any_hit_tlas_plain(o, d, max_t, *plain_args)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert int(hit.sum()) > 1000
    assert not got[at_t].any() and got[above].all() and not got[special].any()


def test_occlusion_walk_k3_edge_cases(cuda):
    """K3 on the lattice as a world table, its light on a lattice point
    above it, primary rays straight down in the lattice planes x = 0 and
    z = 0 (so shadow rays from horizontal faces keep a zero component and
    graze sub-box faces) and through lattice points: K3's flags equal the
    plain sweep's on its own shadow rays and K2's (the table-order loop),
    flat and with_sn; t, idx and n equal K1's."""
    rng = np.random.default_rng(32)
    p1, e1, e2, n = _lattice_mesh(rng)
    p1, e1, e2, aabb, n = _table(p1, e1, e2, 128, cuda, n)
    sn = n.repeat(1, 3).contiguous()
    R = 3000
    o = np.concatenate([rng.uniform(-2, 2, (R, 1)), np.full((R, 1), 3.0),
                        np.zeros((R, 1))], 1)
    o[::2] = o[::2, [2, 1, 0]]  # in the plane x = 0 or z = 0, as the light
    d = np.tile([0.0, -1.0, 0.0], (R, 1))
    o[2::3], d[2::3] = _grazing_rays(rng, len(o[2::3]), 2.0)
    o, d = (torch.tensor(x, dtype=torch.float32, device=cuda).contiguous() for x in (o, d))
    light = torch.tensor([0.0, 3.5, 0.0], device=cuda)
    occ = occlusion_tables(p1, e1, e2, aabb, 128, cuda)
    for payload, fn, k1, unit_n in ((n, mi.mesh_closest_shadow, mi.mesh_closest_hit, True),
                                    (sn, mi.mesh_closest_shadow_sn, mi.mesh_closest_hit_sn,
                                     False)):
        t, idx, nk, sh = fn(o, d, p1, e1, e2, payload, aabb, light, 128, occ=occ)
        ref = k1(o, d, p1, e1, e2, payload, aabb, 128)
        assert torch.equal(t, ref[0]) and torch.equal(idx, ref[1]) and torch.equal(nk, ref[2])
        so, sd, max_t = mi.shadow_rays_plain(o, d, t, idx, nk, light, EPS, unit_n)
        so, sd, max_t = so.contiguous(), sd.contiguous(), max_t.contiguous()
        assert torch.equal(sh, mi.any_hit_plain(so, sd, max_t, p1, e1, e2))
        assert torch.equal(sh, mi.mesh_any_hit(so, sd, max_t, p1, e1, e2, aabb, 128,
                                               occ=occ))
        assert int((idx >= 0).sum()) > 1500 and sh.any() and not sh[idx >= 0].all()
        assert int((sd[:, 0] == 0).sum() + (sd[:, 2] == 0).sum()) > 200


def test_occlusion_walk_every_group_entered(cuda):
    """K6 on 90 overlapping instances (12 groups) whose boxes all hold the
    origin region, rays through it with max_t past it: most rays enter
    every instance group, and the flags equal the plain sweep's (0 flips),
    with occluded and free lanes both common."""
    scene, o, d = _instanced_soup(np.random.default_rng(33), cuda, n_inst=90,
                                  spread=0.1, size=0.01)
    occ = scene.tlas_occ
    max_t = torch.full((o.shape[0],), 50.0, device=cuda)
    tmin, tmax, _ = mi.box_slabs(o, d, occ.inst_group, widen=False)
    every = ((tmax >= tmin) & (tmax >= 0.0) & (tmin < 50.0)).all(1)
    assert occ.inst_group.shape[0] == 12 and float(every.float().mean()) > 0.9
    args = _tlas_args(scene, False)
    got = mi.mesh_any_hit_tlas(o, d, max_t, *args, occ=occ)
    ref = mi.any_hit_tlas_plain(o, d, max_t, *(args[:3] + args[4:]))
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert 0.05 < float(got.float().mean()) < 0.95


def test_occlusion_kernels_raise_without_tables(cuda):
    """K3 (flat, with_sn) and K6 walk the occlusion tables: a launch without
    them raises, and so does a render of a scene that lacks them."""
    world, cam = REGISTRY["cow"](32)
    scene = compile_scene(world, device=cuda)
    tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2)
    o = torch.zeros((4, 3), device=cuda)
    leaf = scene.static.cluster_size
    with pytest.raises(ValueError, match="occlusion tables"):
        mi.mesh_closest_shadow(o, o, *tabs, scene.tri_n, scene.cluster_aabb,
                               scene.light_pos, leaf)
    with pytest.raises(ValueError, match="occlusion tables"):
        mi.mesh_closest_shadow_sn(o, o, *tabs, scene.tri_n.repeat(1, 3).contiguous(),
                                  scene.cluster_aabb, scene.light_pos, leaf)
    with pytest.raises(ValueError, match="occlusion tables"):
        render(dataclasses.replace(scene, occ=None), cam, RenderConfig())
    herd, _, _ = _instanced_soup(np.random.default_rng(34), cuda)
    with pytest.raises(ValueError, match="occlusion tables"):
        mi.mesh_any_hit_tlas(o, o, torch.ones((4,), device=cuda), *_tlas_args(herd, False))
    with pytest.raises(ValueError, match="occlusion tables"):
        render(dataclasses.replace(herd, tlas_occ=None), cam, RenderConfig())


# --- K2's occlusion walk over cluster ranges, K4's census walk ---------------

def test_k2_walk_with_and_without_a_cluster_range(cuda):
    """K2 on a 120-cluster soup, over the whole table and over cluster
    ranges whose ends fall inside a group (a streamed superblock's case),
    a fifth of the lanes dead: the flags equal any_hit_plain on the range's
    rows on every ray, one launch each."""
    scene, o, d = _soup(np.random.default_rng(40), 120, cuda)
    tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2)
    leaf = scene.static.cluster_size
    max_t = torch.full((o.shape[0],), 9.0, device=cuda)
    max_t[::5] = -1.0
    ranges = [None, (0, 120), (3, 13), (5, 61), (37, 38), (57, 120), (60, 60)]
    mi.reset_launch_counts()
    for clusters in ranges:
        got = mi.mesh_any_hit(o, d, max_t, *tabs, scene.cluster_aabb, leaf,
                              occ=scene.occ, clusters=clusters)
        c0, c1 = clusters or (0, 120)
        rows = slice(c0 * leaf, c1 * leaf)
        ref = mi.any_hit_plain(o, d, max_t, *(x[rows] for x in tabs))
        torch.cuda.synchronize()
        assert torch.equal(got, ref), clusters
        assert not got[::5].any()
        if c1 - c0 >= 56:
            assert int(got.sum()) > 50
    assert mi.LAUNCHES["any_hit"] == len(ranges)


def test_k4_census_walk_over_cluster_ranges(cuda):
    """K4 over cluster ranges of glass_teapot's table whose ends fall inside
    a group, on its primary rays and on the same rays re-seated past their
    hits (t_hit = BIG): the counts summed and the latest crossings maxed
    over a cover of ranges equal one launch and the plain sweep; the census
    fields sit on the card."""
    world, cam = REGISTRY["glass_teapot"](128)
    scene = compile_scene(world, device=cuda)
    occ, leaf = scene.occ, scene.static.cluster_size
    assert occ.row_id.device.type == occ.row_cid.device.type == "cuda"
    assert torch.equal(occ.row_cid, scene.tri_cid[occ.row_id.long()])
    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize, cam.half_width,
                       cam.half_height, cam.pixel_size, device=cuda)
    o, d = o.contiguous(), d.contiguous()
    tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2)
    t, idx, _ = mi.closest_hit_sn_plain(o, d, *tabs, integrator.corner_normals(scene))
    hit = idx >= 0
    gid = torch.where(hit, idx, -2).to(torch.int32).contiguous()
    o2 = (o + d * (torch.where(hit, t, 0.0)[:, None] + 1e-3)).contiguous()
    C = scene.static.n_clusters
    cover = [(0, 5), (5, 19), (19, 19), (19, 43), (43, C)]
    crossings = 0
    for oo, t_hit, g in ((o, torch.where(hit, t, -BIG).contiguous(), gid),
                         (o2, torch.full_like(t, BIG), torch.full_like(gid, -2))):
        args = (oo, d, t_hit, g, *tabs, scene.cluster_aabb, scene.tri_cid, 1, leaf)
        one = mi.mesh_crossing_count(*args, occ=occ)
        parts = [mi.mesh_crossing_count(*args, occ=occ, clusters=c) for c in cover]
        cnt = sum(p[0] for p in parts)
        last = torch.stack([p[1] for p in parts]).amax(0)
        ref = mi.crossing_count_plain(oo, d, t_hit, g, *tabs, scene.tri_cid, 1)
        torch.cuda.synchronize()
        assert torch.equal(one[0], ref[0]) and torch.equal(one[1], ref[1])
        assert torch.equal(cnt, ref[0]) and torch.equal(last, ref[1])
        crossings += int(cnt.sum())
    assert crossings > 100


def test_k2_k4_raise_without_tables(cuda):
    """K2 and K4 walk the occlusion tables: a launch without them raises,
    K4 also with tables built without container slots (an instanced
    scene's kind), and so does a render of glass_teapot (K2 and K4 on its
    path) without them."""
    world, cam = REGISTRY["glass_teapot"](32)
    scene = compile_scene(world, device=cuda)
    tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2)
    leaf = scene.static.cluster_size
    o = torch.zeros((4, 3), device=cuda)
    ones = torch.ones((4,), device=cuda)
    gid = torch.full((4,), -2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="occlusion tables"):
        mi.mesh_any_hit(o, o, ones, *tabs, scene.cluster_aabb, leaf)
    k4 = (o, o, ones, gid, *tabs, scene.cluster_aabb, scene.tri_cid, 1, leaf)
    with pytest.raises(ValueError, match="occlusion tables"):
        mi.mesh_crossing_count(*k4)
    bare = occlusion_tables(*tabs, scene.cluster_aabb, leaf, cuda)
    with pytest.raises(ValueError, match="container slots"):
        mi.mesh_crossing_count(*k4, occ=bare)
    with pytest.raises(ValueError, match="cluster range"):
        mi.mesh_any_hit(o, o, ones, *tabs, scene.cluster_aabb, leaf, occ=scene.occ,
                        clusters=(0, scene.static.n_clusters + 1))
    with pytest.raises(ValueError, match="occlusion tables"):
        render(dataclasses.replace(scene, occ=None), cam, RenderConfig())


# --- the closest-hit autograd Functions (render/integrator.py) ---------------

def _flat_rows(s):
    return (s.tri_p1, s.tri_e1, s.tri_e2)


def _corners(s):
    return integrator.corner_normals(s)


def _function_case(name, s):
    """(Function, kernel search, plain search, differentiable tables, lead
    arguments) of one Function on scene s, as the integrator routes it."""
    leaf, eps, I = s.static.cluster_size, EPSILON, integrator
    if name == "K7a":
        return (I.KernelClosest, lambda *x: mi.mesh_closest_hit_elementwise(
            *x, s.cluster_aabb, s.super_aabb, leaf, eps),
            lambda *x: mi._closest_plain(*x, eps), _flat_rows(s), ())
    if name == "K1 with_n":
        return (I.KernelClosestN, lambda *x: mi.mesh_closest_hit(
            *x, s.cluster_aabb, leaf, eps), lambda *x: mi.closest_hit_plain(*x, eps),
            (*_flat_rows(s), s.tri_n), ())
    if name == "K1 with_uv streamed":
        return (I.KernelClosestUv, lambda *x: mi.mesh_closest_hit_uv(
            *x, s.cluster_aabb, leaf, eps, block_budget=16 * leaf),
            lambda *x: mi.closest_hit_uv_plain(*x, eps), _flat_rows(s), ())
    if name == "K1 with_sn":
        return (I.KernelClosestSn, lambda *x: mi.mesh_closest_hit_sn(
            *x, s.cluster_aabb, leaf, eps), lambda *x: mi.closest_hit_sn_plain(*x, eps),
            (*_flat_rows(s), _corners(s)), ())
    if name == "K3":
        return (I.KernelClosestShadow, lambda *x: mi.mesh_closest_shadow(
            *x, s.cluster_aabb, s.light_pos, leaf, eps, occ=s.occ),
            lambda *x: mi.closest_shadow_plain(*x, s.light_pos, eps),
            (*_flat_rows(s), s.tri_n), ())
    if name == "K3 with_sn":
        return (I.KernelClosestShadowSn, lambda *x: mi.mesh_closest_shadow_sn(
            *x, s.cluster_aabb, s.light_pos, leaf, eps, occ=s.occ),
            lambda *x: mi.closest_shadow_sn_plain(*x, s.light_pos, eps),
            (*_flat_rows(s), _corners(s)), ())
    tl, st = s.tlas, s.static
    smooth = name == "K5 with_sn"
    kernel = mi.mesh_closest_hit_tlas_sn if smooth else mi.mesh_closest_hit_tlas
    plain = mi.closest_hit_tlas_sn_plain if smooth else mi.closest_hit_tlas_plain
    rest = (tl.inst_aabb, tl.inst_mesh, tl.inst_obj, leaf, st.tlas_cm, eps)
    return ((I.KernelClosestTlasSn if smooth else I.KernelClosestTlas),
            lambda o, d, p1, e1, e2, n, ab: kernel(o, d, p1, e1, e2, n, tl.caabb, ab,
                                                   *rest),
            lambda o, d, p1, e1, e2, n, ab: plain(o, d, p1, e1, e2, n, ab, *rest),
            (tl.p1, tl.e1, tl.e2, tl.sn if smooth else tl.n, tl.inst_ab),
            (st.tlas_cm * leaf, tl.inst_mesh))


FUNCTION_SCENES = {"K7a": "teapot", "K1 with_n": "teapot",
                   "K1 with_uv streamed": "teapot_smooth", "K1 with_sn": "teapot_smooth",
                   "K3": "teapot", "K3 with_sn": "teapot_smooth", "K5": "herd",
                   "K5 with_sn": "herd_smooth"}


def _function_scene(name, cuda):
    """The scene of a Function and its 64x32 camera rays."""
    if name.startswith("herd"):
        world = cow_herd_world(3, 3, name == "herd_smooth")
        cam = _cam(64, [0, 10, -18], [0, 3, 2])
    else:
        world, cam = REGISTRY[name](64)
    scene = compile_scene(world, device=cuda)
    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize, cam.half_width,
                       cam.half_height, cam.pixel_size, device=cuda)
    return scene, o.contiguous(), d.contiguous()


def _function_grads(fn, search, lead, inputs, w, keep):
    xs = [x.detach().clone().requires_grad_() for x in inputs]
    outs = fn.apply(search, EPSILON, *lead, *xs)
    loss = torch.where(keep & (outs[1] >= 0), outs[0], 0.0).sum()
    for vec in (y for y in outs[2:] if y.is_floating_point()):  # n or uv
        loss = loss + torch.where(keep[:, None], vec * w[:, :vec.shape[1]], 0.0).sum()
    return outs, torch.autograd.grad(loss, xs)


@pytest.mark.parametrize("name", list(FUNCTION_SCENES))
def test_function_grads_kernel_vs_plain_forward(cuda, name):
    """Each Function with its kernel as the forward against the same
    Function with the kernel's plain version as the forward, on the same
    rays: equal outputs (winners may differ only at ties), and equal
    gradients with respect to every input on the rays whose winner
    agrees, at rtc_tpu's tolerances."""
    scene, o, d = _function_scene(FUNCTION_SCENES[name], cuda)
    fn, kernel, plain, tabs, lead = _function_case(name, scene)
    with torch.no_grad():
        k, p = kernel(o, d, *tabs), plain(o, d, *tabs)
    assert torch.equal(k[1] >= 0, p[1] >= 0) and int((k[1] >= 0).sum()) > 100
    keep = k[1] == p[1]
    assert float(keep.float().mean()) > 0.99
    w = torch.randn((o.shape[0], 3), generator=torch.Generator(cuda).manual_seed(0),
                    device=cuda)
    mi.reset_launch_counts()
    ko, kg = _function_grads(fn, kernel, lead, (o, d, *tabs), w, keep)
    assert sum(mi.LAUNCHES.values()) >= 1
    po, pg = _function_grads(fn, plain, lead, (o, d, *tabs), w, keep)
    assert torch.equal(ko[0], k[0]) and torch.equal(ko[1], k[1])
    for a, b in zip(kg, pg):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-5)
    assert any(float(g.abs().sum()) > 0 for g in kg[2:])


def test_inject_rows_refreshes_kernel_tables(cuda):
    """inject_params moving the triangles of the clusters the camera sees
    most: K1, K2 and K3 on the new scene equal their plain versions on the
    new rows; the rows swapped in without the rebuild (stale boxes and
    occlusion tables) do not."""
    world, cam = REGISTRY["cow"](64)
    scene = compile_scene(world, device=cuda)
    leaf = scene.static.cluster_size
    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize, cam.half_width,
                       cam.half_height, cam.pixel_size, device=cuda)
    o, d = o.contiguous(), d.contiguous()
    idx = mi.closest_hit_plain(o, d, *_flat_rows(scene), scene.tri_n)[1]
    seen = torch.bincount(idx[idx >= 0].long() // leaf).argsort(descending=True)[:4]
    rows = (seen[:, None] * leaf + torch.arange(leaf, device=cuda)).flatten()
    p1 = scene.tri_p1.clone()
    p1[rows] += torch.tensor([0.0, 0.3, -0.2], device=cuda)
    new = RG.inject_params(scene, {"tri_p1": p1})
    stale = dataclasses.replace(scene, tri_p1=p1)

    def k3_gaps(s):
        """Rays where K1's and K3's winners, and K3's shadow flags, differ
        from the plain versions' on the new rows."""
        args = (*_flat_rows(s), s.tri_n)
        k1 = mi.mesh_closest_hit(o, d, *args, s.cluster_aabb, leaf)
        k3 = mi.mesh_closest_shadow(o, d, *args, s.cluster_aabb, s.light_pos, leaf,
                                    occ=s.occ)
        p3 = mi.closest_shadow_plain(o, d, *_flat_rows(new), new.tri_n, new.light_pos)
        return k3, (int((k1[1] != p3[1]).sum()), int((k3[1] != p3[1]).sum()),
                    int((k3[3] != p3[3]).sum()))

    k3, gaps = k3_gaps(new)
    assert gaps[:2] == (0, 0) and gaps[2] <= 2
    assert sum(k3_gaps(stale)[1]) > 2
    # K2 walks the same rebuilt tables: K3's flags on K3's own shadow rays
    so, sd, max_t = mi.shadow_rays_plain(o, d, *k3[:3], new.light_pos)
    k2 = mi.mesh_any_hit(so.contiguous(), sd.contiguous(), max_t.contiguous(),
                         *_flat_rows(new), new.cluster_aabb, leaf, occ=new.occ)
    assert torch.equal(k2, k3[3])


@pytest.mark.parametrize("n", [2, 3])
def test_prim_shard_kernels_on_own_tables_match_plain(cuda, n):
    """glass_teapot padded and cut into n prim shards
    (rtc_tpu_torch.parallel.shard): on each shard, K1 with_sn, K2 on the
    shard's own occlusion tables and K4 on its census fields (hit rows
    rebased to the shard, -2 where another shard holds them) against their
    plain versions on the shard's rows; and over the shards, the least t,
    the OR of K2 and the summed K4 counts and maxed latest crossings equal
    the whole table's launches (t bit-equal, counts exact)."""
    from rtc_tpu_torch.parallel.shard import pad_tris, shard_scene

    world, cam = REGISTRY["glass_teapot"](128)
    scene = compile_scene(world, device=cuda)
    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize, cam.half_width,
                       cam.half_height, cam.pixel_size, device=cuda)
    o, d = o.contiguous(), d.contiguous()
    leaf = scene.static.cluster_size

    def tabs(s):
        return s.tri_p1, s.tri_e1, s.tri_e2

    t, idx, _ = mi.mesh_closest_hit_sn(o, d, *tabs(scene), integrator.corner_normals(scene),
                                       scene.cluster_aabb, leaf)
    hit = idx >= 0
    gid = torch.where(hit, idx, -2).to(torch.int32)
    o2 = (o + d * (torch.where(hit, t, 0.0)[:, None] + 1e-3)).contiguous()
    sets = [(o, torch.where(hit, t, -BIG).contiguous(), gid),
            (o2, torch.full_like(t, BIG), torch.full_like(gid, -2))]
    # K2 from just past each hit (o2): the glass teapot's far walls lie
    # within max_t of many of them; from the camera (o) nothing does
    max_t = torch.full_like(t, 3.0)
    whole_k2 = mi.mesh_any_hit(o2, d, max_t, *tabs(scene), scene.cluster_aabb, leaf,
                               occ=scene.occ)
    whole_k4 = [mi.mesh_crossing_count(oo, d, tt, gg, *tabs(scene), scene.cluster_aabb,
                                       scene.tri_cid, 1, leaf, occ=scene.occ)
                for oo, tt, gg in sets]
    padded = pad_tris(scene, n)
    best = torch.full_like(t, BIG)
    k2_any = torch.zeros_like(whole_k2)
    k4_sum = [(torch.zeros_like(c), torch.full_like(l, -BIG)) for c, l in whole_k4]
    for index in range(n):
        s = shard_scene(padded, index, n)
        snc = integrator.corner_normals(s)
        _assert_closest_equal(
            mi.mesh_closest_hit_sn(o, d, *tabs(s), snc, s.cluster_aabb, leaf),
            mi.closest_hit_sn_plain(o, d, *tabs(s), snc))
        best = torch.minimum(best, mi.mesh_closest_hit_sn(o, d, *tabs(s), snc,
                                                          s.cluster_aabb, leaf)[0])
        k2 = mi.mesh_any_hit(o2, d, max_t, *tabs(s), s.cluster_aabb, leaf, occ=s.occ)
        assert torch.equal(k2, mi.any_hit_plain(o2, d, max_t, *tabs(s)))
        k2_any |= k2
        for k, (oo, tt, gg) in enumerate(sets):
            local = gg - s.tri_offset
            local = torch.where((local >= 0) & (local < s.tri_p1.shape[0]), local, -2)
            local = local.to(torch.int32).contiguous()
            cnt, last = mi.mesh_crossing_count(oo, d, tt, local, *tabs(s), s.cluster_aabb,
                                               s.tri_cid, 1, leaf, occ=s.occ)
            pcnt, plast = mi.crossing_count_plain(oo, d, tt, local, *tabs(s), s.tri_cid, 1)
            assert torch.equal(cnt, pcnt) and torch.equal(last, plast)
            k4_sum[k] = (k4_sum[k][0] + cnt, torch.maximum(k4_sum[k][1], last))
    torch.cuda.synchronize()
    assert torch.equal(best, t)
    assert torch.equal(k2_any, whole_k2) and bool(whole_k2.any())
    for (cnt, last), (wcnt, wlast) in zip(k4_sum, whole_k4):
        assert torch.equal(cnt, wcnt) and torch.equal(last, wlast)
    assert int(whole_k4[1][0].sum()) > 100


def test_intersect_all_matches_k1_on_cow(cuda):
    """The book API on the card: hit_index(intersect_all(...)) on a
    2,048-ray cow wavefront in f32, held to one K1 with_n launch on every
    ray: equal hit masks, |dt| <= 1e-3 (bit-equal expected: both evaluate
    the same Möller-Trumbore), and the hit's object is the winner's."""
    world, cam = REGISTRY["cow"](128)
    scene = compile_scene(world, device=cuda)
    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize, cam.half_width,
                       cam.half_height, cam.pixel_size, device=cuda)
    o, d = o[::4].contiguous(), d[::4].contiguous()
    assert o.shape[0] == 2048
    xs = intersect_all(scene, o, d, RenderConfig(), k=8)
    i = hit_index(xs)
    hit = i >= 0
    rows = torch.arange(o.shape[0], device=cuda)
    t = torch.where(hit, xs.t[rows, i.clamp_min(0).long()], BIG)
    obj = xs.obj[rows, i.clamp_min(0).long()]
    kt, kidx, _ = mi.mesh_closest_hit(o, d, scene.tri_p1, scene.tri_e1, scene.tri_e2,
                                      scene.tri_n, scene.cluster_aabb,
                                      scene.static.cluster_size)
    torch.cuda.synchronize()
    assert torch.equal(hit, kidx >= 0) and int(hit.sum()) > 200
    assert float((t - kt).abs()[hit].max()) <= 1e-3
    assert torch.equal(obj[hit], scene.tri_obj[kidx[hit].long()])


def test_camera_rays_follow_a_card_matrix(cuda):
    """A camera matrix on the card gives rays on the card, bit for bit
    those of camera_rays_for_pixels."""
    _, cam = REGISTRY["cow"](64)
    args = (cam.hsize, cam.vsize, cam.half_width, cam.half_height, cam.pixel_size)
    inv = torch.tensor(cam.transform_inverse, dtype=torch.float32, device=cuda)
    o, d = camera_rays(inv, *args)
    assert o.is_cuda and d.is_cuda
    idx = torch.arange(cam.hsize * cam.vsize, device=cuda)
    po, pd = camera_rays_for_pixels(inv, idx % cam.hsize, idx // cam.hsize, *args[2:])
    assert torch.equal(o, po) and torch.equal(d, pd)


def test_book_helpers_on_the_card(cuda):
    """The testing helpers on the card in f64 give the book's numbers, and
    a singular matrix's inverse there is not finite, without an error."""
    scene = compile_scene(default_world(), dtype=torch.float64, device=cuda)
    want = np.array([0.38066, 0.47583, 0.2855])
    np.testing.assert_allclose(testing.color_at_single(scene, [0, 0, -5], [0, 0, 1]), want,
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(testing.shade_hit(scene, [0, 0, -5], [0, 0, 1], 4.0, 0), want,
                               atol=1e-5, rtol=0)
    assert testing.is_shadowed(scene, [10, -10, 10])
    assert not testing.is_shadowed(scene, [-2, 2, -2])
    a = torch.tensor([[-4, 2, -2, -3], [9, 6, 2, 6], [0, -5, 1, -5], [0, 0, 0, 0]],
                     dtype=torch.float64, device=cuda)
    assert not bool(torch.isfinite(matrices.inverse(a)).all())


# --- the compiled frame (render/compiled.py) ---------------------------------

GRAPHED_FRAMES = {"cow": ("cow", "auto"), "cow elementwise": ("cow", "elementwise"),
                  "teapot_smooth": ("teapot_smooth", "auto"),
                  "glass_teapot": ("glass_teapot", "auto"), "cow_herd": ("cow_herd", "auto"),
                  "table": ("table", "auto"), "cow bruteforce": ("cow", "bruteforce")}


@pytest.mark.parametrize("frame", list(GRAPHED_FRAMES))
def test_graphed_frame_is_bit_equal_to_eager(cuda, frame):
    """128x64 in two tiles: the first graphed call (its eager run, then the
    capture) and a replay equal the eager frame bit for bit, and the
    replay launches each kernel as often as the eager frame."""
    name, impl = GRAPHED_FRAMES[frame]
    world, cam = REGISTRY[name](128)
    scene = compile_scene(world, device=cuda)
    cfg = RenderConfig(ray_tile=4096, mesh_impl=impl)
    assert compiled.route(scene, cfg) == compiled.GRAPHED
    with compiled.eager():
        mi.reset_launch_counts()
        want = render(scene, cam, cfg)
        eager = dict(mi.LAUNCHES)
    compiled.clear()
    captures = compiled.COUNTS["captures"]
    first = render(scene, cam, cfg)
    mi.reset_launch_counts()
    got = render(scene, cam, cfg)
    torch.cuda.synchronize()
    assert compiled.COUNTS["captures"] == captures + 1
    assert torch.equal(first, want) and torch.equal(got, want)
    assert dict(mi.LAUNCHES) == eager
    assert any(eager.values()) == (name != "table" and impl != "bruteforce")
    compiled.clear()


def test_two_cameras_make_one_capture(cuda):
    """A second camera on the canvas replays the first camera's graph with
    its own values, and each frame equals its eager frame; a new canvas
    captures anew."""
    world, cam = REGISTRY["cow"](128)
    scene = compile_scene(world, device=cuda)
    cam2 = Camera(cam.hsize, cam.vsize, cam.field_of_view).set_transform(
        cam.transform @ X.rotation_y(0.2))
    cfg = RenderConfig()
    with compiled.eager():
        want = [render(scene, c, cfg) for c in (cam, cam2)]
    assert not torch.equal(*want)
    compiled.clear()
    captures = compiled.COUNTS["captures"]
    for c, w in ((cam, want[0]), (cam2, want[1]), (cam, want[0]), (cam2, want[1])):
        assert torch.equal(render(scene, c, cfg), w)
    assert compiled.COUNTS["captures"] == captures + 1
    assert compiled.graph_for(scene, ("frame", (64, 128), cfg)).replays == 3
    render(scene, REGISTRY["cow"](64)[1], cfg)
    assert compiled.COUNTS["captures"] == captures + 2
    compiled.clear()


def test_a_replay_after_nine_other_canvases_is_bit_equal(cuda):
    """A frame's graph holds its pixel order: after nine other canvases
    push that order out of pixel_order's cache (one of them under the
    device string 'cuda', a key of its own) and the freed memory is
    written over, a replay still equals the eager frame bit for bit.
    80x40 is no multiple of 16, so the order has its un-permute gather."""
    from rtc_tpu_torch.render import renderer

    world, cam = REGISTRY["cow"](80)
    scene = compile_scene(world, device=cuda)
    cfg = RenderConfig()
    with compiled.eager():
        want = render(scene, cam, cfg)
    compiled.clear()
    render(scene, cam, cfg)
    graph = compiled.graph_for(scene, ("frame", (40, 80), cfg))
    order = renderer.pixel_order(40, 80, "morton", scene.tri_p1.device)
    assert graph.keep is order and order[3] is not None
    renderer.pixel_order(40, 80, "morton", "cuda")
    for width in range(96, 96 + 8 * 16, 16):
        renderer.pixel_order(width // 2, width, "morton", scene.tri_p1.device)
    assert renderer.pixel_order(40, 80, "morton", scene.tri_p1.device) is not order
    junk = [torch.full((40 * 80,), 2**40, dtype=torch.int64, device=cuda)
            for _ in range(64)]
    assert torch.equal(render(scene, cam, cfg), want)
    assert torch.equal(render(scene, cam, cfg), want)
    del junk
    compiled.clear()


def test_progressive_tiles_replay_one_graph(cuda):
    world, cam = REGISTRY["glass_teapot"](128)
    scene = compile_scene(world, device=cuda)
    cfg = RenderConfig(ray_tile=1024)
    with compiled.eager():
        mi.reset_launch_counts()
        want = [c for _, _, c in progressive.render_tiles(scene, cam, cfg)]
        eager = dict(mi.LAUNCHES)
    compiled.clear()
    mi.reset_launch_counts()
    got = [c for _, _, c in progressive.render_tiles(scene, cam, cfg)]
    assert len(got) == 8 and all(np.array_equal(a, b) for a, b in zip(got, want))
    assert dict(mi.LAUNCHES) == eager
    assert compiled.graph_for(scene, ("tile", 1024, cfg)).replays == 7
    compiled.clear()


def test_streamed_table_renders_eagerly(cuda):
    """The one-mesh 3x3 herd streams its table (two superblocks): its frame
    takes the eager route and captures nothing."""
    scene = compile_scene(cow_herd_mesh_world(3, 3), device=cuda)
    cam = _cam(128, [0, 10, -18], [0, 3, 2])
    cfg = RenderConfig(ray_tile=4096)
    assert compiled.route(scene, cfg).startswith("eager: a streamed table")
    captures = compiled.COUNTS["captures"]
    img = render(scene, cam, cfg)
    assert compiled.COUNTS["captures"] == captures and float(img.amax()) > 0.1


def test_a_capture_that_meets_a_host_sync_raises(cuda, monkeypatch):
    """A host sync in a graphed frame raises CaptureError, chained to the
    operation that broke the capture: no fallback to the eager frame, and
    no graph is kept. The card works on afterwards."""
    world, cam = REGISTRY["cow"](64)
    scene = compile_scene(world, device=cuda)
    record = integrator.object_record

    def synced(scene, obj):
        rec = record(scene, obj)
        rec["ambient"] = rec["ambient"] * float(rec["ambient"].amax())
        return rec

    monkeypatch.setattr(integrator, "object_record", synced)
    cfg = RenderConfig()
    compiled.clear()
    with pytest.raises(compiled.CaptureError, match="capturing the 64x32 frame failed"):
        render(scene, cam, cfg)
    assert compiled.graph_for(scene, ("frame", (32, 64), cfg)) is None
    monkeypatch.undo()
    with compiled.eager():
        want = render(scene, cam, cfg)
    assert torch.equal(render(scene, cam, cfg), want)
    assert torch.equal(render(scene, cam, cfg), want)
    compiled.clear()


def test_graphed_frame_spans_under_the_profiler(cuda):
    """A graphed cow frame's first call and a replay under torch.profiler
    (recording on while it runs): the capture's rtc.graph.warm and
    rtc.graph.capture and the replay's rtc.graph.replay are in the
    in-memory record, under rtc.render, and among the profiler's host
    events; the spans' device side is a user annotation, which
    profiling.device_ops leaves out."""
    from torch.autograd import DeviceType

    world, cam = REGISTRY["cow"](128)
    scene = compile_scene(world, device=cuda)
    cfg = RenderConfig()
    compiled.clear()
    profiling.take_spans()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        render(scene, cam, cfg)
        render(scene, cam, cfg)
        torch.cuda.synchronize()
    spans = profiling.take_spans().spans
    names = ("rtc.graph.warm", "rtc.graph.capture", "rtc.graph.replay")
    for name in names:
        (s,) = [s for s in spans if s.name == name]
        assert spans[s.parent].name == "rtc.render" and s.end_ns > s.start_ns, name
    events = prof.events()
    host = {e.name for e in events if e.device_type == DeviceType.CPU}
    assert set(names) <= host
    assert all(e.is_user_annotation for e in events
               if e.device_type == DeviceType.CUDA and e.name.startswith("rtc."))
    ops = profiling.device_ops(events)
    assert ops and not any(e.name.startswith("rtc.") for e in ops)
    compiled.clear()


# --- the compiled gradient step (diff/render_grad.py through compiled.py) ----

PERTURB = {"mat_color": -0.3, "light_intensity": -0.3}


def _grad_setup(cuda, width=128):
    """The cow at width: its scene, a fused config, the camera's rays and
    a target rendered with PERTURB's lowered material and light."""
    world, cam = REGISTRY["cow"](width)
    scene = compile_scene(world, device=cuda)
    cfg = RenderConfig(mesh_impl="kernel")
    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize, cam.half_width,
                       cam.half_height, cam.pixel_size, device=cuda)
    o, d = o.contiguous(), d.contiguous()
    base = RG.extract_params(scene)
    with torch.no_grad():
        target = integrator.color_at(RG.inject_params(
            scene, {k: base[k].detach() + v for k, v in PERTURB.items()}), o, d, cfg)
    return scene, cfg, o, d, target


def _assert_within_eager_spread(got, runs):
    """Bit-equal to the first eager run where the eager runs agree bit for
    bit; elsewhere within twice their largest difference."""
    ref = compiled.tensors(runs[0])
    spread = max(float((a - b).abs().max())
                 for r in runs[1:] for a, b in zip(compiled.tensors(r), ref))
    err = max(float((a - b).abs().max()) for a, b in zip(compiled.tensors(got), ref))
    assert err <= 2 * spread, (err, spread)


def test_graphed_loss_and_grad_equals_eager(cuda):
    """The cow at 128x64 with the material, light, patterns and tri_n as
    parameters (so K3's Function pulls its backward inside the graph): the
    first call (its eager run, then the capture) and replays with other
    rays equal the eager calls, one capture in all."""
    scene, cfg, o, d, target = _grad_setup(cuda)
    params = RG.extract_params(scene, RG.DEFAULT_PARAMS + ("tri_n",))
    assert compiled.step_route(scene, cfg, params) == compiled.GRAPHED
    waves = [(o, d, target), (o.flip(0).contiguous(), d.flip(0).contiguous(), target)]
    with compiled.eager():
        want = [[RG.loss_and_grad(params, scene, *w, cfg) for _ in range(3)] for w in waves]
    compiled.clear()
    captures = compiled.COUNTS["captures"]
    for k in (0, 1, 0):
        got = RG.loss_and_grad(params, scene, *waves[k], cfg)
        _assert_within_eager_spread(got, want[k])
    assert compiled.COUNTS["captures"] == captures + 1
    assert float(got[1]["tri_n"].abs().sum()) > 0
    compiled.clear()


def _adam_steps(scene, cfg, o, d, target, steps=4):
    params = RG.extract_params(scene, tuple(PERTURB))
    step = RG.make_train_step(torch.optim.Adam(params.values(), lr=5e-2, capturable=True),
                              cfg)
    out = []
    for _ in range(steps):
        loss = step(params, scene, o, d, target)
        out.append((loss, {k: v.detach().clone() for k, v in params.items()}))
    return out


def test_graphed_adam_step_follows_the_eager_trajectory(cuda):
    """Four Adam steps (capturable=True) graphed take the eager steps: the
    first call one step, each replay one more, and the loss falls."""
    scene, cfg, o, d, target = _grad_setup(cuda)
    with compiled.eager():
        want = [_adam_steps(scene, cfg, o, d, target) for _ in range(2)]
    compiled.clear()
    captures = compiled.COUNTS["captures"]
    got = _adam_steps(scene, cfg, o, d, target)
    assert compiled.COUNTS["captures"] == captures + 1
    _assert_within_eager_spread(got, want)
    losses = [float(x) for x, _ in got]
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    compiled.clear()


def test_a_grad_replay_after_other_graphs_is_equal(cuda):
    """loss_and_grad's graph and a train step's, then two frame graphs on
    other canvases (the cache full), the freed memory written over:
    replays of both still equal the eager calls."""
    scene, cfg, o, d, target = _grad_setup(cuda, 80)
    params = RG.extract_params(scene)
    with compiled.eager():
        want = [RG.loss_and_grad(params, scene, o, d, target, cfg) for _ in range(3)]
        want_steps = [_adam_steps(scene, cfg, o, d, target, 3) for _ in range(2)]
    compiled.clear()
    RG.loss_and_grad(params, scene, o, d, target, cfg)
    trained = RG.extract_params(scene, tuple(PERTURB))
    step = RG.make_train_step(torch.optim.Adam(trained.values(), lr=5e-2, capturable=True),
                              cfg)
    steps = [(step(trained, scene, o, d, target),
              {k: v.detach().clone() for k, v in trained.items()})]
    for width in (96, 112):
        render(scene, REGISTRY["cow"](width)[1], RenderConfig())
    assert len(compiled._CACHE) == compiled.MAX_GRAPHS
    junk = [torch.full((1 << 20,), 2**40, dtype=torch.int64, device=cuda) for _ in range(64)]
    _assert_within_eager_spread(RG.loss_and_grad(params, scene, o, d, target, cfg), want)
    for _ in range(2):
        steps.append((step(trained, scene, o, d, target),
                      {k: v.detach().clone() for k, v in trained.items()}))
    _assert_within_eager_spread(steps, want_steps)
    del junk
    compiled.clear()


def test_gradient_eager_routes(cuda):
    """Triangle rows among the parameters, an Adam with capturable=False
    and eager() take the eager route, and capture nothing."""
    scene, cfg, o, d, target = _grad_setup(cuda, 64)
    compiled.clear()
    compiled.ROUTES.clear()
    captures = compiled.COUNTS["captures"]
    RG.loss_and_grad(RG.extract_params(scene, ("mat_color", "tri_p1")), scene, o, d,
                     target, cfg)
    mat = RG.extract_params(scene, ("mat_color",))
    RG.make_train_step(torch.optim.Adam(mat.values()), cfg)(mat, scene, o, d, target)
    with compiled.eager():
        RG.loss_and_grad(mat, scene, o, d, target, cfg)
    assert compiled.COUNTS["captures"] == captures and not compiled._CACHE
    assert sorted(compiled.ROUTES) == sorted([
        "loss_and_grad: eager: geometry parameters tri_p1 (inject_params rebuilds the "
        "boxes and occlusion tables on the host, derived_tables)",
        "train_step: eager: Adam with capturable=False (its step count lives on the host)",
        "loss_and_grad: " + compiled.EAGER_CONTEXT])


# --- cuBLAS launches in the shading glue --------------------------------------

def _cublas_launches(fn) -> int:
    """The cuBLAS kernels (gemv or gemm in their names) among the device
    operations of fn() under torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    ops = profiling.device_ops(prof.events())
    assert ops, "the profiler recorded no device operation"
    return sum("gemv" in e.name or "gemm" in e.name for e in ops)


def _prim_rays_by_component(inv, o, d):
    """integrator._local_rays with the prims' shared matrices (N, 3, 4)
    applied by component: (R, N, 3) each."""
    ox, oy, oz = (c[:, None, None] for c in o.unbind(1))
    dx, dy, dz = (c[:, None, None] for c in d.unbind(1))
    m = inv.unbind(-1)
    return (m[0] * ox + m[1] * oy + m[2] * oz + m[3], m[0] * dx + m[1] * dy + m[2] * dz)


def _glue_cublas_launches(name, cuda):
    """cuBLAS launches in a replay of a graphed 64x32 frame and of a graphed
    Adam step (the material color and the light, capturable) of a
    registry scene."""
    world, cam = REGISTRY[name](64)
    scene = compile_scene(world, device=cuda)
    cfg = RenderConfig()
    compiled.clear()
    render(scene, cam, cfg)
    frame = _cublas_launches(lambda: render(scene, cam, cfg))
    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize, cam.half_width,
                       cam.half_height, cam.pixel_size, device=cuda)
    o, d = o.float().contiguous(), d.float().contiguous()
    target = torch.full_like(o, 0.25)
    params = RG.extract_params(scene, tuple(PERTURB))
    step = RG.make_train_step(torch.optim.Adam(params.values(), lr=5e-2, capturable=True),
                              cfg)
    step(params, scene, o, d, target)
    stepped = _cublas_launches(lambda: step(params, scene, o, d, target))
    assert compiled.route(scene, cfg) == compiled.GRAPHED
    assert compiled.step_route(scene, cfg, params) == compiled.GRAPHED
    compiled.clear()
    return frame, stepped


def test_shading_glue_launches_no_cublas_beyond_cow(cuda, monkeypatch):
    """glass_teapot's shading nodes (a plane with checkers, so normal_at's
    two products and the pattern's in each) launch no more cuBLAS kernels
    than cow's, in a graphed frame and a graphed step: cow's are the
    camera's shared product. The prim sweep's shared product
    (_local_rays, one gemm a sweep, which cow has not) is applied by
    component in both scenes for this count."""
    monkeypatch.setattr(integrator, "_local_rays", _prim_rays_by_component)
    glass = _glue_cublas_launches("glass_teapot", cuda)
    cow = _glue_cublas_launches("cow", cuda)
    assert glass[0] <= cow[0] and glass[1] <= cow[1], (glass, cow)


# --- the object rows' sum (object_record's gradient) --------------------------

FRAME_RAYS = 1920 * 960
# the fit cells' parameter (mat_color) and DEFAULT_PARAMS' per-object fields
# (pat_a, pat_b, mat_color and the seven scalars)
ROW_WIDTHS = {3: (3,), 16: (3, 3, 3, 1, 1, 1, 1, 1, 1, 1)}


def _rows_case(n_rows, k, ids, cuda, dyadic, seed=0):
    """ids (R,) int32, uniform over n_rows or all on the last row, and one
    (R, w) gradient a field of ROW_WIDTHS[k] (a (R,) one for width 1).
    dyadic: multiples of 1/16 in [-1/2, 1/2], so every partial sum of a
    frame's rays (|sum| < 2**20) is exact in float32 and any order gives
    the same bits; else normal values."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    R = FRAME_RAYS
    obj = (torch.randint(0, n_rows, (R,), generator=gen, device=cuda, dtype=torch.int32)
           if ids == "uniform" else torch.full((R,), n_rows - 1, dtype=torch.int32,
                                               device=cuda))
    grads = []
    for w in ROW_WIDTHS[k]:
        shape = (R, w) if w > 1 else (R,)
        g = (torch.randint(-8, 9, shape, generator=gen, device=cuda).float() / 16 if dyadic
             else torch.randn(shape, generator=gen, device=cuda))
        grads.append(g)
    return obj, grads


@pytest.mark.parametrize("ids", ["uniform", "one object"])
@pytest.mark.parametrize("k", [3, 16])
@pytest.mark.parametrize("n_rows", [1, 2, 90])
def test_object_rows_kernel_matches_index_add(cuda, n_rows, k, ids):
    """The kernel against its index_add_ twin over a 1920x960 frame's rays:
    on dyadic gradients, where every order of float32 sums is exact, bit
    for bit; on normal ones against the float64 sum, within 4e-6 of the
    entry's sum of |g|: the kernel adds in float32 in another order, at
    most ~57 roundings deep (a warp's butterfly and its ~7 batches, 8 warps,
    33 partials a lane and a butterfly over ~1,000 blocks), each at most
    2**-24 of a partial sum no larger than that sum of |g|; and two runs
    give the same bits."""
    for dyadic in (True, False):
        obj, grads = _rows_case(n_rows, k, ids, cuda, dyadic)
        launches = mi.LAUNCHES["object_rows"]
        got = mi.object_rows_sum(obj, grads, n_rows)
        again = mi.object_rows_sum(obj, grads, n_rows)
        assert mi.LAUNCHES["object_rows"] == launches + 2
        twin = mi.object_rows_sum_plain(obj, grads, n_rows)
        exact = mi.object_rows_sum_plain(obj, [g.double() for g in grads], n_rows)
        torch.cuda.synchronize()
        for a, b, t, x, g in zip(got, again, twin, exact, grads):
            assert a.shape == t.shape == (n_rows, *g.shape[1:]) and torch.equal(a, b)
            if dyadic:
                assert torch.equal(a, t) and torch.equal(a.double(), x)
            else:
                scale = mi.object_rows_sum_plain(obj, [g.double().abs()], n_rows)[0]
                assert bool(((a.double() - x).abs() <= 4e-6 * scale).all())


def test_object_rows_kernel_replays_from_a_graph(cuda):
    """One capture of the kernel into a CUDA graph (its scratch from the
    graph's pool) and its replay give the eager call's bits."""
    obj, grads = _rows_case(2, 16, "uniform", cuda, dyadic=False, seed=1)
    eager = mi.object_rows_sum(obj, grads, 2)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        mi.object_rows_sum(obj, grads, 2)  # warm-up off the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        held = mi.object_rows_sum(obj, grads, 2)
    for x in held:
        x.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(held, eager))


def test_object_rows_path_and_its_span(cuda):
    """On the card the kernel takes every float32 input, and its span says
    so: 1,000 rows x 16 columns (512 KB of accumulators, past a block's
    shared memory: tiles of columns) and 10,000 x 3 (tiles of rows too),
    1,000 x 3 (dynamic shared memory past 48 KB), 2 x 3, and a few rays or
    one; bit-equal to the twin on dyadic gradients. float64 gradients on
    the card raise, and the CPU takes the twin under its own span."""
    cases = [(1000, 16, FRAME_RAYS), (10000, 3, FRAME_RAYS), (1000, 3, FRAME_RAYS),
             (2, 3, FRAME_RAYS), (2, 3, 100), (2, 16, 1)]
    was = profiling.set_recording(True)
    try:
        for n_rows, k, R in cases:
            obj, grads = _rows_case(n_rows, k, "uniform", cuda, dyadic=True)
            obj, grads = obj[:R], [g[:R] for g in grads]
            profiling.take_spans()
            launches = mi.LAUNCHES["object_rows"]
            got = mi.object_rows_sum(obj, grads, n_rows)
            (s,) = profiling.take_spans().spans
            assert s.name == "rtc.object_rows.kernel", (n_rows, k, R)
            assert mi.LAUNCHES["object_rows"] == launches + 1
            twin = mi.object_rows_sum_plain(obj, grads, n_rows)
            assert all(torch.equal(a, b) for a, b in zip(got, twin)), (n_rows, k, R)
        with pytest.raises(ValueError, match="dtype"):
            mi.object_rows_sum(obj, [g.double() for g in grads], n_rows)
        assert mi.LAUNCHES["object_rows"] == launches + 1
        profiling.take_spans()
        cpu = mi.object_rows_sum(obj.cpu(), [g.cpu() for g in grads], n_rows)
        (s,) = profiling.take_spans().spans
        assert s.name == "rtc.object_rows.plain"
        assert all(torch.equal(a.cpu(), b) for a, b in zip(got, cpu))
    finally:
        profiling.set_recording(was)
