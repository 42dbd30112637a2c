"""rtc_tpu_torch.parallel against rtc_tpu.parallel on the CPU.

The port's sharded renders run in grids of CPU processes over gloo
(tests/torch_parallel_worker.py: a world of 2 ranks and one of 4,
spawned together, each rank writing its results as .npy); rtc_tpu runs
in this process on conftest's 8 virtual CPU devices. The f64 renders are
held to rtc_tpu's single-device render at 1e-9 (the prim-sharded ones
combine exact partial results, so they equal the port's own single-rank
render), the f32 renders to rtc_tpu's render_sharded under
tests/test_parallel.py's assert_images_match budget, and the gradients
to the single-rank ones at tests/test_torch_grad.py's tolerance (rtol
1e-6, atol 1e-10). The tables of pad_tris and shard_scene, and the
Morton deal, are compared with rtc_tpu's here, in this process.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rtc_tpu.diff import render_grad as JRG
from rtc_tpu.models.scenes import REGISTRY as JAX_REGISTRY
from rtc_tpu.ops.pallas.mesh_intersect import _blocked as jax_blocked
from rtc_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rtc_tpu.parallel.shard import _balanced_morton_perm as jax_deal
from rtc_tpu.parallel.shard import pad_tris as jax_pad_tris
from rtc_tpu.parallel.shard import render_sharded as jax_render_sharded
from rtc_tpu.parallel.shard import scene_pspecs
from rtc_tpu.render import integrator as jax_integrator
from rtc_tpu.render.camera import camera_rays as jax_camera_rays
from rtc_tpu.render.renderer import render as jax_render
from rtc_tpu.scene.compile import compile_scene as jax_compile_scene
from rtc_tpu.utils.config import RenderConfig as JaxRenderConfig
from rtc_tpu_torch.diff import render_grad as RG
from rtc_tpu_torch.models.scenes import REGISTRY, cow_herd_mesh_world
from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
from rtc_tpu_torch.parallel import mesh as grid
from rtc_tpu_torch.parallel.shard import (_balanced_morton_perm, pad_tris,
                                          shard_scene)
from rtc_tpu_torch.render import integrator
from rtc_tpu_torch.render.camera import camera_rays
from rtc_tpu_torch.render.renderer import render
from rtc_tpu_torch.scene.compile import (TENSOR_FIELDS, compile_scene,
                                         occlusion_tables)
from rtc_tpu_torch.utils.config import RenderConfig
from test_parallel import assert_images_match
from torch_parallel_worker import PRIM_CASES, TILE

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORKER_TIMEOUT = 240  # seconds a grid of worker processes may take
GRAD_TOL = dict(rtol=1e-6, atol=1e-10)  # tests/test_torch_grad.py:84

torch.set_num_threads(2)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """Both worlds of torch_parallel_worker.py (2 and 4 ranks), spawned
    together; each rank must print WORKER_OK within WORKER_TIMEOUT.
    Returns the directory of their results."""
    out = str(tmp_path_factory.mktemp("torch_parallel"))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    for world in (2, 4):
        port = str(_free_port())
        procs += [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
             str(rank), str(world), port, out],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
            cwd=REPO) for rank in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail("parallel workers timed out:\n" + "\n".join(outs))
    for p, text in zip(procs, outs):
        assert p.returncode == 0 and "WORKER_OK" in text, text
    return out


def _ranks(out: str, case: str, n: int):
    return [np.load(os.path.join(out, f"{case}_r{r}.npy")) for r in range(n)]


def _npz(out: str, case: str, rank: int) -> dict:
    with np.load(os.path.join(out, f"{case}_r{rank}.npz")) as f:
        return {k: f[k] for k in f.files}


def _jax_scene(name: str, width: int, dtype):
    world, cam = JAX_REGISTRY[name](width)
    return jax_compile_scene(world, dtype=dtype), cam


def _scene(name: str, width: int, dtype=torch.float64):
    world, cam = REGISTRY[name](width)
    return compile_scene(world, dtype=dtype, device="cpu"), cam


# --- the tables: pad_tris, shard_scene, the Morton deal ---------------------

def test_pad_tris_tables_match_rtc_tpu():
    """Teapot at width 16 padded to a multiple of 7: empty cluster boxes,
    zero-edge leaves, tri_cid -1 and padded superclusters, as rtc_tpu's."""
    js = jax_pad_tris(_jax_scene("teapot", 16, np.float32)[0], 7)
    scene = pad_tris(_scene("teapot", 16, torch.float32)[0], 7)
    for f in ("n_tris", "n_clusters", "n_super"):
        assert getattr(scene.static, f) == getattr(js.static, f), f
    assert scene.static.n_clusters % 7 == 0 and scene.static.n_super % 7 == 0
    for f in TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(scene, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    st = scene.static
    assert scene.occ.rows.shape[0] == st.n_clusters * st.cluster_size
    assert scene.occ.tri_cid is scene.tri_cid


def test_pad_tris_render_unchanged():
    """The padded rows never hit: the f64 render is unchanged, bit for bit."""
    scene, cam = _scene("teapot", 16)
    cfg = RenderConfig(dtype="float64", ray_tile=256)
    np.testing.assert_array_equal(render(pad_tris(scene, 7), cam, cfg).numpy(),
                                  render(scene, cam, cfg).numpy())


@pytest.mark.parametrize("vsize,hsize,n_shards,tile",
                         [(32, 64, 2, 512), (24, 48, 4, 128), (37, 53, 3, 256)])
def test_balanced_morton_perm_matches_rtc_tpu(vsize, hsize, n_shards, tile):
    perm, inv = _balanced_morton_perm(vsize, hsize, n_shards, tile)
    jperm, jinv = jax_deal(vsize, hsize, n_shards, tile)
    np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(inv, jinv)


@pytest.mark.parametrize("name,n", [("glass_teapot", 2), ("teapot", 3)])
def test_shard_scene_rows_match_rtc_tpu(name, n):
    """Each shard holds the rows that rtc_tpu's scene_pspecs gives its
    device along 'prims' (the triangle fields, the cluster and
    supercluster boxes), counts them in its static, knows its first row,
    and carries the occlusion tables of its own slice, built from its own
    tri_cid tensor."""
    js = jax_pad_tris(_jax_scene(name, 16, np.float32)[0], n)
    specs = scene_pspecs(js, True)
    scene = pad_tris(_scene(name, 16, torch.float32)[0], n)
    leaf = scene.static.cluster_size
    for index in range(n):
        shard = shard_scene(scene, index, n)
        for f in TENSOR_FIELDS:
            want = np.asarray(getattr(js, f))
            if getattr(specs, f) != jax.sharding.PartitionSpec():
                want = np.split(want, n)[index]
            np.testing.assert_array_equal(getattr(shard, f).numpy(), want, err_msg=f)
        st = shard.static
        assert (st.n_tris, st.n_clusters, st.n_super) == (
            js.static.n_tris // n, js.static.n_clusters // n, js.static.n_super // n)
        assert shard.tri_offset == index * st.n_tris
        want = occlusion_tables(shard.tri_p1, shard.tri_e1, shard.tri_e2,
                                shard.cluster_aabb, leaf, tri_cid=shard.tri_cid)
        for f in want._fields:
            np.testing.assert_array_equal(getattr(shard.occ, f).numpy(),
                                          getattr(want, f).numpy(), err_msg=f)
        assert shard.occ.tri_cid is shard.tri_cid


def test_shard_streams_as_rtc_tpu_shard():
    """The one-mesh 3x3 herd (53,248 rows) streams in two superblocks of
    the budget whole, in both packages; each half of a 1x2 shard fits one,
    so it streams in neither: rtc_tpu's shard decides by its local shapes,
    the port's by its shard's tables. The streamed driver runs on the
    whole table and not on a shard (the kernel branch forced: the
    wrappers run their plain versions on the CPU)."""
    scene = compile_scene(cow_herd_mesh_world(3, 3), device="cpu")
    leaf, budget = scene.static.cluster_size, mi.VMEM_TRI_BUDGET
    shards = [shard_scene(pad_tris(scene, 2), i, 2) for i in range(2)]
    assert mi._blocked(scene.tri_p1, leaf, budget) == jax_blocked(
        np.asarray(scene.tri_p1), leaf, budget) == 2
    for shard in shards:
        assert shard.static.n_tris == 26624
        assert mi._blocked(shard.tri_p1, leaf, budget) == jax_blocked(
            np.asarray(shard.tri_p1), leaf, budget) == 1
    rng = np.random.default_rng(0)
    o = torch.zeros((8, 3)) + torch.tensor([0.0, 2.0, -30.0])
    d = torch.nn.functional.normalize(
        torch.from_numpy(rng.normal(0.0, 0.1, (8, 3)).astype(np.float32))
        + torch.tensor([0.0, 0.0, 1.0]), dim=1)
    streamed = mi.closest_hit_blocked
    calls = []

    def spy(*args, **kwargs):
        calls.append(1)
        return streamed(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(integrator, "_resolve_mesh_impl", lambda s, c, x: "kernel")
        mp.setattr(mi, "closest_hit_blocked", spy)
        for s in [scene] + shards:
            calls.clear()
            integrator.mesh_closest(s, o, d, RenderConfig())
            assert len(calls) == (1 if s is scene else 0)


# --- the renders -------------------------------------------------------------

def test_rays_sharded_render_matches_rtc_tpu(grids):
    """Rays over a 2x1 grid, three_spheres at 64 in f64: every rank's image
    equals rtc_tpu's single-device render and its render_sharded over
    make_mesh(2, 1) at 1e-9."""
    js, cam = _jax_scene("three_spheres", 64, np.float64)
    cfg = JaxRenderConfig(dtype="float64", ray_tile=TILE)
    ref = np.asarray(jax_render(js, cam, cfg))
    ref_sh = np.asarray(jax_render_sharded(
        js, cam, cfg, mesh=jax_make_mesh(2, 1, devices=jax.devices()[:2])))
    for img in _ranks(grids, "rays_2x1_float64", 2):
        np.testing.assert_allclose(img, ref, rtol=0, atol=1e-9)
        np.testing.assert_allclose(img, ref_sh, rtol=0, atol=1e-9)


@pytest.mark.parametrize("case", list(PRIM_CASES))
def test_prim_sharded_render_f64_matches_rtc_tpu(grids, case):
    """Triangles over 'prims' (the min-by-t combine, the OR of occlusion,
    and on glass_teapot the SUM/MAX crossing census): every rank's f64
    image equals rtc_tpu's single-device render at 1e-9."""
    name, width, n_rays, n_prims, depth = PRIM_CASES[case]
    js, cam = _jax_scene(name, width, np.float64)
    ref = np.asarray(jax_render(js, cam, JaxRenderConfig(
        dtype="float64", ray_tile=TILE, max_depth=depth)))
    for img in _ranks(grids, case + "_float64", n_rays * n_prims):
        np.testing.assert_allclose(img, ref, rtol=0, atol=1e-9)


@pytest.mark.parametrize("case", list(PRIM_CASES))
def test_prim_sharded_render_f32_matches_rtc_tpu_sharded(grids, case):
    """The same grids in f32 at depth 5: every rank's image equals the
    port's single-rank render bit for bit, and rtc_tpu's render_sharded
    over the same grid of devices within tests/test_parallel.py's
    budget."""
    name, width, n_rays, n_prims, _ = PRIM_CASES[case]
    js, cam = _jax_scene(name, width, np.float32)
    mesh = jax_make_mesh(n_rays, n_prims, devices=jax.devices()[:n_rays * n_prims])
    ref = np.asarray(jax_render_sharded(js, cam, JaxRenderConfig(ray_tile=TILE),
                                        mesh=mesh, shard_prims=True))
    scene, cam = _scene(name, width, torch.float32)
    single = render(scene, cam, RenderConfig(ray_tile=TILE)).numpy()
    for img in _ranks(grids, case + "_float32", n_rays * n_prims):
        np.testing.assert_array_equal(img, single)
        assert_images_match(img, ref)


def test_render_multihost_returns_image_on_rank_zero(grids):
    js, cam = _jax_scene("three_spheres", 16, np.float64)
    ref = np.asarray(jax_render(js, cam, JaxRenderConfig(dtype="float64",
                                                         ray_tile=TILE)))
    img0, img1 = _ranks(grids, "multihost", 2)
    np.testing.assert_allclose(img0, ref, rtol=0, atol=1e-9)
    assert img1.size == 0  # None on rank 1


def test_prim_sharded_census_equals_whole_table(grids):
    """glass_teapot's census over the 2x2 grid's prims groups (each rank
    K4's plain version on its shard, the counts SUMmed and the latest
    crossings MAXed) equals the whole table's, exactly, on rays re-seated
    inside the glass, where the counts are not 0."""
    for rank in range(4):
        got = _npz(grids, "census", rank)
        assert got["whole_cnt"].sum() > 0
        np.testing.assert_array_equal(got["cnt"], got["whole_cnt"])
        np.testing.assert_array_equal(got["last"], got["whole_last"])


# --- the gradients -----------------------------------------------------------

def test_train_step_multihost_matches_rtc_tpu_grad(grids):
    """Two ranks on 'rays', three_spheres at 16 in f64: the reduced loss
    and gradients on every rank equal rtc_tpu's unsharded jax.grad of the
    same loss (tests/multihost_worker.py's loss_ref)."""
    js, cam = _jax_scene("three_spheres", 16, np.float64)
    cfg = JaxRenderConfig(dtype="float64", ray_tile=64)
    o, d = jax_camera_rays(jnp.asarray(cam.transform_inverse, jnp.float64),
                           cam.hsize, cam.vsize, cam.half_width, cam.half_height,
                           cam.pixel_size, jnp.float64)
    target = jnp.full_like(o, 0.5)
    n_total = o.shape[0] * 3

    def loss_ref(p):
        im = jax_integrator.color_at(JRG.inject_params(js, p), o, d, cfg)
        return jnp.sum((im - target) ** 2) / n_total

    lref, gref = jax.jit(jax.value_and_grad(loss_ref))(JRG.extract_params(js))
    for rank in range(2):
        got = _npz(grids, "train_step", rank)
        np.testing.assert_allclose(got.pop("loss"), float(lref), rtol=1e-12)
        assert set(got) == set(RG.DEFAULT_PARAMS)
        for k, g in got.items():
            np.testing.assert_allclose(g, np.asarray(gref[k]), **GRAD_TOL, err_msg=k)


def test_prim_sharded_gradients_match_single_rank(grids):
    """Teapot at 16 in f64 over a 1x2 prims grid, tri_p1 among the
    parameters: the gradient of each shard's rows (through the combine's
    gather, back to the rank that holds the winner) and of the replicated
    parameters equal the single-rank loss_and_grad's."""
    scene, cam = _scene("teapot", 16)
    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize, cam.half_width,
                       cam.half_height, cam.pixel_size, torch.float64)
    names = RG.DEFAULT_PARAMS + ("tri_p1",)
    params = RG.extract_params(scene, names)
    loss, grads = RG.loss_and_grad(params, scene, o, d, torch.full_like(o, 0.25),
                                   RenderConfig(dtype="float64"))
    assert float(grads["tri_p1"].abs().sum()) > 0
    shards = [_npz(grids, "grad_prims", r) for r in range(2)]
    tri_p1 = np.concatenate([s["tri_p1"] for s in shards])
    n = scene.static.n_tris
    assert [int(s["tri_offset"]) for s in shards] == [0, len(shards[0]["tri_p1"])]
    np.testing.assert_allclose(tri_p1[:n], grads["tri_p1"].numpy(), **GRAD_TOL)
    assert not tri_p1[n:].any()  # the padding rows never hit
    for s in shards:
        np.testing.assert_allclose(s["loss"], float(loss), rtol=1e-12)
        for k in RG.DEFAULT_PARAMS:
            np.testing.assert_allclose(s[k], grads[k].numpy(), **GRAD_TOL, err_msg=k)


# --- what the grid refuses ---------------------------------------------------

def test_prim_axis_outside_a_sharded_call_raises():
    scene, cam = _scene("teapot", 16)
    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize, cam.half_width,
                       cam.half_height, cam.pixel_size, torch.float64)
    cfg = RenderConfig(dtype="float64", prim_axis="prims")
    with pytest.raises(RuntimeError, match="no sharded call"):
        integrator.color_at(scene, o, d, cfg)
    with pytest.raises(RuntimeError, match="no sharded call"):
        render(scene, cam, cfg)


def test_elementwise_under_the_prim_axis_raises():
    scene, _ = _scene("teapot", 16, torch.float32)
    cfg = RenderConfig(mesh_impl="elementwise", prim_axis="prims")
    with pytest.raises(ValueError, match="primitive sharding"):
        integrator._resolve_mesh_impl(scene, cfg, scene.tri_p1)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="no torch.distributed process group"):
        grid.make_mesh(1, 1, device_type="cpu")


def test_make_mesh_with_a_wrong_rank_count_raises(grids):
    """make_mesh(3, 1) in the 2-rank world raised ValueError on each rank."""
    for msg in _ranks(grids, "make_mesh_error", 2):
        assert "3x1 grid needs 3 ranks" in str(msg)
