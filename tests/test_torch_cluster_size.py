"""compile_scene(cluster_size=L) in rtc_tpu_torch against rtc_tpu's, on the
CPU, for L in {0 (unclustered), 64, 128, 256}:

- on cow, teapot_smooth and cow_herd (instanced: the TLAS tables), every
  table both packages keep (the triangle rows, their normals, objects and
  corner normals, the cluster and supercluster boxes, in the same row
  order), the static counts (n_clusters, cluster_size, the TLAS counts)
  and the TLAS tables equal rtc_tpu's bit for bit after the cast to f32;
- the f64 render (the plain sweep, on the CPU at any leaf) equals
  rtc_tpu's f64 brute-force render within 1e-9 (both are the same float64
  arithmetic; 1e-9 leaves room for association order only);
- at L = 64 and 256 the occlusion walk's tables pass the walk replays of
  tests/test_torch_occlusion_tables.py (the cull never drops a hit on the
  cow) and tests/test_torch_census_walk.py (K2's and K4's walks equal the
  plain sweeps bit for bit on glass_teapot);
- a leaf K7 cannot stage raises, and so does an explicit kernel route on
  an unclustered triangle table.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_cluster_size.py -q
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rtc_tpu.models.scenes import REGISTRY as JAX_REGISTRY
from rtc_tpu.render.camera import camera_rays as jax_camera_rays
from rtc_tpu.render.renderer import render as jax_render
from rtc_tpu.scene.compile import compile_scene as jax_compile_scene
from rtc_tpu.utils.config import RenderConfig as JaxRenderConfig
from rtc_tpu_torch.models.scenes import REGISTRY
from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
from rtc_tpu_torch.render import integrator
from rtc_tpu_torch.render.renderer import render
from rtc_tpu_torch.scene.compile import (TENSOR_FIELDS, SceneStatic, TlasTables,
                                         compile_scene)
from rtc_tpu_torch.utils.config import RenderConfig

from test_torch_census_walk import (_census_inputs, _occlusion_rays, walk_any_hit,
                                    walk_census)
from test_torch_occlusion_tables import _assert_mesh_levels, _hit_pairs, _query

torch.set_num_threads(2)

LEAFS = (0, 64, 128, 256)
SCENES = ("cow", "teapot_smooth", "cow_herd")
# render widths: cow_herd's plain sweep covers 522,360 rows a ray
WIDTHS = {"cow": 16, "teapot_smooth": 16, "cow_herd": 8}
EPS = 1e-5


@pytest.fixture(scope="module")
def compiled():
    """(scene, leaf) -> (rtc_tpu's f64 scene, the port's f64 scene), each
    compiled at its first use."""
    cache = {}

    def get(name, leaf):
        if (name, leaf) not in cache:
            cache[name, leaf] = (
                jax_compile_scene(JAX_REGISTRY[name](16)[0], dtype=np.float64,
                                  cluster_size=leaf),
                compile_scene(REGISTRY[name](16)[0], dtype=torch.float64, device="cpu",
                              cluster_size=leaf))
        return cache[name, leaf]

    return get


@pytest.mark.parametrize("leaf", LEAFS)
@pytest.mark.parametrize("name", SCENES)
def test_tables_equal_rtc_tpu(compiled, name, leaf):
    js, scene = compiled(name, leaf)
    f32 = lambda a: np.asarray(a).astype(np.float32)
    for field in TENSOR_FIELDS:
        ref, got = np.asarray(getattr(js, field)), getattr(scene, field).numpy()
        if ref.dtype.kind == "f":
            ref, got = f32(ref), f32(got)
        assert got.dtype == ref.dtype and np.array_equal(got, ref), field
    for field in SceneStatic._fields:
        assert getattr(scene.static, field) == getattr(js.static, field), field
    assert (scene.tlas is None) == (js.tlas is None)
    if scene.tlas is not None:
        for field in TlasTables._fields:
            ref, got = np.asarray(getattr(js.tlas, field)), getattr(scene.tlas, field)
            got = got.numpy()
            if ref.dtype.kind == "f":
                ref, got = f32(ref), f32(got)
            assert np.array_equal(got, ref), f"tlas.{field}"
    st = scene.static
    assert st.cluster_size == (leaf if leaf else 0)
    if leaf:
        assert st.n_clusters * leaf == st.n_tris and st.n_clusters % 8 == 0
        assert scene.occ is not None
    else:  # unclustered: the leaves' rows in order, unpadded, no TLAS
        assert st.n_clusters == 0 and scene.occ is None and scene.tlas is None
    if name == "cow_herd" and leaf:
        assert st.tlas_n_inst == 96
    return


@pytest.mark.parametrize("leaf", LEAFS)
@pytest.mark.parametrize("name", SCENES)
def test_f64_render_equals_rtc_tpu(compiled, name, leaf):
    """The port's f64 render (the plain sweep, whatever the leaf) against
    rtc_tpu's f64 brute-force render of its own tables at the same leaf."""
    js, scene = compiled(name, leaf)
    width = WIDTHS[name]
    _, cam = REGISTRY[name](width)
    _, jcam = JAX_REGISTRY[name](width)
    ref = np.asarray(jax_render(js, jcam, JaxRenderConfig(dtype="float64",
                                                          mesh_impl="bruteforce")))
    img = render(scene, cam, RenderConfig(dtype="float64")).numpy()
    assert img.shape == ref.shape == (cam.vsize, cam.hsize, 3)
    assert np.abs(img - ref).max() <= 1e-9
    assert img.max() > 0.05


def _f32_rays(name, width):
    world, cam = JAX_REGISTRY[name](width)
    dt = jnp.float32
    o, d = jax_camera_rays(jnp.asarray(cam.transform_inverse, dt), cam.hsize, cam.vsize,
                           jnp.asarray(cam.half_width, dt), jnp.asarray(cam.half_height, dt),
                           jnp.asarray(cam.pixel_size, dt), dt)
    return np.asarray(o), np.asarray(d)


@pytest.mark.parametrize("kind", ("camera", "free_space", "surface", "random"))
@pytest.mark.parametrize("leaf", (64, 256))
def test_occlusion_cull_never_drops_a_hit(leaf, kind):
    """tests/test_torch_occlusion_tables.py's replay on the cow's tables
    at leaf: every hitting (ray, row) pair lies in a sub-box, a cluster
    box and a group box its ray enters before max_t."""
    scene = compile_scene(REGISTRY["cow"](96)[0], device="cpu", cluster_size=leaf)
    o, d = (torch.from_numpy(x.copy()) for x in _f32_rays("cow", 96))
    rng = np.random.default_rng(leaf + len(kind))
    so, sd, max_t = _query("cow", scene, o, d, kind, rng)
    rays, rows = _hit_pairs(so, sd, max_t, scene.occ.rows)
    _assert_mesh_levels(so, sd, max_t, scene.occ, leaf, rays, rows)
    assert rays.numel() > 20


@pytest.mark.parametrize("leaf", (64, 256))
def test_walks_equal_plain_at_leaf(leaf):
    """tests/test_torch_census_walk.py's replays of K2's and K4's walks on
    glass_teapot's tables at leaf equal any_hit_plain and
    crossing_count_plain bit for bit."""
    scene = compile_scene(REGISTRY["glass_teapot"](32)[0], device="cpu",
                          cluster_size=leaf)
    assert scene.static.cluster_size == leaf
    o, d = _f32_rays("glass_teapot", 32)
    tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2)
    so, sd, max_t = _occlusion_rays(scene, o, d)
    flags = walk_any_hit(so, sd, max_t, scene.occ, leaf)
    assert torch.equal(flags, mi.any_hit_plain(so, sd, max_t, *tabs, EPS))
    assert 0 < int(flags.sum()) < int((max_t > 0).sum())
    for kind, (oo, dd, t_hit, gid) in _census_inputs(scene, o, d).items():
        cnt, last = walk_census(oo, dd, t_hit, gid, scene.occ, leaf, 1)
        pcnt, plast = mi.crossing_count_plain(oo, dd, t_hit, gid, *tabs, scene.tri_cid,
                                              1, EPS)
        assert torch.equal(cnt, pcnt) and torch.equal(last, plast), kind
        if kind != "main":
            assert int(cnt.sum()) > 100


@pytest.mark.parametrize("leaf", (-1, 1025))
def test_a_leaf_k7_cannot_stage_raises(leaf):
    with pytest.raises(ValueError, match="1024"):
        compile_scene(REGISTRY["cow"](16)[0], device="cpu", cluster_size=leaf)


@pytest.mark.parametrize("impl", ("kernel", "elementwise"))
def test_kernel_request_on_unclustered_table_raises(impl):
    """An explicit kernel route on cluster_size=0 triangles raises; 'auto'
    takes the plain sweep there, and a scene without triangles (table)
    sweeps its prims whatever the request."""
    cow = compile_scene(REGISTRY["cow"](16)[0], device="cpu", cluster_size=0)
    with pytest.raises(ValueError, match="unclustered"):
        integrator.mesh_impl_for(cow, RenderConfig(mesh_impl=impl), False, torch.float32)
    assert integrator.mesh_impl_for(cow, RenderConfig(), False, torch.float32) == "bruteforce"
    table = compile_scene(REGISTRY["table"](16)[0], device="cpu", cluster_size=0)
    assert integrator.mesh_impl_for(
        table, RenderConfig(mesh_impl=impl), False, torch.float32) == "bruteforce"
