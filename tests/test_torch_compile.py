"""rtc_tpu_torch's host side against rtc_tpu: scene compile, OBJ parse,
camera rays, ray accounting, and the package's import hygiene."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from rtc_tpu.models.scenes import REGISTRY as JAX_REGISTRY
from rtc_tpu.models.scenes import cow_herd_smooth_world as jax_cow_herd_smooth_world
from rtc_tpu.render.camera import camera_rays as jax_camera_rays
from rtc_tpu.scene.compile import compile_scene as jax_compile_scene
from rtc_tpu.utils.profiling import rays_per_pixel as jax_rays_per_pixel
from rtc_tpu_torch.io.obj import Parser
from rtc_tpu_torch.models.scenes import ASSETS, REGISTRY, cow_herd_smooth_world
from rtc_tpu_torch.render import integrator
from rtc_tpu_torch.render.camera import camera_rays
from rtc_tpu_torch.scene import shapes
from rtc_tpu_torch.scene.compile import (TENSOR_FIELDS, SceneStatic,
                                         TlasTables, compile_scene,
                                         scene_from_numpy)
from rtc_tpu_torch.scene.materials import STRIPE, Material, Pattern
from rtc_tpu_torch.scene.world import PointLight, World, default_world
from rtc_tpu_torch.utils.config import RenderConfig
from rtc_tpu_torch.utils.profiling import rays_per_pixel

torch.set_num_threads(2)


def _compile(world, **kw):
    """The port's compile_scene on the CPU: its default device is the card."""
    return compile_scene(world, device="cpu", **kw)


DTYPES = {"float32": (np.float32, torch.float32),
          "float64": (np.float64, torch.float64)}


@pytest.fixture(scope="module")
def cows():
    """(rtc_tpu scene, port scene) of cow in each dtype."""
    out = {}
    for name, (np_dt, torch_dt) in DTYPES.items():
        jax_world, _ = JAX_REGISTRY["cow"](32)
        world, _ = REGISTRY["cow"](32)
        out[name] = (jax_compile_scene(jax_world, dtype=np_dt),
                     _compile(world, dtype=torch_dt))
    return out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_compile_matches_rtc_tpu(cows, dtype):
    """Every table the port keeps equals rtc_tpu's exactly, in the same
    cluster order; the static counts are rtc_tpu's."""
    jax_scene, scene = cows[dtype]
    for field in TENSOR_FIELDS:
        ref = np.asarray(getattr(jax_scene, field))
        got = getattr(scene, field).numpy()
        assert got.dtype == ref.dtype, field
        assert np.array_equal(got, ref), field
    for field in SceneStatic._fields:
        assert getattr(scene.static, field) == getattr(jax_scene.static, field), field
    assert scene.static.n_tris == 6144 and scene.static.n_clusters == 48


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_scene_from_numpy_matches_compile(cows, dtype):
    jax_scene, scene = cows[dtype]
    arrays = {f: np.asarray(getattr(jax_scene, f)) for f in TENSOR_FIELDS}
    carried = scene_from_numpy(arrays, jax_scene.static._asdict(), device="cpu")
    assert carried.static == scene.static
    for field in TENSOR_FIELDS:
        assert torch.equal(getattr(carried, field), getattr(scene, field)), field


def _tri_world(**material):
    tri = shapes.triangle([0, 1, 0], [-1, 0, 0], [1, 0, 0],
                          material=Material(**material))
    return World(objects=[tri], light=PointLight((0, 5, -5), (1, 1, 1)))


def _slice_worlds():
    """Worlds with one feature each that compile_scene refused before the
    smooth and glass meshes, and then instanced meshes, were ported. The
    instanced world is two copies of one 30,000-triangle mesh: 60,416
    padded world rows exceed rtc_tpu's VMEM budget of 49,152, so both
    packages build TLAS tables for it."""
    glass = _tri_world(transparency=0.9, refractive_index=1.5)
    patterned = _tri_world(pattern=Pattern(STRIPE))
    smooth = World(objects=[shapes.mesh(
        [[0, 1, 0]], [[-1, 0, 0]], [[1, 0, 0]],
        vn1=[[0, 0, -1]], vn2=[[0, 0, -1]], vn3=[[0, 0, -1]])])
    herd = World(objects=[shapes.mesh(*(np.zeros((30000, 3)),) * 3)
                          for _ in range(2)])
    return {"sphere": World(objects=[shapes.sphere()]),
            "pattern": patterned, "refractive": glass, "smooth": smooth,
            "instanced": herd}


@pytest.mark.parametrize("kind", sorted(_slice_worlds()))
def test_slice_features_compile(kind):
    st = _compile(_slice_worlds()[kind]).static
    flags = dict(sphere=st.n_prims == 1 and st.n_tris == 0,
                 pattern=st.any_pattern,
                 refractive=st.any_refractive and st.refr_mesh_obj_ids == (0,),
                 smooth=st.any_smooth,
                 # rtc_tpu's counts for this world
                 instanced=(st.tlas_n_inst, st.tlas_n_mesh, st.tlas_cm) == (8, 1, 240))
    assert flags[kind]


# the smooth 3x3 herd: 9 instances of the smooth cow (52,236 triangles),
# instanced in both packages
SLICE_SCENES = ("teapot_smooth", "glass_teapot", "teddy", "herd3x3_smooth")


def _slice_world(name: str, jax: bool):
    if name == "herd3x3_smooth":
        return (jax_cow_herd_smooth_world if jax else cow_herd_smooth_world)(3, 3)
    return (JAX_REGISTRY if jax else REGISTRY)[name](24)[0]


@pytest.fixture(scope="module")
def slice_scenes():
    """(rtc_tpu scene, port scene) of each slice scene in each dtype."""
    out = {}
    for name in SLICE_SCENES:
        for dtype, (np_dt, torch_dt) in DTYPES.items():
            out[name, dtype] = (
                jax_compile_scene(_slice_world(name, True), dtype=np_dt),
                _compile(_slice_world(name, False), dtype=torch_dt))
    return out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", SLICE_SCENES)
def test_compile_matches_rtc_tpu_slice_scenes(slice_scenes, name, dtype):
    """Corner normals, prim, pattern and container tables, object ids,
    instanced (TLAS) tables and static fields equal rtc_tpu's element for
    element."""
    jax_scene, scene = slice_scenes[name, dtype]
    tables = [(f, getattr(jax_scene, f), getattr(scene, f)) for f in TENSOR_FIELDS]
    assert (scene.tlas is None) == (jax_scene.tlas is None)
    if scene.tlas is not None:
        tables += [(f, getattr(jax_scene.tlas, f), getattr(scene.tlas, f))
                   for f in TlasTables._fields]
    for field, ref, got in tables:
        ref, got = np.asarray(ref), got.numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape, field
        assert np.array_equal(got, ref), field
    for field in SceneStatic._fields:
        assert getattr(scene.static, field) == getattr(jax_scene.static, field), field
    st = scene.static
    assert st.any_smooth and st.n_clusters * st.cluster_size == st.n_tris
    if name == "glass_teapot":
        # the plane is object 0, so the teapot's triangles are object 1
        assert (st.n_prims, st.single_tri_obj, st.refr_mesh_obj_ids) == (1, 1, (1,))
        assert int((scene.tri_cid == 0).sum()) == 6320
    if name == "herd3x3_smooth":
        assert (st.tlas_n_inst, st.tlas_n_mesh, st.tlas_cm, st.tlas_sn) == (16, 1, 48, True)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_scene_from_numpy_round_trips_glass_teapot(slice_scenes, dtype):
    jax_scene, scene = slice_scenes["glass_teapot", dtype]
    arrays = {f: np.asarray(getattr(jax_scene, f)) for f in TENSOR_FIELDS}
    carried = scene_from_numpy(arrays, jax_scene.static._asdict(), device="cpu")
    assert carried.static == scene.static
    for field in TENSOR_FIELDS:
        assert torch.equal(getattr(carried, field), getattr(scene, field)), field
    with pytest.raises(ValueError, match="tlas"):
        scene_from_numpy(arrays, dict(jax_scene.static._asdict(), tlas_n_inst=8),
                         device="cpu")


def test_containers_all_matches_rtc_tpu():
    """containers='all' makes every object a census container, as rtc_tpu."""
    from rtc_tpu.scene import shapes as jax_shapes
    from rtc_tpu.scene.world import World as JaxWorld

    def world(S, W):
        return W(objects=[S.sphere(), S.mesh([[0, 1, 0]], [[-1, 0, 0]], [[1, 0, 0]])])

    ref = jax_compile_scene(world(jax_shapes, JaxWorld), dtype=np.float64,
                            containers="all")
    scene = _compile(world(shapes, World), dtype=torch.float64,
                          containers="all")
    assert scene.static.refr_prim_ids == ref.static.refr_prim_ids == (0,)
    assert scene.static.refr_mesh_obj_ids == ref.static.refr_mesh_obj_ids == (1,)
    assert np.array_equal(scene.tri_cid.numpy(), np.asarray(ref.tri_cid))
    with pytest.raises(ValueError, match="containers"):
        _compile(world(shapes, World), containers="some")


def test_triangle_world_compiles_with_padding():
    scene = _compile(_tri_world())
    st = scene.static
    assert (st.n_tris, st.n_clusters, st.single_tri_obj) == (1024, 8, 0)
    # padding clusters carry empty boxes: lo = 1 > hi = -1
    assert torch.equal(scene.cluster_aabb[1:, :3], torch.ones(7, 3))
    assert torch.equal(scene.cluster_aabb[1:, 3:], -torch.ones(7, 3))


def test_obj_native_matches_python_parser():
    with open(os.path.join(ASSETS, "cow-nonormals.obj")) as f:
        text = f.read()
    native = Parser.from_obj_str(text)
    python = Parser._from_obj_str_py(text)
    assert native.ignored_lines == python.ignored_lines
    assert native.group_names() == python.group_names()
    assert native.default_faces == python.default_faces
    np.testing.assert_array_equal(np.stack(native.vertices_list),
                                  np.stack(python.vertices_list))


def test_camera_rays_match_rtc_tpu_f64():
    _, cam = REGISTRY["cow"](48)
    args = (cam.transform_inverse, cam.hsize, cam.vsize, cam.half_width,
            cam.half_height, cam.pixel_size)
    o, d = camera_rays(*args, dtype=torch.float64)
    jo, jd = jax_camera_rays(*args, dtype=jnp.float64)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0, atol=1e-12)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=1e-12)


@pytest.mark.parametrize("depth", [0, 1, 4, 5, 8])
@pytest.mark.parametrize("reflective", [False, True])
@pytest.mark.parametrize("shadows", [False, True])
def test_rays_per_pixel_counts_like_rtc_tpu(depth, reflective, shadows):
    assert rays_per_pixel(depth, reflective, False, shadows) == \
        jax_rays_per_pixel(depth, reflective, False, shadows)


def test_cow_main_path_casts_four_rays_per_pixel():
    assert rays_per_pixel(5, True, False) == 4
    assert jax_rays_per_pixel(5, True, False) == 4


def test_config_knobs():
    cfg = RenderConfig()
    assert (cfg.max_depth, cfg.epsilon, cfg.dtype, cfg.ray_tile, cfg.mesh_impl,
            cfg.shadows, cfg.ray_order, cfg.fused_shadow) == \
        (5, 1e-5, "float32", 1920 * 960, "auto", True, "morton", True)
    with pytest.raises(ValueError):
        RenderConfig(mesh_impl="mxu")
    # prim_axis names the rank grid's axis; rendering with it outside a
    # sharded call (rtc_tpu_torch.parallel.shard) raises
    cfg = RenderConfig(prim_axis="prims")
    assert cfg.prim_axis == "prims"
    with pytest.raises(RuntimeError, match="no sharded call"):
        integrator.color_at(_compile(default_world()), torch.zeros((1, 3)),
                            torch.ones((1, 3)), cfg)


def test_compile_defaults_to_the_card():
    """compile_scene's tables, and so render(), go to the card unless the
    caller asks for the CPU, as the CPU tests here do."""
    import inspect

    sig = inspect.signature(compile_scene)
    assert sig.parameters["device"].default == "cuda"


def test_import_loads_no_jax():
    """The port never imports jax or rtc_tpu, its tools included."""
    code = ("import sys, rtc_tpu_torch, rtc_tpu_torch.render.integrator, "
            "rtc_tpu_torch.cli, rtc_tpu_torch.render.progressive, "
            "rtc_tpu_torch.utils.debug, rtc_tpu_torch.io.canvas, "
            "rtc_tpu_torch.parallel.mesh, rtc_tpu_torch.parallel.collectives, "
            "rtc_tpu_torch.parallel.shard, rtc_tpu_torch.parallel.multihost, "
            "rtc_tpu_torch.testing, rtc_tpu_torch.ops, rtc_tpu_torch.utils, "
            "rtc_tpu_torch.io.obj, rtc_tpu_torch.tools.bench, "
            "rtc_tpu_torch.tools.perf_probe, rtc_tpu_torch.tools.kernel_sweep, "
            "rtc_tpu_torch.tools.graft_entry, rtc_tpu_torch.tools.walk; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'rtc_tpu')]; print(bad); sys.exit(bool(bad))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
