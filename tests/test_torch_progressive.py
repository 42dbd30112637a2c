"""rtc_tpu_torch's progressive rendering against rtc_tpu on the CPU:
render_with_checkpoints in f64, an interrupted render resumed, and each
package resuming the other's checkpoint (rtc_tpu's .npz layout); plus
tests/test_progressive.py's bounds expectations on the port's
shape_bounds."""

import os

import numpy as np
import pytest
import torch

from rtc_tpu.models.scenes import REGISTRY as JAX_REGISTRY
from rtc_tpu.render import progressive as jax_progressive
from rtc_tpu.scene.compile import compile_scene as jax_compile_scene
from rtc_tpu.utils.config import RenderConfig as JaxRenderConfig
from rtc_tpu_torch.models.scenes import REGISTRY
from rtc_tpu_torch.ops import transforms as X
from rtc_tpu_torch.render import progressive
from rtc_tpu_torch.render.renderer import render
from rtc_tpu_torch.scene import shapes as S
from rtc_tpu_torch.scene.bounds import shape_bounds
from rtc_tpu_torch.scene.compile import compile_scene
from rtc_tpu_torch.utils.config import RenderConfig

from conftest import assert_almost_eq

torch.set_num_threads(2)

# three_spheres at 48x24 in tiles of 256 rays: 5 tiles, the last one padded
WIDTH, TILE = 48, 256
CFG = RenderConfig(dtype="float64", ray_tile=TILE)
JAX_CFG = JaxRenderConfig(dtype="float64", ray_tile=TILE)


@pytest.fixture(scope="module")
def scenes():
    world, cam = REGISTRY["three_spheres"](WIDTH)
    jax_world, jax_cam = JAX_REGISTRY["three_spheres"](WIDTH)
    return (compile_scene(world, dtype=torch.float64, device="cpu"), cam,
            jax_compile_scene(jax_world, dtype=np.float64), jax_cam)


@pytest.fixture(scope="module")
def full(scenes):
    scene, cam, _, _ = scenes
    return progressive.render_with_checkpoints(scene, cam, CFG)


def test_matches_rtc_tpu_f64(scenes, full):
    _, _, jax_scene, jax_cam = scenes
    ref = jax_progressive.render_with_checkpoints(jax_scene, jax_cam, JAX_CFG)
    assert full.dtype == np.float64 and full.shape == (WIDTH // 2, WIDTH, 3)
    np.testing.assert_allclose(full, ref, atol=1e-9, rtol=0)


def test_matches_one_shot_render(scenes, full):
    """Scanline tiles against render()'s block-major tiles: the same rays."""
    scene, cam, _, _ = scenes
    np.testing.assert_allclose(full, render(scene, cam, CFG).numpy(), atol=1e-9, rtol=0)


def _interrupted(module, scene, cam, cfg, path, after: int = 2):
    """Run module's render_with_checkpoints until tile `after` is yielded,
    as a crash would stop it; returns the tiles rendered."""
    done = []
    orig = module.render_tiles

    def crashing(scene, camera, cfg, start_tile=0):
        for i, total, colors in orig(scene, camera, cfg, start_tile):
            if i >= after:
                raise KeyboardInterrupt
            done.append(i)
            yield i, total, colors

    module.render_tiles = crashing
    try:
        with pytest.raises(KeyboardInterrupt):
            module.render_with_checkpoints(scene, cam, cfg, checkpoint_path=path,
                                           checkpoint_every=1)
    finally:
        module.render_tiles = orig
    return done


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("port", "rtc_tpu"),
                                           ("rtc_tpu", "port")])
def test_interrupted_render_resumes_bit_equal(tmp_path, scenes, full, writer, reader,
                                             monkeypatch):
    """A render stopped after 2 of 5 tiles leaves a checkpoint with
    next_tile 2; resuming it, in either package, renders tiles 2-4 only
    and gives the uninterrupted image bit for bit (the port's f64 path and
    rtc_tpu's agree at 1e-9, so a mixed image is held to that)."""
    scene, cam, jax_scene, jax_cam = scenes
    args = {"port": (progressive, scene, cam, CFG),
            "rtc_tpu": (jax_progressive, jax_scene, jax_cam, JAX_CFG)}
    path = str(tmp_path / "render.npz")
    assert _interrupted(*args[writer], path) == [0, 1]
    with np.load(path) as ck:
        assert (int(ck["next_tile"]), int(ck["tile"])) == (2, TILE)
        assert ck["flat"].shape == (5 * TILE, 3) and ck["flat"].dtype == np.float64
        head = ck["flat"][:2 * TILE].copy()

    module, s, c, cfg = args[reader]
    resumed_tiles = []
    orig = module.render_tiles

    def counting(scene, camera, cfg, start_tile=0):
        for i, total, colors in orig(scene, camera, cfg, start_tile):
            resumed_tiles.append(i)
            yield i, total, colors

    monkeypatch.setattr(module, "render_tiles", counting)
    img = module.render_with_checkpoints(s, c, cfg, checkpoint_path=path,
                                         checkpoint_every=1)
    assert resumed_tiles == [2, 3, 4]
    flat = img.reshape(-1, 3)
    assert np.array_equal(flat[:2 * TILE], head)
    if writer == reader == "port":
        assert np.array_equal(img, full)
    else:
        np.testing.assert_allclose(img, full, atol=1e-9, rtol=0)
    with np.load(path) as ck:
        assert int(ck["next_tile"]) == 5


def test_render_tiles_yields_host_tiles_in_order(scenes):
    scene, cam, _, _ = scenes
    tiles = list(progressive.render_tiles(scene, cam, CFG, start_tile=3))
    assert [(i, n) for i, n, _ in tiles] == [(3, 5), (4, 5)]
    assert all(isinstance(c, np.ndarray) and c.shape == (TILE, 3) for _, _, c in tiles)


# --- tests/test_progressive.py's bounds expectations ----------------------------

def test_shape_bounds_per_kind():
    lo, hi = shape_bounds(S.sphere())
    assert_almost_eq(lo, [-1, -1, -1])
    assert_almost_eq(hi, [1, 1, 1])
    lo, hi = shape_bounds(S.cylinder(1.0, 2.0, True))
    assert_almost_eq(lo, [-1, 1, -1])
    assert_almost_eq(hi, [1, 2, 1])
    lo, hi = shape_bounds(S.cone(-2.0, 3.0, True))
    assert_almost_eq(lo, [-3, -2, -3])
    assert_almost_eq(hi, [3, 3, 3])
    lo, hi = shape_bounds(S.triangle([0, 1, 0], [-1, 0, 0], [1, 0, 0]))
    assert_almost_eq(lo, [-1, 0, 0])
    assert_almost_eq(hi, [1, 1, 0])
    lo, hi = shape_bounds(S.plane())
    assert np.isinf(lo[0]) and lo[1] == 0 and np.isinf(hi[2])


def test_group_bounds_union_of_transformed_children():
    s1 = S.sphere()
    s1.set_transform(X.translation(5, 0, 0))
    s2 = S.sphere()
    s2.set_transform(X.scaling(2, 2, 2))
    lo, hi = shape_bounds(S.group([s1, s2]))
    assert_almost_eq(lo, [-2, -2, -2])
    assert_almost_eq(hi, [6, 2, 2])


def test_group_bounds_start_empty_and_keep_infinite_planes():
    """rtc_tpu's two fixes: the union does not contain the origin unless a
    child does, and a plane in a group keeps its infinite x/z extent."""
    far = S.sphere()
    far.set_transform(X.translation(5, 5, 5))
    lo, hi = shape_bounds(S.group([far]))
    assert_almost_eq(lo, [4, 4, 4])
    assert_almost_eq(hi, [6, 6, 6])
    lo, hi = shape_bounds(S.group([S.plane(transform=X.translation(0, 2, 0))]))
    assert np.isinf(lo[0]) and np.isinf(hi[2]) and lo[1] == hi[1] == 2
    lo, hi = shape_bounds(S.group([]))
    assert np.all(lo > hi)


@pytest.mark.parametrize("writer,reader", [("port", "rtc_tpu"), ("rtc_tpu", "port")])
def test_default_configs_resume_each_other(tmp_path, writer, reader, monkeypatch):
    """At both packages' default configs (f32; the port's progressive
    default keeps rtc_tpu's 8,192-ray tile, not the renderer's whole-frame
    tile) a render stopped after tile 0 of 2 leaves a checkpoint of tile
    8,192 that the other package resumes from tile 1."""
    width = 160                                   # 160 x 80 = 12,800 rays
    world, cam = REGISTRY["three_spheres"](width)
    jax_world, jax_cam = JAX_REGISTRY["three_spheres"](width)
    args = {"port": (progressive, compile_scene(world, device="cpu"), cam),
            "rtc_tpu": (jax_progressive, jax_compile_scene(jax_world), jax_cam)}
    path = str(tmp_path / "render.npz")
    module, s, c = args[writer]
    done = []
    orig = module.render_tiles

    def crashing(scene, camera, cfg, start_tile=0):
        for i, total, colors in orig(scene, camera, cfg, start_tile):
            if i >= 1:
                raise KeyboardInterrupt
            done.append(i)
            yield i, total, colors

    monkeypatch.setattr(module, "render_tiles", crashing)
    with pytest.raises(KeyboardInterrupt):
        module.render_with_checkpoints(s, c, checkpoint_path=path, checkpoint_every=1)
    monkeypatch.undo()
    assert done == [0]
    with np.load(path) as ck:
        assert (int(ck["next_tile"]), int(ck["tile"])) == (1, 8192)

    module, s, c = args[reader]
    resumed = []
    orig = module.render_tiles

    def counting(scene, camera, cfg, start_tile=0):
        for i, total, colors in orig(scene, camera, cfg, start_tile):
            resumed.append(i)
            yield i, total, colors

    monkeypatch.setattr(module, "render_tiles", counting)
    img = module.render_with_checkpoints(s, c, checkpoint_path=path, checkpoint_every=1)
    assert resumed == [1]
    assert img.shape == (width // 2, width, 3) and np.isfinite(img).all()
