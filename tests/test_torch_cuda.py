"""The CUDA kernels K1-K3 against their plain PyTorch versions on the card,
at small sizes and on edge cases: ragged ray counts, padding clusters,
parked rays, axis-parallel directions, empty batches and bad inputs.

These tests need a CUDA device and nvcc, and skip elsewhere. This file
imports neither jax nor rtc_tpu, so on the GPU machine it runs without the
repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from rtc_tpu_torch.models.scenes import REGISTRY
from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
from rtc_tpu_torch.render.camera import camera_rays
from rtc_tpu_torch.render.renderer import render
from rtc_tpu_torch.scene.compile import compile_scene
from rtc_tpu_torch.scene.shapes import mesh, triangle
from rtc_tpu_torch.scene.world import PointLight, World
from rtc_tpu_torch.utils.config import RenderConfig

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
    k2 = mi.mesh_any_hit(o, d, max_t, *tabs, scene.cluster_aabb, leaf)
    p2 = mi.any_hit_plain(o, d, max_t, *tabs)
    k3 = mi.mesh_closest_shadow(o, d, *tabs, scene.tri_n, scene.cluster_aabb,
                                scene.light_pos, leaf)
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
