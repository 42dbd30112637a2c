"""The reference against tests/oracle.py, the repo's per-ray float64
oracle of the book's integrator, on seeded pixels of both
configurations at small canvases, under both container rules."""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import oracle  # noqa: E402

from rtbench.reference import geometry as G  # noqa: E402
from rtbench.reference import tracer  # noqa: E402
from rtc_tpu_torch.models import scenes  # noqa: E402


@pytest.mark.parametrize("name, width, containers", [
    ("cow", 96, "refractive"), ("glass_teapot", 64, "refractive"), ("glass_teapot", 64, "all")])
def test_reference_matches_oracle(name, width, containers):
    with open(os.path.join(ROOT, "rtbench", "configs", name + ".json")) as f:
        config = json.load(f)
    config["render"]["containers"] = containers
    height = width // 2
    world, cam = getattr(scenes, name)(width)
    orc = oracle.Oracle(world)
    scene = tracer.Scene(config, ROOT, torch.float64, "cpu")
    rng = np.random.default_rng(17)
    # pixels near the middle of the canvas, where the mesh is
    px = rng.integers(width // 4, 3 * width // 4, 120)
    py = rng.integers(height // 4, 3 * height // 4, 120)
    view = G.view_transform(config["camera"]["from"], config["camera"]["to"],
                            config["camera"]["up"])
    o, d = G.pixel_rays(view, width, height, config["canvas"]["field_of_view"], px, py,
                        torch.float64, "cpu")
    got = tracer.render_rays(scene, o, d, config["render"]["max_depth"]).numpy()
    want = np.array([orc.color_at(*oracle.camera_ray(cam, x, y)) for x, y in zip(px, py)])
    assert (want.max(1) > 0).sum() > 60  # most pixels see the scene
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


def test_reference_gradients_match_finite_differences():
    with open(os.path.join(ROOT, "rtbench", "configs", "glass_teapot.json")) as f:
        config = json.load(f)
    scene = tracer.Scene(config, ROOT, torch.float64, "cpu")
    px, py = np.meshgrid(np.arange(8, 24), np.arange(4, 12))
    view = G.view_transform(config["camera"]["from"], config["camera"]["to"],
                            config["camera"]["up"])
    o, d = G.pixel_rays(view, 32, 16, 0.785, px.ravel(), py.ravel(), torch.float64, "cpu")
    tree = tracer.trace(scene, o, d, 5)
    color = scene.color.clone().requires_grad_()
    loss = lambda c: (tracer.shade(scene, tree, len(o), c) ** 2).sum()
    (g,) = torch.autograd.grad(loss(color), color)
    eps = 1e-6
    for i, j in ((1, 0), (1, 2)):
        up, down = scene.color.clone(), scene.color.clone()
        up[i, j] += eps
        down[i, j] -= eps
        fd = (loss(up) - loss(down)) / (2 * eps)
        assert abs(float(g[i, j]) - float(fd)) <= 1e-6 * max(1.0, abs(float(fd)))
    assert float(g[1].abs().sum()) > 0


def test_bounds_cull_no_crossing():
    """The mesh's padded bounds skip only rays that cannot cross it: the
    same colours with the bounds made infinite, on rays from all around."""
    with open(os.path.join(ROOT, "rtbench", "configs", "glass_teapot.json")) as f:
        config = json.load(f)
    scene = tracer.Scene(config, ROOT, torch.float64, "cpu")
    gen = torch.Generator().manual_seed(5)
    o = torch.rand(3000, 3, generator=gen, dtype=torch.float64) * 8 - 4
    d = torch.randn(3000, 3, generator=gen, dtype=torch.float64)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    want = tracer.render_rays(scene, o, d, 5)
    mesh = scene.objects[1]
    mesh.box = torch.tensor([[-float("inf")] * 3, [float("inf")] * 3], dtype=torch.float64)
    got = tracer.render_rays(scene, o, d, 5)
    assert (want.amax(1) > 0).sum() > 1000
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
