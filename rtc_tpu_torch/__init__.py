"""rtc_tpu_torch — rtc_tpu's ray tracer on PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

The layout mirrors rtc_tpu/, so each module's counterpart sits at the same
path. This package imports torch and numpy, never jax or rtc_tpu.

  ops/      numeric core (with the book's tuples, matrices, rays and
            colors); ops/kernels: the CUDA kernels and plain versions
  scene/    builder API + SoA compiler (host-side numpy, tensors at the end)
  render/   camera, wavefront integrator, renderer, progressive tiles
  diff/     gradients of the image w.r.t. scene parameters and camera pose,
            parameter checkpoints (from rtc_tpu_torch.diff import
            render_grad as RG)
  parallel/ sharded rendering over a torch.distributed rank grid: rays
            over 'rays', triangle shards over 'prims' (render_sharded,
            render_multihost, train_step_multihost)
  io/       OBJ parser, PPM canvas
  models/   rtc_tpu's 14 shipped scenes (REGISTRY)
  utils/    config, ray accounting and reports, world checks
  csrc/     CUDA C++ sources, built with nvcc at first use
  testing.py the book's single-ray queries (intersections, normals,
            prepare_computations, shade_hit, ...) through the real pipeline

`python -m rtc_tpu_torch out.ppm [width]` renders a registry scene to a
PPM file (cli.py), on the card unless `--device cpu` is given.
intersect_all and hit_index are the book's World::intersect and
Intersection::hit for a wavefront of rays.
"""

from . import diff  # noqa: F401
from .io.canvas import Canvas, write_ppm  # noqa: F401
from .models.scenes import REGISTRY  # noqa: F401
from .render.camera import Camera  # noqa: F401
from .render.integrator import (  # noqa: F401
    Intersections,
    color_at,
    hit_index,
    intersect_all,
)
from .render.renderer import render  # noqa: F401
from .scene.compile import (Scene, compile_scene, params_from_numpy,  # noqa: F401
                            scene_from_numpy)
from .scene.materials import (  # noqa: F401
    Material,
    Pattern,
    checkers_pattern,
    gradient_pattern,
    ring_pattern,
    stripe_pattern,
    test_pattern,
)
from .scene.shapes import (  # noqa: F401
    cone,
    cube,
    cylinder,
    glass_sphere,
    group,
    infinite_cone,
    infinite_cylinder,
    mesh,
    plane,
    sphere,
    triangle,
)
from .scene.world import PointLight, World, default_world  # noqa: F401
from .utils.config import DEFAULT_CONFIG, RenderConfig  # noqa: F401
