"""rtc_tpu_torch — rtc_tpu's ray tracer on PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

The layout mirrors rtc_tpu/, so each module's counterpart sits at the same
path. This package imports torch and numpy, never jax or rtc_tpu.

  ops/      numeric core; ops/kernels: the CUDA kernels and plain versions
  scene/    builder API + SoA compiler (host-side numpy, tensors at the end)
  render/   camera, wavefront integrator, renderer
  diff/     gradients of the image w.r.t. scene parameters and camera pose,
            parameter checkpoints (from rtc_tpu_torch.diff import
            render_grad as RG)
  io/       OBJ parser
  models/   the shipped scenes (cow, teapot_smooth, glass_teapot, teddy,
            cow_herd, cow_herd_smooth)
  csrc/     CUDA C++ sources, built with nvcc at first use
"""

from . import diff  # noqa: F401
from .models.scenes import REGISTRY  # noqa: F401
from .render.camera import Camera  # noqa: F401
from .render.renderer import render  # noqa: F401
from .scene.compile import (Scene, compile_scene, params_from_numpy,  # noqa: F401
                            scene_from_numpy)
from .scene.world import PointLight, World  # noqa: F401
from .utils.config import DEFAULT_CONFIG, RenderConfig  # noqa: F401
