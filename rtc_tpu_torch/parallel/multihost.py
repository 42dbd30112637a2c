"""Rendering and training across processes (counterpart of
rtc_tpu/parallel/multihost.py).

Every rank runs the same program: initialize() joins the process group,
rays shard over the grid of all ranks, and rank 0 keeps the assembled
image. On one host, torchrun starts the ranks and sets the environment
that initialize() reads; on one GPU, several ranks talk over gloo (NCCL
refuses two ranks on one device).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..diff import render_grad as RG
from ..render import integrator
from ..render.camera import Camera, camera_rays
from ..scene.compile import Scene
from ..utils.config import DEFAULT_CONFIG, RenderConfig
from . import collectives as coll
from .mesh import make_mesh, mesh_axis
from .shard import render_sharded


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """torch.distributed.init_process_group passthrough: with
    coordinator_address ('host:port'), num_processes and process_id, a TCP
    rendezvous there; without, the environment's (torchrun sets
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK). backend: 'gloo',
    'nccl', or None for torch's default."""
    if coordinator_address is None:
        dist.init_process_group(backend=backend)
    else:
        dist.init_process_group(backend=backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)


def render_multihost(scene: Scene, camera: Camera,
                     cfg: RenderConfig = DEFAULT_CONFIG,
                     shard_prims: bool = False) -> Optional[torch.Tensor]:
    """Render across every rank, all of them on 'rays' (make_mesh()), so
    shard_prims has no effect, as in rtc_tpu. Returns the (V, H, 3) image
    on rank 0 and None elsewhere."""
    mesh = make_mesh(device_type=scene.tri_p1.device.type)
    img = render_sharded(scene, camera, cfg, mesh, shard_prims)
    return img if dist.get_rank() == 0 else None


def train_step_multihost(scene: Scene, camera: Camera,
                         cfg: RenderConfig = DEFAULT_CONFIG):
    """The loss and gradients of one data-parallel step over every rank,
    all on 'rays' (rtc_tpu :66-144): the camera's rays, row-major, padded
    to a multiple of the ranks (origin 0, direction (1, 1, 1), as rtc_tpu
    pads them) and split evenly; each rank differentiates
    sum((color - 0.5)^2) over its rays with respect to the scene's
    DEFAULT_PARAMS (render_grad.inject_params, the autograd Functions of
    the kernels); the losses and gradients SUM over the ranks and divide
    by n_total, three times the padded ray count. Returns (loss,
    {name: gradient}) on every rank."""
    mesh = make_mesh(device_type=scene.tri_p1.device.type)
    rays = mesh_axis(mesh, "rays")
    device, dtype = scene.tri_p1.device, cfg.torch_dtype()
    o, d = camera_rays(camera.transform_inverse, camera.hsize, camera.vsize,
                       camera.half_width, camera.half_height, camera.pixel_size,
                       dtype, device=device)
    pad = (-o.shape[0]) % rays.size
    o = torch.cat([o, o.new_zeros((pad, 3))])
    d = torch.cat([d, d.new_ones((pad, 3))])
    n_total = o.shape[0] * 3
    n_local = o.shape[0] // rays.size
    mine = slice(rays.rank * n_local, (rays.rank + 1) * n_local)
    params = RG.extract_params(scene)
    img = integrator.color_at(RG.inject_params(scene, params), o[mine], d[mine], cfg)
    loss = torch.sum((img - 0.5) ** 2)
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    grads = {k: torch.zeros_like(v) if g is None else g
             for (k, v), g in zip(params.items(), grads)}
    loss = coll.all_reduce(loss.detach(), rays) / n_total
    return float(loss), {k: coll.all_reduce(g, rays) / n_total
                         for k, g in grads.items()}
