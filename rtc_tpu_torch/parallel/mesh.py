"""The rank grid of sharded rendering (counterpart of
rtc_tpu/parallel/mesh.py).

rtc_tpu lays its devices out as a JAX Mesh with the axes ('rays',
'prims'); here one process is one rank, and the ranks of the initialised
default process group form a 2-D torch DeviceMesh with the same axes:

  * 'rays'  — the ray wavefront, the data-parallel axis: the ranks of one
              rays group hold different rays, and their colors are
              gathered at the end;
  * 'prims' — the triangle table: the ranks of one prims group hold the
              same rays and different triangle shards, and combine their
              partial hits per sweep (parallel/collectives.py).

The integrator finds the group of cfg.prim_axis through the grid that a
sharded call made active (active_grid); outside one, a config that names
a prim axis raises.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import NamedTuple, Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("rays", "prims")

# the grid of the sharded call in progress (None outside one)
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("rtc_tpu_torch_grid",
                                                         default=None)


def _require_process_group() -> int:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group: call "
            "rtc_tpu_torch.parallel.multihost.initialize (or "
            "torch.distributed.init_process_group) on every rank first")
    return dist.get_world_size()


def make_mesh(n_rays: Optional[int] = None, n_prims: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """The ('rays', 'prims') grid over every rank of the default process
    group, n_rays x n_prims of them (n_rays defaults to the ranks left
    over). Every rank calls it: it makes the process groups of both axes.
    device_type is the ranks' device ('cpu' for CPU tensors)."""
    world = _require_process_group()
    if n_rays is None:
        n_rays = world // n_prims
    if n_rays < 1 or n_prims < 1 or n_rays * n_prims != world:
        raise ValueError(f"a {n_rays}x{n_prims} grid needs {n_rays * n_prims} "
                         f"ranks, and the process group has {world}")
    return init_device_mesh(device_type, (n_rays, n_prims), mesh_dim_names=AXES)


def single_device_mesh(device_type: str = "cuda") -> DeviceMesh:
    """The 1x1 grid of a process group of one rank."""
    return make_mesh(1, 1, device_type)


class Axis(NamedTuple):
    """One axis of the active grid, as this rank sees it."""

    group: dist.ProcessGroup
    rank: int   # this rank's place along the axis
    size: int   # ranks along the axis


@contextlib.contextmanager
def active_grid(mesh: DeviceMesh):
    """Make mesh the grid whose axes cfg.prim_axis names, for the body."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def mesh_axis(mesh: DeviceMesh, name: str) -> Axis:
    """The axis name of mesh, as this rank sees it."""
    if name not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the grid has the axes {mesh.mesh_dim_names}, "
                         f"not {name!r}")
    return Axis(mesh.get_group(name), mesh.get_local_rank(name),
                mesh.size(mesh.mesh_dim_names.index(name)))


def axis(name: str) -> Axis:
    """The axis name of the active grid; raises outside a sharded call."""
    mesh = _ACTIVE.get()
    if mesh is None:
        raise RuntimeError(
            f"RenderConfig(prim_axis={name!r}) names an axis of a rank grid, "
            "and no sharded call is in progress: render it through "
            "rtc_tpu_torch.parallel.shard.render_sharded")
    return mesh_axis(mesh, name)
