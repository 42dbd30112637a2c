"""Render configuration (counterpart of rtc_tpu/utils/config.py).

The field names and defaults are rtc_tpu's, so one set of knobs drives
both packages. Only the triangle intersector choices differ.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .constants import EPSILON

MESH_IMPLS = ("auto", "bruteforce", "kernel", "elementwise")


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration for a render.

    Attributes:
      max_depth: recursion budget with the reference's RECURSION_LIMIT
        semantics (src/world.rs:11): 5 yields two shading levels.
      epsilon: offset for over points and the parallel-ray guard.
      dtype: 'float32' or 'float64'.
      ray_tile: rays per wavefront tile; the renderer shades the frame tile
        by tile to bound the working set. The default is the whole 1920x960
        frame: of the tiles 8,192, 65,536, 262,144, 460,800 and the frame,
        the frame was the fastest on every scene of the sweep (cow, teapot,
        teapot_smooth, glass_teapot, both herds and table; at most 7.3 GiB
        peak, table's) on an NVIDIA H100 80GB HBM3 at 700 W, by the rule
        "the fastest, or within 10% of it, on every scene with a peak under
        40 GiB" (rtc_tpu_torch.tools.bench --tile=N; PERF.md). The sweep
        ran the f32 render on the card; float64, the CPU, gradients and
        sharded renders were not measured at this tile. Progressive
        rendering keeps rtc_tpu's 8,192 (render/progressive.py): its tile
        is the unit a checkpoint saves.
      mesh_impl: triangle intersector. 'kernel' runs the hand-written CUDA
        kernels (f32 tensors on a CUDA device only); 'bruteforce' the dense
        PyTorch sweep; 'auto' picks 'kernel' for f32 tensors on CUDA and
        'bruteforce' otherwise (f64 conformance mode, CPU). 'elementwise'
        is the cross-check backend, the elementwise kernels K7a/K7b over
        the world table in table order (f32 tensors on a CUDA device
        only). rtc_tpu names its backends 'mxu' (here 'kernel') and
        'pallas' (here 'elementwise').
      shadows: cast shadow rays (the reference always does).
      ray_order: 'morton' renders pixels in compact screen blocks (16x16
        block-major, or Z-order when the canvas does not divide into
        blocks); 'scanline' is the reference's order. Pure permutation.
      prim_axis: the name of the rank grid's axis over which the triangle
        table is sharded ('prims'), or None. parallel/shard.py sets it
        inside a sharded call, where the scene is one rank's shard and the
        integrator combines its partial hits over that axis's group (the
        grid the call made active, parallel/mesh.py); rendering with it
        outside a sharded call raises.
      fused_shadow: let pure-mesh scenes run the fused closest+shadow
        kernel (integrator._use_fused_shadow); False forces the split
        closest-hit and any-hit sweeps.
    """

    max_depth: int = 5
    epsilon: float = EPSILON
    dtype: str = "float32"
    ray_tile: int = 1920 * 960
    mesh_impl: str = "auto"
    shadows: bool = True
    ray_order: str = "morton"
    prim_axis: Optional[str] = None
    fused_shadow: bool = True

    def __post_init__(self):
        if self.mesh_impl not in MESH_IMPLS:
            raise ValueError(f"mesh_impl must be one of {MESH_IMPLS}, "
                             f"got {self.mesh_impl!r}")

    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "float64": torch.float64}[self.dtype]


DEFAULT_CONFIG = RenderConfig()
