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
        by tile to bound the working set.
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
      prim_axis: kept for parity with rtc_tpu; primitive sharding is not
        ported yet (ROADMAP queue 1 item 16), so it must stay None.
      fused_shadow: let pure-mesh scenes run the fused closest+shadow
        kernel (integrator._use_fused_shadow); False forces the split
        closest-hit and any-hit sweeps.
    """

    max_depth: int = 5
    epsilon: float = EPSILON
    dtype: str = "float32"
    ray_tile: int = 8192
    mesh_impl: str = "auto"
    shadows: bool = True
    ray_order: str = "morton"
    prim_axis: Optional[str] = None
    fused_shadow: bool = True

    def __post_init__(self):
        if self.mesh_impl not in MESH_IMPLS:
            raise ValueError(f"mesh_impl must be one of {MESH_IMPLS}, "
                             f"got {self.mesh_impl!r}")
        if self.prim_axis is not None:
            raise NotImplementedError(
                "primitive sharding is not ported yet (ROADMAP queue 1 "
                "item 16)")

    def torch_dtype(self) -> torch.dtype:
        return {"float32": torch.float32, "float64": torch.float64}[self.dtype]


DEFAULT_CONFIG = RenderConfig()
