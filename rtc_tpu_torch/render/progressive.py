"""Progressive tile rendering with checkpoint/resume (counterpart of
rtc_tpu/render/progressive.py).

A render is a pure function of (scene, camera, config), so tiles are
idempotent work units: finished tiles are persisted, and a crashed or
preempted render resumes from the last checkpoint. The checkpoint is
rtc_tpu's .npz layout (flat, next_tile, tile), so either package resumes
the other's file.

The default config is RenderConfig's with rtc_tpu's tile, 8,192 rays: a
tile is the unit a checkpoint saves, and a checkpoint resumes only at the
tile it was written with. The renderer's own default tile is a whole
1920x960 frame, which would save nothing before the render ends and
resume no file rtc_tpu writes at its defaults.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ..scene.compile import Scene
from ..utils.config import RenderConfig
from ..utils.constants import FAR, PARK
from . import integrator
from .camera import Camera, camera_rays

CHECKPOINT_CONFIG = RenderConfig(ray_tile=8192)


def render_tiles(scene: Scene, camera: Camera, cfg: RenderConfig = CHECKPOINT_CONFIG,
                 start_tile: int = 0) -> Iterator[Tuple[int, int, np.ndarray]]:
    """Yield (tile_index, n_tiles, colors (tile, 3)) in scanline order, one
    host copy a tile. Deterministic: tile i is identical across runs. The
    rays are made on the scene's device; the last tile's pad rays are
    parked as render() parks them."""
    o, d = camera_rays(camera.transform_inverse, camera.hsize, camera.vsize,
                       camera.half_width, camera.half_height, camera.pixel_size,
                       cfg.torch_dtype(), device=scene.tri_p1.device)
    n_rays = o.shape[0]
    tile = min(cfg.ray_tile, n_rays)
    n_tiles = -(-n_rays // tile)
    pad = n_tiles * tile - n_rays
    o = torch.cat([o, o.new_full((pad, 3), FAR)])
    d = torch.cat([d, d.new_full((pad, 3), PARK)])
    for i in range(start_tile, n_tiles):
        with torch.no_grad():
            colors = integrator.color_at(scene, o[i * tile:(i + 1) * tile],
                                         d[i * tile:(i + 1) * tile], cfg)
        yield i, n_tiles, colors.cpu().numpy()


def render_with_checkpoints(scene: Scene, camera: Camera,
                            cfg: RenderConfig = CHECKPOINT_CONFIG,
                            checkpoint_path: Optional[str] = None,
                            checkpoint_every: int = 8) -> np.ndarray:
    """Render tile by tile into a float64 (V, H, 3) host image, persisting
    progress every checkpoint_every tiles and after the last; resumes
    automatically when checkpoint_path holds a partial render of the same
    shape and tile."""
    n_rays = camera.hsize * camera.vsize
    tile = min(cfg.ray_tile, n_rays)
    n_tiles = -(-n_rays // tile)
    flat = np.zeros((n_tiles * tile, 3), dtype=np.float64)
    start = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        with np.load(checkpoint_path) as ck:
            if ck["flat"].shape == flat.shape and int(ck["tile"]) == tile:
                flat = ck["flat"]
                start = int(ck["next_tile"])
    for i, total, colors in render_tiles(scene, camera, cfg, start_tile=start):
        flat[i * tile:(i + 1) * tile] = colors
        if checkpoint_path and ((i + 1) % checkpoint_every == 0 or i + 1 == total):
            np.savez(checkpoint_path, flat=flat, next_tile=i + 1, tile=tile)
    return flat[:n_rays].reshape(camera.vsize, camera.hsize, 3)
