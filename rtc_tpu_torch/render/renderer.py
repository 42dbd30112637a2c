"""Top-level render loop: camera -> tiled wavefronts -> image (counterpart
of rtc_tpu/render/renderer.py).

Rays are generated on the scene's device directly in tile order, shaded
`ray_tile` rays at a time so the working set stays bounded at any
resolution, and put back in row-major order at the end.
"""

from __future__ import annotations

import torch

from ..scene.compile import Scene
from ..utils.config import DEFAULT_CONFIG, RenderConfig
from ..utils.constants import FAR, PARK
from . import integrator
from .camera import Camera, camera_rays_for_pixels
from .order import morton_perm

BLOCK = 16  # 16x16 = 256 pixels per screen block


def _shade_rays(scene: Scene, o, d, cfg: RenderConfig):
    n_rays = o.shape[0]
    tile = min(cfg.ray_tile, n_rays)
    n_tiles = -(-n_rays // tile)
    pad = n_tiles * tile - n_rays
    # pad rays are parked, so the traversal culls them at once
    o = torch.cat([o, o.new_full((pad, 3), FAR)])
    d = torch.cat([d, d.new_full((pad, 3), PARK)])
    colors = [integrator.color_at(scene, o[i:i + tile], d[i:i + tile], cfg)
              for i in range(0, n_tiles * tile, tile)]
    return torch.cat(colors)[:n_rays]


def blocked_pixels(vsize: int, hsize: int, device):
    """Block-major pixel coordinates: 16x16 blocks in row-major block
    order, row-major inside each block."""
    idx = torch.arange(vsize * hsize, dtype=torch.int64, device=device)
    block, within = idx // (BLOCK * BLOCK), idx % (BLOCK * BLOCK)
    hb = hsize // BLOCK
    px = (block % hb) * BLOCK + within % BLOCK
    py = (block // hb) * BLOCK + within // BLOCK
    return px, py


def _unblock(colors, vsize: int, hsize: int):
    """Block-major ray order -> row-major image: layout ops only."""
    vb, hb = vsize // BLOCK, hsize // BLOCK
    return (colors.reshape(vb, hb, BLOCK, BLOCK, 3)
            .permute(0, 2, 1, 3, 4)
            .reshape(vsize, hsize, 3))


@torch.no_grad()
def render(scene: Scene, camera: Camera, cfg: RenderConfig = DEFAULT_CONFIG):
    """Render to a (V, H, 3) image tensor on the scene's device.

    When the canvas divides into 16x16 blocks and ray_order is 'morton',
    pixels are traced block-major: each screen block is a compact group of
    rays, and the un-permute is a reshape. Other sizes fall back to Morton
    order with a gathered un-permute.
    """
    dtype = cfg.torch_dtype()
    device = scene.tri_p1.device
    vsize, hsize = camera.vsize, camera.hsize
    morton = cfg.ray_order == "morton"
    blocked = morton and vsize % BLOCK == 0 and hsize % BLOCK == 0
    inv_perm = None
    if blocked:
        px, py = blocked_pixels(vsize, hsize, device)
    elif morton:
        perm, inv = morton_perm(vsize, hsize)
        perm = torch.as_tensor(perm, device=device)
        inv_perm = torch.as_tensor(inv, device=device)
        px, py = perm % hsize, perm // hsize
    else:
        idx = torch.arange(vsize * hsize, dtype=torch.int64, device=device)
        px, py = idx % hsize, idx // hsize
    o, d = camera_rays_for_pixels(camera.transform_inverse, px, py,
                                  camera.half_width, camera.half_height,
                                  camera.pixel_size, dtype)
    colors = _shade_rays(scene, o, d, cfg)
    if blocked:
        return _unblock(colors, vsize, hsize)
    if inv_perm is not None:
        colors = colors[inv_perm]
    return colors.reshape(vsize, hsize, 3)
