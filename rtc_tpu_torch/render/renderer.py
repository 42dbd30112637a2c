"""Top-level render loop: camera -> tiled wavefronts -> image (counterpart
of rtc_tpu/render/renderer.py).

Rays are generated on the scene's device directly in tile order, shaded
`ray_tile` rays at a time so the working set stays bounded at any
resolution, and put back in row-major order at the end. On a CUDA device
the whole frame, ray generation to image, is one CUDA graph, captured once
per (scene, canvas, config) and replayed with the camera's values as its
input (render/compiled.py), as rtc_tpu jits it once per (scene shape,
canvas shape, config).
"""

from __future__ import annotations

import functools

import torch

from ..scene.compile import Scene
from ..utils.config import DEFAULT_CONFIG, RenderConfig
from ..utils.constants import FAR, PARK
from ..utils.profiling import span
from . import compiled, integrator
from .camera import Camera, camera_values, rays_from_values
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


@functools.lru_cache(maxsize=8)
def pixel_order(vsize: int, hsize: int, ray_order: str, device):
    """render()'s trace order: (px, py, blocked, inv_perm). When the canvas
    divides into 16x16 blocks and ray_order is 'morton', pixels go
    block-major (blocked, and the un-permute is a reshape); other sizes
    fall back to Morton order, undone by the gather inv_perm; 'scanline'
    is row-major (inv_perm None). Built once per canvas, order and device
    (rtc_tpu's _PERM_CACHE): the tensors are shared, so callers only read
    them, and a graph that reads them keeps them (render)."""
    morton = ray_order == "morton"
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
    return px, py, blocked, inv_perm


def _frame(scene: Scene, vsize: int, hsize: int, cfg: RenderConfig, order,
           values):
    """The (V, H, 3) image as a function of the camera's values
    (camera_values as a (19,) tensor on the scene's device, in cfg's
    dtype): rays in order's order (pixel_order's tuple), shaded, put back
    in row-major order. What a compiled frame captures."""
    px, py, blocked, inv_perm = order
    colors = _shade_rays(scene, *rays_from_values(values, px, py), cfg)
    if blocked:
        return _unblock(colors, vsize, hsize)
    if inv_perm is not None:
        colors = colors[inv_perm]
    return colors.reshape(vsize, hsize, 3)


@torch.no_grad()
def render(scene: Scene, camera: Camera, cfg: RenderConfig = DEFAULT_CONFIG):
    """Render to a (V, H, 3) image tensor on the scene's device, the
    pixels traced in pixel_order's order. On the graphed route
    (compiled.route) the frame replays its graph and the image is a copy
    of the graph's output; compiled.eager() runs it eagerly. Span
    rtc.render, around rtc.camera, rtc.route, compiled.run's and
    rtc.graph.output (the copy).
    """
    with span("rtc.render"):
        dtype = cfg.torch_dtype()
        device = scene.tri_p1.device
        vsize, hsize = camera.vsize, camera.hsize
        with span("rtc.camera"):
            values = torch.from_numpy(camera_values(camera)).to(dtype)
        order = pixel_order(vsize, hsize, cfg.ray_order, device)
        with span("rtc.route"):
            graphed = compiled.graphed(scene, cfg, device)
        if graphed:
            # the graph reads order's tensors, so it keeps them: pixel_order's
            # cache may drop them while the graph lives
            frame = functools.partial(_frame, scene, vsize, hsize, cfg, order)
            out = compiled.run(scene, ("frame", (vsize, hsize), cfg), frame, (values,),
                               f"the {hsize}x{vsize} frame", keep=order)
            with span("rtc.graph.output"):
                return out.clone()
        return _frame(scene, vsize, hsize, cfg, order, values.to(device))
