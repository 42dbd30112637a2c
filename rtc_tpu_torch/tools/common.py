"""What the tools share: the frame's rays in render()'s order, the device
a run names, and host-clock timing that waits for the card."""

from __future__ import annotations

import time

import torch

from ..render.camera import Camera, camera_rays_for_pixels
from ..render.renderer import pixel_order


def frame_rays(cam: Camera, device, dtype=torch.float32):
    """The camera's primary rays (o, d), each (V * H, 3), in render()'s
    trace order (renderer.pixel_order: 16x16 blocks, block-major)."""
    px, py, _, _ = pixel_order(cam.vsize, cam.hsize, "morton", device)
    o, d = camera_rays_for_pixels(cam.transform_inverse, px, py, cam.half_width,
                                  cam.half_height, cam.pixel_size, dtype)
    return o.contiguous(), d.contiguous()


def device_name(device) -> str:
    """The card's name (torch.cuda.get_device_name), or "cpu"."""
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def synchronize(device) -> None:
    """Wait for the card's queued work; nothing to wait for on the CPU."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timeit(fn, device, iters: int = 3) -> float:
    """Seconds a call of fn() on the host clock: one warm-up call, then
    iters calls back to back and one synchronize at the end."""
    fn()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    synchronize(device)
    return (time.perf_counter() - t0) / iters
