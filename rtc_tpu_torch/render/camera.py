"""Camera and batched primary-ray generation (counterpart of
rtc_tpu/render/camera.py; reference: src/camera.rs)."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass
class Camera:
    hsize: int
    vsize: int
    field_of_view: float
    transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(4, dtype=np.float64)
    )

    def __post_init__(self):
        # half extents / pixel size (reference: src/camera.rs:16-41)
        half_view = math.tan(self.field_of_view / 2.0)
        aspect = self.hsize / self.vsize
        if aspect >= 1.0:
            self.half_width = half_view
            self.half_height = half_view / aspect
        else:
            self.half_width = half_view * aspect
            self.half_height = half_view
        self.pixel_size = self.half_width * 2.0 / self.hsize

    def set_transform(self, m) -> "Camera":
        """(reference: src/camera.rs:43-46)"""
        self.transform = np.asarray(m, dtype=np.float64).reshape(4, 4)
        return self

    @property
    def transform_inverse(self) -> np.ndarray:
        return np.linalg.inv(self.transform)


def camera_values(camera: Camera) -> np.ndarray:
    """The (19,) float64 values a frame's rays depend on, rtc_tpu's
    _gen_rays arguments: the inverse transform row-major, half_width,
    half_height and pixel_size. A compiled frame (render/compiled.py)
    takes them as its graph input, so a new camera on the same canvas
    replays the same graph."""
    return np.concatenate([camera.transform_inverse.reshape(16),
                           [camera.half_width, camera.half_height,
                            camera.pixel_size]]).astype(np.float64)


def rays_from_values(values, px, py):
    """camera_rays_for_pixels on camera_values as one (19,) tensor on px's
    device, in the rays' dtype: its views go in as they are, with no copy
    from the host (the inputs of a captured frame)."""
    return camera_rays_for_pixels(values[:16].view(4, 4), px, py, values[16],
                                  values[17], values[18], values.dtype)


def camera_rays_for_pixels(inv, px, py, half_width, half_height, pixel_size,
                           dtype=torch.float32):
    """Primary rays for explicit pixel coordinates: ray_for_pixel
    (src/camera.rs:48-65) batched over any pixel order.

    inv: (4, 4) camera inverse; px/py: (R,) integer tensors, whose device
    the rays are made on; inv and the three scalars are arrays, numbers, or
    tensors, which are used as they are when they are on that device in
    dtype (as_tensor copies nothing then) and converted otherwise. Per-pixel
    arithmetic is elementwise, so every pixel order gives the same values
    per pixel. Returns (R, 3) origins and unit directions.
    """
    dev = px.device
    inv = torch.as_tensor(inv, dtype=dtype, device=dev)
    hw, hh, ps = (torch.as_tensor(v, dtype=dtype, device=dev)
                  for v in (half_width, half_height, pixel_size))
    wx = hw - (px.to(dtype) + 0.5) * ps  # +x is LEFT
    wy = hh - (py.to(dtype) + 0.5) * ps
    # canvas plane z = -1, w = 1 (src/camera.rs:60)
    pix = torch.stack([wx, wy, torch.full_like(wx, -1.0), torch.ones_like(wx)],
                      dim=-1)
    pixel_world = (pix @ inv.T)[:, :3]
    origin = inv[:3, 3]
    direction = pixel_world - origin
    norm = torch.sqrt(torch.sum(direction * direction, dim=-1, keepdim=True))
    direction = direction / torch.clamp_min(norm, 1e-30)
    return origin.expand_as(direction), direction


def camera_rays(inv, hsize: int, vsize: int, half_width, half_height,
                pixel_size, dtype=torch.float32, device=None):
    """All primary rays, row-major like the reference's y/x loop
    (src/camera.rs:67-79). Returns (R, 3) origins and directions, on
    device, which defaults to the camera matrix's: a tensor's device, the
    CPU for a numpy matrix."""
    if device is None:
        device = inv.device if isinstance(inv, torch.Tensor) else "cpu"
    idx = torch.arange(hsize * vsize, dtype=torch.int64, device=device)
    return camera_rays_for_pixels(inv, idx % hsize, idx // hsize, half_width,
                                  half_height, pixel_size, dtype)
