"""Transforms, the view transform and camera rays of the Ray Tracer
Challenge, in float64 NumPy for the 4x4 matrices and plain torch for the
rays."""

from __future__ import annotations

import math

import numpy as np
import torch

from .precision import mm


def translation(x, y, z):
    m = np.eye(4)
    m[:3, 3] = (x, y, z)
    return m


def scaling(x, y, z):
    return np.diag([float(x), float(y), float(z), 1.0])


def rotation_x(r):
    c, s = math.cos(r), math.sin(r)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]], np.float64)


def rotation_y(r):
    c, s = math.cos(r), math.sin(r)
    return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]], np.float64)


def rotation_z(r):
    c, s = math.cos(r), math.sin(r)
    return np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float64)


OPS = {"translation": translation, "scaling": scaling, "rotation_x": rotation_x,
       "rotation_y": rotation_y, "rotation_z": rotation_z}


def compose(ops) -> np.ndarray:
    """The product, left to right, of a configuration's list of
    [name, args...] transforms (identity for none)."""
    m = np.eye(4)
    for name, *args in ops or ():
        m = m @ OPS[name](*args)
    return m


def view_transform(frm, to, up) -> np.ndarray:
    frm, to, up = (np.asarray(v, np.float64) for v in (frm, to, up))
    forward = (to - frm) / np.linalg.norm(to - frm)
    left = np.cross(forward, up / np.linalg.norm(up))
    true_up = np.cross(left, forward)
    orientation = np.eye(4)
    orientation[0, :3], orientation[1, :3], orientation[2, :3] = left, true_up, -forward
    return orientation @ translation(*(-frm))


def camera_frame(width: int, height: int, fov: float):
    """(half_width, half_height, pixel_size) of a canvas."""
    half_view = math.tan(fov / 2.0)
    aspect = width / height
    if aspect >= 1.0:
        hw, hh = half_view, half_view / aspect
    else:
        hw, hh = half_view * aspect, half_view
    return hw, hh, hw * 2.0 / width


def pixel_rays(transform, width, height, fov, px, py, dtype, device):
    """Primary rays through pixel centres (px, py): (R, 3) origins and unit
    directions. transform: the camera's (4, 4) view transform, or a (R, 4,
    4) stack of them, one a ray."""
    hw, hh, ps = camera_frame(width, height, fov)
    inv = torch.as_tensor(np.linalg.inv(transform), dtype=dtype, device=device)
    px = torch.as_tensor(px, device=device).to(dtype)
    py = torch.as_tensor(py, device=device).to(dtype)
    wx = hw - (px + 0.5) * ps
    wy = hh - (py + 0.5) * ps
    pix = torch.stack([wx, wy, -torch.ones_like(wx), torch.ones_like(wx)], -1)
    if inv.dim() == 2:
        world = mm(pix, inv.T)
        origin = inv[:3, 3].expand(len(px), 3)
    else:
        world = mm(pix.unsqueeze(1), inv.transpose(1, 2)).squeeze(1)
        origin = inv[:, :3, 3]
    d = world[:, :3] - origin
    return origin.contiguous(), d / torch.linalg.norm(d, dim=-1, keepdim=True)


def blocked_pixels(width: int, height: int, device, block: int = 16):
    """Every pixel in 16x16 screen blocks (row-major blocks, row-major
    inside each), the order a renderer that traces screen blocks uses."""
    idx = torch.arange(width * height, device=device)
    b, w = idx // (block * block), idx % (block * block)
    hb = width // block
    return (b % hb) * block + w % block, (b // hb) * block + w // block
