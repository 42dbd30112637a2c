"""Affine transform factories for scene building (counterpart of the numpy
branch of rtc_tpu/ops/transforms.py; reference: src/transformations.rs).

All return (4, 4) float64 numpy matrices: scenes are built on the host, and
compile_scene bakes every transform before any tensor exists. Composition
order matches the reference: C @ B @ A applies A first. view_transform
also takes tensors, and then returns a differentiable (4, 4) tensor (the
counterpart of rtc_tpu's traced branch), through which diff.render_grad
differentiates the camera pose.

affine_inverse, transform_points and transform_dirs apply such a matrix
(numpy or tensor) to tensors, on the points' or the matrix's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .vec import cross3, normalize


def translation(x, y, z):
    """(reference: src/transformations.rs:4-11)"""
    m = np.eye(4)
    m[0, 3], m[1, 3], m[2, 3] = x, y, z
    return m


def scaling(x, y, z):
    """(reference: src/transformations.rs:13-21)"""
    return np.diag([float(x), float(y), float(z), 1.0])


def rotation_x(rad):
    """(reference: src/transformations.rs:23-35)"""
    c, s = math.cos(rad), math.sin(rad)
    m = np.eye(4)
    m[1, 1] = c; m[2, 2] = c; m[1, 2] = -s; m[2, 1] = s
    return m


def rotation_y(rad):
    """(reference: src/transformations.rs:37-49)"""
    c, s = math.cos(rad), math.sin(rad)
    m = np.eye(4)
    m[0, 0] = c; m[2, 2] = c; m[0, 2] = s; m[2, 0] = -s
    return m


def rotation_z(rad):
    """(reference: src/transformations.rs:51-63)"""
    c, s = math.cos(rad), math.sin(rad)
    m = np.eye(4)
    m[0, 0] = c; m[1, 1] = c; m[0, 1] = -s; m[1, 0] = s
    return m


def shearing(xy, xz, yx, yz, zx, zy):
    """(reference: src/transformations.rs:65-78)"""
    m = np.eye(4)
    m[0, 1], m[0, 2] = xy, xz
    m[1, 0], m[1, 2] = yx, yz
    m[2, 0], m[2, 1] = zx, zy
    return m


def view_transform(from_pt, to_pt, up):
    """Camera world->view matrix (reference: src/transformations.rs:80-93).
    Given any tensor argument, a tensor in that tensor's dtype and device,
    differentiable with respect to every tensor argument (rtc_tpu
    ops/transforms.py:103-130); else a float64 numpy matrix."""
    ref = next((a for a in (from_pt, to_pt, up) if isinstance(a, torch.Tensor)), None)
    if ref is not None:
        return _view_transform_tensor(
            *(torch.as_tensor(a, dtype=ref.dtype, device=ref.device)
              for a in (from_pt, to_pt, up)))
    f = np.asarray(to_pt, dtype=np.float64) - np.asarray(from_pt, dtype=np.float64)
    f = f / np.linalg.norm(f)
    upn = np.asarray(up, dtype=np.float64)
    upn = upn / np.linalg.norm(upn)
    left = np.cross(f, upn)
    true_up = np.cross(left, f)
    orientation = np.eye(4)
    orientation[0, :3] = left
    orientation[1, :3] = true_up
    orientation[2, :3] = -f
    return orientation @ translation(*(-np.asarray(from_pt, dtype=np.float64)))


def _view_transform_tensor(from_pt, to_pt, up):
    forward = normalize(to_pt - from_pt)
    left = torch.stack(cross3(*forward, *normalize(up)))
    true_up = torch.stack(cross3(*left, *forward))
    zero, one = from_pt.new_zeros(1), from_pt.new_ones(1)
    orientation = torch.stack([torch.cat([left, zero]), torch.cat([true_up, zero]),
                               torch.cat([-forward, zero]),
                               torch.cat([zero, zero, zero, one])])
    move = torch.cat([torch.eye(4, 3, dtype=from_pt.dtype, device=from_pt.device),
                      torch.cat([-from_pt, one])[:, None]], 1)
    return orientation @ move


def _tensor(m, like=None):
    """m as a tensor: like's dtype and device when given, else its own
    (a numpy matrix is a host tensor)."""
    if like is None:
        return torch.as_tensor(m)
    return torch.as_tensor(m, dtype=like.dtype, device=like.device)


def affine_inverse(m):
    """Analytic inverse of an affine (..., 4, 4) transform:
    [R t; 0 1]^-1 = [R^-1, -R^-1 t] (rtc_tpu ops/transforms.py:142-156;
    the reference inverts by cofactors, src/matrix.rs:138-157)."""
    m = _tensor(m)
    lin_inv = torch.linalg.inv(m[..., :3, :3])
    t_inv = -torch.einsum("...ij,...j->...i", lin_inv, m[..., :3, 3])
    top = torch.cat([lin_inv, t_inv[..., :, None]], dim=-1)
    bottom = m.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(m.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def transform_points(m, pts):
    """A (4, 4) (or (..., 3, 4) affine) transform applied to (..., 3) points."""
    m = _tensor(m, pts)
    return torch.einsum("...ij,...j->...i", m[..., :3, :3], pts) + m[..., :3, 3]


def transform_dirs(m, dirs):
    """The linear part of a transform applied to (..., 3) directions."""
    m = _tensor(m, dirs)
    return torch.einsum("...ij,...j->...i", m[..., :3, :3], dirs)
