"""Affine transform factories for scene building (counterpart of the numpy
branch of rtc_tpu/ops/transforms.py; reference: src/transformations.rs).

All return (4, 4) float64 numpy matrices: scenes are built on the host, and
compile_scene bakes every transform before any tensor exists. Composition
order matches the reference: C @ B @ A applies A first.
"""

from __future__ import annotations

import math

import numpy as np


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
    """Camera world->view matrix (reference: src/transformations.rs:80-93)."""
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
