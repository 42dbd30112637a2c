"""Square matrices with the reference's Matrix<SIZE> API (counterpart of
rtc_tpu/ops/matrices.py; reference: src/matrix.rs).

Matrices are plain (..., n, n) tensors; every function broadcasts over
the batch axes. A numpy matrix (the transform factories of
ops/transforms.py make them) is taken as a host tensor, or, beside a
tensor, in that tensor's dtype and on its device. determinant and
inverse go through LU; submatrix, minor and cofactor keep the
reference's cofactor API for the book's tables.

Scene compilation does not use the generic inverse: it inverts affine
transforms on the host in float64 (scene/compile.py).
"""

from __future__ import annotations

import torch

from ..utils.constants import EPSILON


def _tensors(a, b):
    """a and b as tensors, a numpy side taking the tensor side's dtype and
    device."""
    if isinstance(a, torch.Tensor):
        return a, torch.as_tensor(b, dtype=a.dtype, device=a.device)
    b = torch.as_tensor(b)
    return torch.as_tensor(a, dtype=b.dtype, device=b.device), b


def identity(n: int = 4, dtype=torch.float64, device="cuda"):
    """(reference: src/matrix.rs:19-27)"""
    return torch.eye(n, dtype=dtype, device=device)


def transpose(m):
    """(reference: src/matrix.rs:29-39)"""
    return torch.as_tensor(m).transpose(-1, -2)


def matmul(a, b):
    """Matrix x matrix (reference: src/matrix.rs:187-205)."""
    a, b = _tensors(a, b)
    return a @ b


def mul_tuple(m, t):
    """4x4 matrix x homogeneous tuple (reference: src/matrix.rs:207-227)."""
    t, m = _tensors(t, m)
    return torch.einsum("...ij,...j->...i", m, t)


def submatrix(m, row: int, col: int):
    """Delete one row and one column (reference: src/matrix.rs:55-113)."""
    m = torch.as_tensor(m)
    n = m.shape[-1]
    rows = [i for i in range(n) if i != row]
    cols = [j for j in range(n) if j != col]
    return m[..., rows, :][..., :, cols]


def determinant(m):
    """(reference: src/matrix.rs:41-52)"""
    return torch.linalg.det(torch.as_tensor(m))


def minor(m, row: int, col: int):
    """Determinant of the submatrix (reference: src/matrix.rs:115-121)."""
    return determinant(submatrix(m, row, col))


def cofactor(m, row: int, col: int):
    """Sign-adjusted minor (reference: src/matrix.rs:123-136)."""
    sign = -1.0 if (row + col) % 2 else 1.0
    return sign * minor(m, row, col)


def is_invertible(m, eps: float = EPSILON):
    """The reference's inverse() returns None on a zero determinant
    (src/matrix.rs:138-157); here singularity is a predicate."""
    return torch.abs(determinant(m)) > eps


def inverse(m):
    """General inverse (reference: src/matrix.rs:138-157). A singular
    input gives non-finite entries and no exception, as rtc_tpu's does:
    torch.linalg.inv raises there, inv_ex reports it in a flag that this
    function drops. Check is_invertible for the reference's Option."""
    return torch.linalg.inv_ex(torch.as_tensor(m)).inverse


def almost_equal(a, b, eps: float = EPSILON):
    """Elementwise approximate equality, all-reduced over the matrix axes
    (reference: src/matrix.rs:174-185)."""
    a, b = _tensors(a, b)
    return torch.all((torch.abs(a - b) < eps).flatten(-2), dim=-1)
