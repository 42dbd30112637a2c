"""Ray ordering: Morton (Z-order) pixel traversal (counterpart of
rtc_tpu/render/order.py).

A kernel's cost per group of rays follows how many clusters those rays
overlap together; rays of a compact screen block share most of them.
Ordering is a pure permutation: every per-ray computation is elementwise,
so rendering in Morton order and inverse-permuting the colors is exact.
"""

from __future__ import annotations

import numpy as np


def _spread2(v: np.ndarray) -> np.ndarray:
    """Spread the low 32 bits of v so they occupy even bit positions."""
    v = v.astype(np.uint64)
    v = (v | (v << 16)) & np.uint64(0x0000FFFF0000FFFF)
    v = (v | (v << 8)) & np.uint64(0x00FF00FF00FF00FF)
    v = (v | (v << 4)) & np.uint64(0x0F0F0F0F0F0F0F0F)
    v = (v | (v << 2)) & np.uint64(0x3333333333333333)
    v = (v | (v << 1)) & np.uint64(0x5555555555555555)
    return v


def morton_perm(vsize: int, hsize: int):
    """(perm, inv_perm) int64 arrays: perm lists flat pixel indices in
    Z-order; colors rendered in that order are restored with
    colors[inv_perm]."""
    yy, xx = np.meshgrid(
        np.arange(vsize, dtype=np.uint64),
        np.arange(hsize, dtype=np.uint64),
        indexing="ij",
    )
    code = _spread2(xx.ravel()) | (_spread2(yy.ravel()) << np.uint64(1))
    perm = np.argsort(code, kind="stable")
    inv = np.argsort(perm, kind="stable")
    return perm, inv
