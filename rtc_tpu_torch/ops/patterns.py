"""Procedural patterns (counterpart of rtc_tpu/ops/patterns.py; reference:
src/pattern.rs:68-95).

Kinds are integer codes so that a table of objects is evaluated without
branches: every kind's color is computed and selected by mask. The
compiler has already folded the shape and pattern inverses into one (3, 4)
affine per object (src/pattern.rs:98-103).
"""

from __future__ import annotations

import torch

from ..scene.materials import CHECKERS, GRADIENT, NONE, RING, STRIPE, TEST

# rtc_tpu's documented deviation from the reference, kept exactly: every
# floor()-based pattern nudges its coordinate by +PATTERN_EPS before
# flooring, so a coordinate that lands on a cell boundary reads one cell
# whatever the rounding of the hit point (rtc_tpu/ops/patterns.py:16-32).
PATTERN_EPS = 1e-4


def _parity_even(v):
    """Rust's `x % 2.0 == 0.0` on a floored value (src/pattern.rs:71)."""
    return torch.remainder(v, 2.0) == 0.0


def stripe(p, a, b):
    """(reference: src/pattern.rs:70-76)"""
    cond = _parity_even(torch.floor(p[..., 0] + PATTERN_EPS))
    return torch.where(cond[..., None], a, b)


def gradient(p, a, b):
    """Lerp on fract(x) (reference: src/pattern.rs:77)."""
    frac = p[..., 0] - torch.floor(p[..., 0])
    return a + (b - a) * frac[..., None]


def ring(p, a, b):
    """Radial rings in xz (reference: src/pattern.rs:78-84)."""
    r = torch.sqrt(p[..., 0] * p[..., 0] + p[..., 2] * p[..., 2])
    cond = _parity_even(torch.floor(r + PATTERN_EPS))
    return torch.where(cond[..., None], a, b)


def checkers(p, a, b):
    """3D checkerboard (reference: src/pattern.rs:85-91)."""
    s = (torch.floor(p[..., 0] + PATTERN_EPS)
         + torch.floor(p[..., 1] + PATTERN_EPS)
         + torch.floor(p[..., 2] + PATTERN_EPS))
    return torch.where(_parity_even(s)[..., None], a, b)


def test(p, a, b):
    """The pattern-space point as a color (src/pattern.rs:92-93)."""
    return p


test.__test__ = False  # a pattern kind, not a pytest case


def color_at(p, kind, a, b):
    """p: (..., 3) pattern-space points; kind: (...,) codes; a/b: (..., 3).
    kind NONE yields `a` (callers pass the material color there)."""
    out = torch.where((kind == NONE)[..., None], a, 0.0)
    for code, fn in ((STRIPE, stripe), (GRADIENT, gradient), (RING, ring),
                     (CHECKERS, checkers), (TEST, test)):
        out = torch.where((kind == code)[..., None], fn(p, a, b), out)
    return out
