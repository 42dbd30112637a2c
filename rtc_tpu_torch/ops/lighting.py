"""Phong shading (counterpart of rtc_tpu/ops/lighting.py; reference:
src/material.rs:32-75).

Faithful gating: diffuse and specular are zeroed in shadow; diffuse needs
light_dot_normal >= 0; specular also needs reflect_dot_eye > 0 and scales
the raw light intensity, not the effective color.
"""

from __future__ import annotations

import torch

from .vec import dot3, normalize3, pack3, unpack3


def lighting(
    surface_color,     # (R, 3) material color
    ambient, diffuse, specular, shininess,     # (R,) each
    light_position,    # (3,)
    light_intensity,   # (3,)
    point, eyev, normalv,  # (R, 3) each
    in_shadow,         # (R,) bool
):
    """Packed-input view of lighting3 (rtc_tpu ops/lighting.py:19-35)."""
    return lighting3(surface_color, ambient, diffuse, specular, shininess,
                     light_position, light_intensity, unpack3(point),
                     unpack3(eyev), unpack3(normalv), in_shadow)


def lighting3(
    surface_color,     # (R, 3) material color
    ambient, diffuse, specular, shininess,     # (R,) each
    light_position,    # (3,)
    light_intensity,   # (3,)
    p3, e3, n3,        # component tuples: three (R,) tensors each
    in_shadow,         # (R,) bool
):
    # every multiply/add below keeps rtc_tpu's association order, so the
    # f64 goldens stay bit-stable
    scx, scy, scz = unpack3(surface_color)
    lix, liy, liz = unpack3(light_intensity.expand_as(surface_color))
    efx, efy, efz = scx * lix, scy * liy, scz * liz
    lit, dl, spec_on, sf = phong_terms(
        diffuse, specular, shininess, unpack3(light_position.expand_as(surface_color)),
        p3, e3, n3, in_shadow)
    dfx = torch.where(lit, efx * dl, 0.0)
    dfy = torch.where(lit, efy * dl, 0.0)
    dfz = torch.where(lit, efz * dl, 0.0)
    spx = torch.where(spec_on, lix * sf, 0.0)
    spy = torch.where(spec_on, liy * sf, 0.0)
    spz = torch.where(spec_on, liz * sf, 0.0)

    return pack3(efx * ambient + dfx + spx,
                 efy * ambient + dfy + spy,
                 efz * ambient + dfz + spz)


def phong_terms(diffuse, specular, shininess, lp3, p3, e3, n3, in_shadow):
    """lighting3's terms a ray, with the light's position lp3 in component
    form: (lit, dl, spec_on, sf), so that the colour is ef * ambient, plus
    ef * dl where lit, plus intensity * sf where spec_on (ef the surface
    colour times the intensity)."""
    px, py, pz = p3
    ex, ey, ez = e3
    nx, ny, nz = n3
    lpx, lpy, lpz = lp3
    lvx, lvy, lvz = normalize3(lpx - px, lpy - py, lpz - pz)

    ldn = dot3(lvx, lvy, lvz, nx, ny, nz)
    lit = (~in_shadow) & (ldn >= 0.0)
    dl = diffuse * ldn

    # reflect(-lightv, normalv)
    k = 2.0 * dot3(-lvx, -lvy, -lvz, nx, ny, nz)
    rx, ry, rz = -lvx - nx * k, -lvy - ny * k, -lvz - nz * k
    rde = dot3(rx, ry, rz, ex, ey, ez)
    spec_on = lit & (rde > 0.0)
    factor = torch.where(spec_on, torch.clamp_min(rde, 1e-30), 1.0) ** shininess
    return lit, dl, spec_on, specular * factor
