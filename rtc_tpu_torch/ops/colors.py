"""Colors are (..., 3) RGB tensors, unclamped until the PPM is written
(counterpart of rtc_tpu/ops/colors.py; reference: src/color.rs). Their
arithmetic (+, -, scalar *, Hadamard *) is tensor arithmetic, so only the
constructor and the named colors are here. Each takes dtype and device,
the card by default, as compile_scene."""

from __future__ import annotations

import torch


def color(r, g, b, dtype=torch.float64, device="cuda"):
    parts = [torch.as_tensor(c, dtype=dtype, device=device) for c in (r, g, b)]
    return torch.stack(torch.broadcast_tensors(*parts), dim=-1)


def black(dtype=torch.float64, device="cuda"):
    return color(0.0, 0.0, 0.0, dtype, device)


def white(dtype=torch.float64, device="cuda"):
    return color(1.0, 1.0, 1.0, dtype, device)


def red(dtype=torch.float64, device="cuda"):
    return color(1.0, 0.0, 0.0, dtype, device)


def green(dtype=torch.float64, device="cuda"):
    return color(0.0, 1.0, 0.0, dtype, device)


def blue(dtype=torch.float64, device="cuda"):
    return color(0.0, 0.0, 1.0, dtype, device)
