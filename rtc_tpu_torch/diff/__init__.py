"""Differentiable rendering (counterpart of rtc_tpu/diff/): gradients of
the image with respect to scene parameters and the camera pose
(render_grad), and parameter checkpoints (checkpoint)."""

from . import checkpoint, render_grad  # noqa: F401
