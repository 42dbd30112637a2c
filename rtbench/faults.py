"""Faults planted under the timed path, to show that the check catches
them (rtbench/tests/test_check.py on the CPU; calibrate.py --fault on a
card, where a fit cell's limits are held against them). Each wraps the
Program's entry in place and returns a function that undoes it.

frames.stale   every frame returns the image of the first
frames.half    half of each image's pixels left out (black)
frames.altered each image's blue channel lowered by a tenth
fit.stale      the step computes its loss and leaves the parameters as
               they were
fit.half       the step sees the first half of the view's rays and its
               target (the mean taken over the rest)
fit.altered    each step's loss reported a hundredth high
"""

from __future__ import annotations

import torch

from .program import Program


def _patch(name: str, make):
    old = getattr(Program, name)
    setattr(Program, name, make(old))
    return lambda: setattr(Program, name, old)


def _stale_frame(render):
    first = {}

    def wrapped(self, scene, camera):
        if "image" not in first:
            first["image"] = render(self, scene, camera).clone()
        return first["image"]
    return wrapped


def _half_frame(render):
    def wrapped(self, scene, camera):
        out = render(self, scene, camera).clone()
        out.view(-1, 3)[::2] = 0.0
        return out
    return wrapped


def _altered_frame(render):
    def wrapped(self, scene, camera):
        out = render(self, scene, camera).clone()
        out[..., 2] *= 0.9
        return out
    return wrapped


def _stale_step(train_step):
    def wrapped(self, optimizer):
        def step(params, scene, o, d, target):
            with torch.no_grad():
                img = self.colors(self.with_params(scene, params), o, d)
                return torch.mean((img - target) ** 2)
        return step
    return wrapped


def _half_step(train_step):
    def wrapped(self, optimizer):
        step = train_step(self, optimizer)

        def half(params, scene, o, d, target):
            n = o.shape[0] // 2
            return step(params, scene, o[:n], d[:n], target[:n])
        return half
    return wrapped


def _altered_step(train_step):
    def wrapped(self, optimizer):
        step = train_step(self, optimizer)
        return lambda *args: step(*args) * 1.01
    return wrapped


FAULTS = {
    "frames.stale": ("render", _stale_frame),
    "frames.half": ("render", _half_frame),
    "frames.altered": ("render", _altered_frame),
    "fit.stale": ("train_step", _stale_step),
    "fit.half": ("train_step", _half_step),
    "fit.altered": ("train_step", _altered_step),
}


def plant(name: str):
    """Plant fault `name`; returns the function that removes it."""
    return _patch(*FAULTS[name])
