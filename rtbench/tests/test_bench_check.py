"""The check decides `correct` against the reference: a sound run
passes, and the control (the reference in float32 with TF32 products,
put in the program's place) and each planted fault (faults.py) fail,
driven through the rest of a run on the CPU at a small canvas."""

import os
import time

import pytest

from rtbench import faults, harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _correct(workload, seed, control=False, width=32):
    ctx = harness.context(ROOT, workload, seed, 0.5, False, time.perf_counter(), width)
    return harness.run(ctx, control=control)


@pytest.mark.parametrize("workload", ["cow.orbit", "glass_teapot.orbit", "cow.fit",
                                      "glass_teapot.fit"])
def test_sound_passes_and_control_fails(workload):
    assert _correct(workload, 2_100_000_001)["correct"] is True
    result = _correct(workload, 2_100_000_002, control=True)
    assert result["correct"] is False, result["compared"]


@pytest.mark.parametrize("workload, fault", [
    ("cow.orbit", "frames.stale"), ("cow.orbit", "frames.half"),
    ("glass_teapot.orbit", "frames.altered"),
    ("cow.fit", "fit.stale"), ("cow.fit", "fit.half"), ("cow.fit", "fit.altered")])
def test_planted_faults_fail(workload, fault):
    undo = faults.plant(fault)
    try:
        result = _correct(workload, 2_100_000_003, width=48)
    finally:
        undo()
    assert result["correct"] is False, result["compared"]
