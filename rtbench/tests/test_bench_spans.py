"""The program's spans in a traced part: its rtc.* annotations move none
of the reduction's device numbers or its window, and the readers of
prep_ms and launch_ms split each replayed call's host time by them, or
read nothing from a program without the recorder."""

import os
import types

import pytest
from torch.autograd import DeviceType

from rtbench import harness, spans, tracing

NAMES = {"closest_hit_kernel"}
METRICS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "metrics")


def _ev(name, a, b, device, annotation=False):
    return types.SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                                 time_range=types.SimpleNamespace(start=a, end=b))


def _harness_events():
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    return [_ev("render", 0, 100, cpu, True), _ev("readback", 100, 200, cpu, True),
            _ev("render", 200, 300, cpu, True), _ev("readback", 300, 400, cpu, True),
            _ev("void (anonymous namespace)::closest_hit_kernel<0>(int)", 10, 60, cuda),
            _ev("void at::native::elementwise_kernel<4>(int)", 50, 90, cuda),
            _ev("Memcpy DtoH (Device -> Pinned)", 150, 180, cuda),
            _ev("void (anonymous namespace)::closest_hit_kernel<0>(int)", 210, 260, cuda)]


def _program_events():
    """rtc.* spans on the host, one reaching past the window, and their
    device sides, user annotations over their whole range."""
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    out = []
    for a, b, name in ((2, 95, "rtc.render"), (3, 8, "rtc.graph.lookup"),
                       (9, 20, "rtc.graph.replay"), (202, 295, "rtc.render"),
                       (290, 450, "rtc.train_step"), (-50, 10, "rtc.render")):
        out += [_ev(name, a, b, cpu, True), _ev(name, a, b, cuda, True)]
    return out


def test_program_spans_move_no_device_number_nor_the_window():
    without = tracing.summarize(_harness_events(), NAMES, 2)
    with_spans = tracing.summarize(_harness_events() + _program_events(), NAMES, 2)
    assert with_spans == without
    assert (without.window_s, without.busy_s, without.kernel_s, without.device_s) == (
        400e-6, 160e-6, 100e-6, 170e-6)


def _span(name, a, b, parent):
    return types.SimpleNamespace(name=name, start_ns=a, end_ns=b, parent=parent)


FRAMES = [_span("rtc.render", 0, 1_000_000, -1), _span("rtc.camera", 10, 100_000, 0),
          _span("rtc.graph.replay", 200_000, 700_000, 0),
          _span("rtc.graph.output", 700_000, 800_000, 0),
          _span("rtc.render", 2_000_000, 4_000_000, -1),
          _span("rtc.graph.replay", 2_500_000, 3_000_000, 4),
          _span("rtc.graph.output", 3_000_000, 3_600_000, 4),
          _span("rtc.train_step", 5_000_000, 6_000_000, -1)]


def test_replay_split_by_the_spans():
    # prep: (1.0 - 0.5 - 0.1) and (2.0 - 0.5 - 0.6) ms; launch: 0.5 ms each
    prep, launch = spans.replay_split_ms(FRAMES, "rtc.render")
    assert prep == pytest.approx(0.65) and launch == pytest.approx(0.5)
    assert spans.replay_split_ms(FRAMES, "rtc.train_step") is None  # no replay
    assert spans.replay_split_ms([], "rtc.render") is None
    assert spans.replay_split_ms(None, "rtc.render") is None


def _read(name):
    mod = harness.load_module(os.path.join(METRICS, name + ".py"), "t_" + name.replace(".", "_"))
    return mod.read(None)


def test_readers_read_the_programs_record(monkeypatch):
    monkeypatch.setattr(spans, "_TAKEN", {"spans": FRAMES})
    assert _read("prep_ms.frame") == pytest.approx(0.65)
    assert _read("launch_ms.frame") == pytest.approx(0.5)
    assert _read("prep_ms.fit") is None and _read("launch_ms.fit") is None


def test_a_program_without_the_recorder_reads_nothing(monkeypatch):
    from rtc_tpu_torch.utils import profiling

    monkeypatch.setattr(spans, "_TAKEN", {})
    monkeypatch.delattr(profiling, "take_spans")
    assert spans.record() is None
    for name in ("prep_ms.frame", "launch_ms.frame", "prep_ms.fit", "launch_ms.fit"):
        assert _read(name) is None


def test_the_record_is_taken_once_from_the_program(monkeypatch):
    from rtc_tpu_torch.utils import profiling

    monkeypatch.setattr(spans, "_TAKEN", {})
    profiling.take_spans()
    profiling.set_recording(True)
    try:
        with profiling.span("rtc.render"):
            with profiling.span("rtc.graph.replay"):
                pass
    finally:
        profiling.set_recording(False)
    got = spans.record()
    assert [(s.name, s.parent) for s in got] == [("rtc.render", -1), ("rtc.graph.replay", 0)]
    assert spans.record() is got and profiling.take_spans().spans == []
    assert spans.replay_split_ms(got, "rtc.render")[1] > 0
