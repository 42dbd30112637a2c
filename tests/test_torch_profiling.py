"""The program's span recorder (rtc_tpu_torch/utils/profiling.py): off, a
span is one shared no-op that opens no record_function and records
nothing; on, spans nest with their parents' indices in a bounded record,
totals() gives each name's count, seconds and self seconds, and a running
torch profiler turns recording on and holds each span as a
record_function; idle_gaps names each stretch without device work by the
innermost span at its midpoint. The spans of render() and the gradient
calls on the stand-in graph are in tests/test_torch_compiled.py and
tests/test_torch_compiled_grad.py; on the card, tests/test_torch_cuda.py."""

import types

import pytest
import torch
from torch.autograd import DeviceType

from rtc_tpu_torch.utils import profiling


@pytest.fixture
def record():
    """An empty record before and after, recording off after."""
    profiling.take_spans()
    yield
    profiling.set_recording(False)
    profiling.take_spans()


def _raise(*a, **k):
    raise AssertionError("record_function called with recording off")


def test_off_span_is_one_no_op_without_record_function(record, monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    assert profiling.span("rtc.a") is profiling.span("rtc.b")
    with profiling.span("rtc.a"), profiling.span("rtc.b"):
        pass


def test_off_span_records_nothing(record):
    with profiling.span("rtc.a"):
        with profiling.span("rtc.b"):
            pass
    assert profiling.take_spans() == ([], 0)


def _clock(monkeypatch, ticks):
    it = iter(ticks)
    monkeypatch.setattr(profiling, "_now", lambda: next(it))


def test_on_spans_nest_and_totals_give_self_seconds(record, monkeypatch):
    """a (0-100) holds b (10-40) and c (50-70), c holds b (55-60)."""
    _clock(monkeypatch, [0, 10, 40, 50, 55, 60, 70, 100])
    assert profiling.set_recording(True) is False
    with profiling.span("a"):
        with profiling.span("b"):
            pass
        with profiling.span("c"):
            with profiling.span("b"):
                pass
    assert profiling.set_recording(False) is True
    spans, dropped = profiling.take_spans()
    assert dropped == 0
    assert [(s.name, s.start_ns, s.end_ns, s.parent) for s in spans] == [
        ("a", 0, 100, -1), ("b", 10, 40, 0), ("c", 50, 70, 0), ("b", 55, 60, 2)]
    t = profiling.totals(spans)
    assert t["a"] == (1, 100e-9, 50e-9)
    assert t["b"] == (2, 35e-9, 35e-9)
    assert t["c"] == (1, 20e-9, 15e-9)
    assert profiling.take_spans() == ([], 0)


def test_the_record_is_bounded_and_counts_what_it_drops(record, monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_LIMIT", 3)
    profiling.set_recording(True)
    for _ in range(2):
        with profiling.span("root"):
            with profiling.span("child"):
                pass
    spans, dropped = profiling.take_spans()
    assert [s.name for s in spans] == ["root", "child", "root"] and dropped == 1
    with profiling.span("root"):
        with pytest.raises(RuntimeError, match="open span"):
            profiling.take_spans()
    assert len(profiling.take_spans().spans) == 1


def test_a_running_profiler_records_spans_as_record_functions(record):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.span("rtc.outer"):
            with profiling.span("rtc.inner"):
                torch.zeros(4).add_(1)
    with profiling.span("rtc.after"):  # the profiler stopped: recording is off
        pass
    spans = profiling.take_spans().spans
    assert [(s.name, s.parent) for s in spans] == [("rtc.outer", -1), ("rtc.inner", 0)]
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CPU]
    assert "rtc.outer" in names and "rtc.inner" in names and "rtc.after" not in names


def _ev(name, a, b, device, annotation=False):
    return types.SimpleNamespace(name=name, device_type=device, is_user_annotation=annotation,
                                 time_range=types.SimpleNamespace(start=a, end=b))


def test_idle_gaps_by_the_innermost_span():
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [_ev("rtc.render", 0, 100, cpu, True), _ev("rtc.graph.lookup", 5, 30, cpu, True),
              _ev("rtc.graph.replay", 40, 90, cpu, True),
              _ev("rtc.render", 0, 100, cuda, True),  # the span's device side: no operation
              _ev("Memcpy HtoD", 30, 35, cuda), _ev("kernel", 80, 95, cuda),
              _ev("aten::add", 50, 60, cpu)]
    assert [e.name for e in profiling.device_ops(events)] == ["Memcpy HtoD", "kernel"]
    gaps = profiling.idle_gaps(events)
    assert [(g[0], g[1]) for g in gaps] == [(45e-6, "rtc.graph.replay"),
                                           (30e-6, "rtc.graph.lookup"), (5e-6, "rtc.render")]
    assert [g[1] for g in profiling.idle_gaps(events, 90, 120)] == [None]
    assert profiling.idle_gaps([_ev("kernel", 0, 5, cuda)]) == []
