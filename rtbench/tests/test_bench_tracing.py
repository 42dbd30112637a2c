"""The rule that tells the program's kernels from the rest of a trace,
and the reduction of a traced part."""

import types

import torch
from torch.autograd import DeviceType

from rtbench import tracing

NAMES = {"closest_hit_kernel", "elementwise_kernel"}


def test_kernel_rule():
    assert tracing.is_kernel("void (anonymous namespace)::closest_hit_kernel<0, false>(float "
                             "const*, int)", NAMES)
    assert tracing.is_kernel("_ZN12_GLOBAL__N_118closest_hit_kernelILi0ELb0EEEvPKf", NAMES)
    assert tracing.is_kernel("elementwise_kernel", NAMES)  # a Triton kernel's bare name
    assert not tracing.is_kernel("void at::native::elementwise_kernel<128, 2>(int)", NAMES)
    assert not tracing.is_kernel("Memcpy DtoH (Device -> Pinned)", NAMES)


def test_the_port_has_kernels_by_the_rule():
    import os
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    names = tracing.kernel_names(root, "rtc_tpu_torch")
    assert {"closest_shadow_kernel", "closest_hit_kernel", "any_hit_kernel",
            "crossing_count_kernel"} <= names


def _ev(name, a, b, device):
    return types.SimpleNamespace(name=name, device_type=device,
                                 time_range=types.SimpleNamespace(start=a, end=b))


def test_summary_busy_idle_and_gaps():
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [_ev("render", 0, 100, cpu), _ev("readback", 100, 200, cpu),
              _ev("render", 200, 300, cpu), _ev("readback", 300, 400, cpu),
              _ev("void (anonymous namespace)::closest_hit_kernel<0>(int)", 10, 60, cuda),
              _ev("void at::native::elementwise_kernel<4>(int)", 50, 90, cuda),
              _ev("Memcpy DtoH (Device -> Pinned)", 150, 180, cuda),
              _ev("void (anonymous namespace)::closest_hit_kernel<0>(int)", 210, 260, cuda)]
    s = tracing.summarize(events, NAMES, 2)
    assert abs(s.window_s - 400e-6) < 1e-12
    assert abs(s.busy_s - (80 + 30 + 50) * 1e-6) < 1e-12  # 10-90 merged, 150-180, 210-260
    assert abs(s.kernel_s - 100e-6) < 1e-12
    assert abs(s.device_s - 170e-6) < 1e-12
    assert s.idle_gaps[0] == ["readback", 140e-6]  # 260-400 lies in the second readback
    # 0-10 in the first render; 90-150 and 180-210 in the first readback
    assert [g[0] for g in s.idle_gaps] == ["readback", "readback", "readback", "render"]
    assert s.device_ops[0][1] == 100e-6


def test_tracer_off_records_nothing():
    t = tracing.Tracer(False, 0, 2, NAMES)
    for i in range(4):
        t.at(i)
        with t.span("render"):
            torch.zeros(1)
    t.stop(4)
    assert t.summary is None
