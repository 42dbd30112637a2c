"""The traced part of a run: torch.profiler over a fixed run of frames or
steps inside the window, and what the per-layer readers take from it.

The device operations are the profiler's CUDA events (kernels, copies,
memsets, whether launched alone or from a CUDA graph's replay). The
window is the span of the benchmark's own host spans (`render`,
`readback`, `step`, `loss_read`) around the traced iterations, recorded
with record_function, so it is on the trace's clock. Busy time is the
union of the device operations' intervals inside it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import glob
import os
import re

import torch

SPANS = ("render", "readback", "step", "loss_read")


def kernel_names(root: str, package: str) -> set:
    """The program's hand-written kernels: every `__global__` function of
    a .cu or .cuh file under the package, and every `@triton.jit`
    function of its Python files."""
    names = set()
    cu = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                    r"(?:void\s+)?(\w+)\s*\(")
    tj = re.compile(r"@triton\.jit[^\n]*\n(?:@[^\n]*\n)*\s*def\s+(\w+)")
    base = os.path.join(root, package)
    for path in glob.glob(os.path.join(base, "**", "*.cu*"), recursive=True):
        with open(path) as f:
            names.update(cu.findall(f.read()))
    for path in glob.glob(os.path.join(base, "**", "*.py"), recursive=True):
        with open(path) as f:
            names.update(tj.findall(f.read()))
    return names


def is_kernel(event_name: str, names: set) -> bool:
    """Does a device operation's name (demangled or mangled) name one of
    the program's kernels: `[void ][(anonymous namespace)::]name<...>(...)`
    or `name(...)` demangled, `_Z[N12_GLOBAL__N_1]<len>name` mangled, or
    a Triton kernel's bare `name`. A library kernel of the same name in
    another namespace (at::native::elementwise_kernel) is not one."""
    m = re.match(r"(?:void )?(?:\(anonymous namespace\)::)?([A-Za-z_]\w*)(?:<|\(|$)",
                 event_name)
    if m and m.group(1) in names:
        return True
    m = re.match(r"_Z(?:N12_GLOBAL__N_1)?(\d+)", event_name)
    return bool(m) and event_name[m.end():m.end() + int(m.group(1))] in names


@dataclasses.dataclass
class Summary:
    """A traced part, reduced: seconds on the trace's clock."""
    iterations: int
    window_s: float
    busy_s: float            # union of the device operations' intervals
    kernel_s: float          # summed durations of the program's kernels
    device_s: float          # summed durations of every device operation
    device_ops: list         # [[name, seconds]] summed by name, the largest 10
    idle_gaps: list          # [[host span, seconds]] the longest 10


class Tracer:
    """Profiles iterations [skip, skip + iterations) of a loop when
    enabled; span() marks the benchmark's host spans there."""

    def __init__(self, enabled: bool, skip: int, iterations: int, names: set):
        self.enabled, self.skip, self.iterations, self.names = enabled, skip, iterations, names
        self.prof = None
        self.summary = None

    def warm(self) -> None:
        """Start and stop the profiler once, so that its first start (which
        loads CUPTI, seconds) falls in set-up and not in the window."""
        if self.enabled:
            self._profiler().start()
            torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)
            self.stop(self.skip)
            self.summary = None

    def done(self, i: int) -> bool:
        """Has the traced part ended before iteration i (or is there none)."""
        return not self.enabled or i >= self.skip + self.iterations

    def _profiler(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        return self.prof

    def span(self, name: str):
        return torch.profiler.record_function(name) if self.prof else contextlib.nullcontext()

    def at(self, i: int) -> None:
        """Call before iteration i of the loop."""
        if not self.enabled:
            return
        if i == self.skip:
            self._profiler().start()
        elif i == self.skip + self.iterations:
            self.stop(i)

    def stop(self, i: int) -> None:
        """End the traced part before iteration i (also where the window
        closed before its last traced iteration)."""
        if self.prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        self.summary = summarize(self.prof.events(), self.names, i - self.skip)
        self.prof = None


def summarize(events, names: set, iterations: int) -> Summary:
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.device_type == DeviceType.CPU and e.name in SPANS)
    # the spans' own device-side annotations are no device operation
    ops = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                 if e.device_type == DeviceType.CUDA and e.name not in SPANS
                 and not getattr(e, "is_user_annotation", False))
    if not spans:
        return Summary(iterations, 0.0, 0.0, 0.0, 0.0, [], [])
    w0, w1 = spans[0][0], max(s[1] for s in spans)
    merged = []
    for a, b, _ in ops:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    by_name = {}
    for a, b, n in ops:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
    gaps, t = [], w0
    for a, b in merged + [[w1, w1]]:
        if a > t:
            mid = (a + t) / 2
            host = next((n for s0, s1, n in spans if s0 <= mid < s1), "harness")
            gaps.append([host, (a - t) / 1e6])
        t = max(t, b)
    kernel = sum(b - a for a, b, n in ops if is_kernel(n, names)) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return Summary(iterations, (w1 - w0) / 1e6, sum(b - a for a, b in merged) / 1e6,
                   kernel, sum(b - a for a, b, _ in ops) / 1e6,
                   [[n[:160], s] for n, s in top],
                   sorted(gaps, key=lambda g: -g[1])[:10])
