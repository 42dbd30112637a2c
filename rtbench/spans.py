"""The program's own spans over the traced part. rtc_tpu_torch records
its rtc.* spans (rtc_tpu_torch/utils/profiling.py) while a torch profiler
runs, so after a --trace 1 run its record holds the traced iterations'
spans, on the host clock (time.perf_counter_ns). A program without the
recorder gives None, and so does every reader of this module."""

from __future__ import annotations

_TAKEN: dict = {}


def record():
    """The program's spans of this run, taken from it once (the readers
    share them); None for a program without the recorder."""
    if "spans" not in _TAKEN:
        try:
            from rtc_tpu_torch.utils import profiling
        except ImportError:
            profiling = None
        take = getattr(profiling, "take_spans", None)
        _TAKEN["spans"] = None if take is None else take().spans
    return _TAKEN["spans"]


def replay_split_ms(spans, root: str):
    """(prep, launch): host ms a call of the root span named root that
    replayed a graph, before and around the replay (the root less its
    rtc.graph.replay and rtc.graph.output) and in rtc.graph.replay; None
    where no such call was recorded."""
    if not spans:
        return None
    roots = {i: [s.end_ns - s.start_ns, 0, 0] for i, s in enumerate(spans)
             if s.name == root and s.parent < 0}
    for s in spans:
        if s.parent in roots and s.name in ("rtc.graph.replay", "rtc.graph.output"):
            roots[s.parent][1 if s.name == "rtc.graph.replay" else 2] += s.end_ns - s.start_ns
    calls = [r for r in roots.values() if r[1] > 0]
    if not calls:
        return None
    prep = sum(total - replay - output for total, replay, output in calls)
    launch = sum(replay for _, replay, _ in calls)
    return prep / len(calls) / 1e6, launch / len(calls) / 1e6
