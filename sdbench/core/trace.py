"""The device trace of a window, from `torch.profiler`, on the host clock.

The profiler stamps its events on its own clock. Just after it starts,
the benchmark opens a user annotation and reads `time.perf_counter()`
inside it; the annotation's start in the trace and that reading give the
offset, so device activity can be set against the benchmark's spans
(microseconds of error against spans of milliseconds).

Device activity is every event the profiler puts on the card (kernels,
copies, fills), user annotations excepted.
"""

from __future__ import annotations

import bisect
import collections
import time
from dataclasses import dataclass, field
from typing import Any

MARKER = "sdbench.clock"
#: device operation names are cut to this many characters in a breakdown
NAME_CHARS = 160


def merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Union of intervals, sorted and disjoint."""
    out: list[tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def overlap(xs: list[tuple[float, float]], ys: list[tuple[float, float]]) -> float:
    """Total length of the intersection of two sorted disjoint lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


@dataclass
class DeviceEvent:
    name: str
    start: float  # perf_counter seconds
    end: float


@dataclass
class TraceSummary:
    """Device activity of a window, on the host clock."""

    window: tuple[float, float]
    events: list[DeviceEvent] = field(default_factory=list)

    def __post_init__(self) -> None:
        w0, w1 = self.window
        self.busy = merge([(max(e.start, w0), min(e.end, w1)) for e in self.events
                           if e.end > w0 and e.start < w1])

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    def busy_within(self, spans: list[tuple[float, float]]) -> float:
        """Seconds of device activity inside `spans`."""
        return overlap(self.busy, merge(spans))

    def device_ops(self, top: int = 10) -> list[list[Any]]:
        """[[name, seconds], ...]: the device operations that took most time."""
        by_name: collections.Counter[str] = collections.Counter()
        w0, w1 = self.window
        for e in self.events:
            a, b = max(e.start, w0), min(e.end, w1)
            if b > a:
                by_name[e.name[:NAME_CHARS]] += b - a
        return [[n, s] for n, s in by_name.most_common(top)]

    def idle_gaps(self, layers: list[tuple[str, list[tuple[float, float]]]],
                  top: int = 10) -> list[list[Any]]:
        """[[what the host was doing, idle seconds], ...]: the window's idle
        time on the card, by the first of `layers` (innermost first) whose
        spans hold each gap's middle; "other" where none does."""
        w0, w1 = self.window
        gaps = []
        t = w0
        for a, b in self.busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if w1 > t:
            gaps.append((t, w1))
        sorted_layers = [(name, sorted(spans)) for name, spans in layers]
        starts = [[s[0] for s in spans] for _n, spans in sorted_layers]
        by_layer: collections.Counter[str] = collections.Counter()
        for a, b in gaps:
            mid = (a + b) / 2
            label = "other"
            for (name, spans), st in zip(sorted_layers, starts):
                k = bisect.bisect_right(st, mid) - 1
                if k >= 0 and spans[k][1] >= mid:
                    label = name
                    break
            by_layer[label] += b - a
        return [[n, s] for n, s in by_layer.most_common(top)]


class DeviceTrace:
    """`with DeviceTrace(cuda) as tr: ...`, then `tr.summary(window)`."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self._prof: Any = None
        self._mark_pc: float | None = None

    def __enter__(self) -> "DeviceTrace":
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self._prof = profile(activities=acts, record_shapes=False, with_stack=False,
                             profile_memory=False)
        self._prof.__enter__()
        with record_function(MARKER):
            self._mark_pc = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize()
        self._prof.__exit__(*exc)

    def summary(self, window: tuple[float, float]) -> TraceSummary:
        raw = self._prof.profiler.kineto_results.events()
        offset = None
        for e in raw:
            if e.name() == MARKER:
                offset = e.start_ns() - round(self._mark_pc * 1e9)
                break
        if offset is None:
            raise RuntimeError("the clock marker is missing from the device trace")
        events = []
        for e in raw:
            if e.device_type().name != "CUDA" or e.is_user_annotation():
                continue
            start_ns = e.start_ns() - offset
            events.append(DeviceEvent(e.name(), start_ns * 1e-9,
                                      (start_ns + e.duration_ns()) * 1e-9))
        return TraceSummary(window, events)
