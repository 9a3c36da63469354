"""What a traced slice of a run did on the card, from `torch.profiler`:
the device operations (kernels, copies, fills) and their union, the
program's `record_function` spans, the longest idle gaps named by what
the host was doing. Recording the host costs a training step of Hymba
~0.2 s of host time (~20k operations), which the device would read as
idle, so the slice runs twice: once with the device alone recorded (the
busy share, the operations), once with the host too (spans, gaps).

A copy of `chip_smoke.py`'s `device_profile` reading: the profiler marks
a span on the device as an event of the span's name from its first
kernel's start to its last kernel's end; those marks are left out of the
device operations, and a span's device time is the time of the
operations that start inside its marks.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

Interval = Tuple[float, float, str]        # start us, end us, name


@dataclass
class Trace:
    """Two slices of the same calls: ``window_s`` and ``ops`` from one
    that records the device alone (its host runs at full speed), and
    ``span_ops``, ``marks`` and ``host`` from one that records the host
    too (spans, what the host did in each gap)."""
    window_s: float
    ops: List[Interval]                     # device operations, by start
    span_ops: List[Interval]
    marks: Dict[str, List[Tuple[float, float]]]
    host: List[Interval]                    # host events, by start

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        total, end = 0.0, float("-inf")
        for s, e, _ in self.ops:
            if e > end:
                total += e - max(s, end)
                end = e
        return total / 1e6

    def gaps(self) -> List[Tuple[float, float]]:
        """Intervals between device operations of the host slice, in
        us."""
        out, end = [], None
        for s, e, _ in self.span_ops:
            if end is not None and s > end:
                out.append((end, s))
            end = e if end is None else max(end, e)
        return out

    def op_s(self, match: Callable[[str], bool]) -> float:
        """Device seconds of the operations whose name matches."""
        return sum(e - s for s, e, n in self.ops if match(n)) / 1e6

    def span_s(self, span: str) -> Optional[float]:
        """Device seconds under the program's span ``span``; None where
        the slice never entered it."""
        marks = self.marks.get(span)
        if not marks:
            return None
        starts = [s for s, _, _ in self.span_ops]
        total = 0.0
        for lo, hi in marks:
            for s, e, _ in self.span_ops[bisect.bisect_left(starts, lo):
                                         bisect.bisect_right(starts, hi)]:
                total += e - s
        return total / 1e6

    def top_ops(self, n: int = 10) -> List[list]:
        by = defaultdict(float)
        for s, e, name in self.ops:
            by[name] += (e - s) / 1e6
        return [[k[:160], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> List[list]:
        """The idle gaps' seconds summed by the innermost host event open
        at each gap's middle."""
        starts = [s for s, _, _ in self.host]
        by = defaultdict(float)
        for lo, hi in self.gaps():
            mid = (lo + hi) / 2
            name = "host: no profiled event"
            i = bisect.bisect_right(starts, mid) - 1
            for s, e, nm in reversed(self.host[max(0, i - 4000):i + 1]):
                if e > mid:
                    name = nm
                    break
            by[name] += (hi - lo) / 1e6
        return [[k[:160], v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _profiled(fn, activities):
    from torch.profiler import profile
    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t
    return prof.events(), window_s


def record(fn: Callable[[], None], spans: Tuple[str, ...]) -> Trace:
    """Run ``fn`` three times: under a profiler that is thrown away (its
    first start sets up the card's tracing, ~0.8 s of host time), under
    one that records the device alone, and under one that records the
    host too; the card synchronized around each."""
    from torch.profiler import ProfilerActivity
    cuda = torch.autograd.DeviceType.CUDA
    _profiled(lambda: torch.zeros(1, device="cuda").add_(1),
              [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    events, window_s = _profiled(fn, [ProfilerActivity.CUDA])
    ops = sorted((e.time_range.start, e.time_range.end, e.name)
                 for e in events if e.device_type == cuda
                 and e.name not in spans
                 and not getattr(e, "is_user_annotation", False))
    events, _ = _profiled(fn, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    annotations = set(spans)
    host, device = [], []
    for e in events:
        iv = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type == cuda:
            device.append((e, iv))
        else:
            host.append(iv)
            if getattr(e, "is_user_annotation", False):
                annotations.add(e.name)
    span_ops, marks = [], defaultdict(list)
    for e, iv in device:
        if e.name in annotations or getattr(e, "is_user_annotation", False):
            marks[e.name].append(iv[:2])
        else:
            span_ops.append(iv)
    span_ops.sort()
    host.sort()
    return Trace(window_s, ops, span_ops, dict(marks), host)
