"""Spans around the calls into each layer, the device trace, and their reduction.

The benchmark records its own spans, from its own files, around each call
it makes into a layer of the program (featurize and dispatch, collect,
submit, wait, step, synchronize). Untraced runs keep them on the host's
clock alone. A traced run (``--trace 1``) also runs ``torch.profiler``
over the window and opens each span as a ``record_function`` range, so
that spans and kernels share the profiler's clock. Two unions are read from
the trace: the device's busy time, the union of the intervals of all work
that ran on it (kernels, copies and fills), which the idle share and each
idle gap (named by the span the host was in) read; and the kernels' time,
the union of the kernel launches alone, which the roofline and the step's
device time read, so that how the host stages its copies does not move them.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

SPAN_PREFIX = "bench/"


def union_length(intervals: Sequence[Tuple[float, float]]) -> float:
    """The time that the union of (start, end) intervals covers."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted(intervals):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def merged(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for start, stop in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], stop)
        else:
            out.append([start, stop])
    return [(a, b) for a, b in out]


def idle_gaps(busy: Sequence[Tuple[float, float]], lo: float, hi: float
              ) -> List[Tuple[float, float]]:
    """The gaps of [lo, hi] that no busy interval covers."""
    gaps, cur = [], lo
    for start, stop in merged(busy):
        if start > cur:
            gaps.append((cur, min(start, hi)))
        cur = max(cur, stop)
    if cur < hi:
        gaps.append((cur, hi))
    return [(a, b) for a, b in gaps if b > a]


def span_at(spans: Sequence[Tuple[str, float, float]], t: float) -> str:
    """The innermost span (latest started) that holds time t, or "none"."""
    best, best_start = "none", float("-inf")
    for name, start, stop in spans:
        if start <= t <= stop and start > best_start:
            best, best_start = name, start
    return best


def _annotation(event) -> bool:
    """Whether a device event is a user annotation (a span mirrored on the
    device's timeline, such as ``Optimizer.step``'s): it covers the gaps
    between the kernels inside it, which have events of their own."""
    flag = getattr(event, "is_user_annotation", None)
    if flag is not None and flag():
        return True
    name = event.name()
    return name.startswith(SPAN_PREFIX) or name.startswith("Optimizer.")


def is_copy(name: str) -> bool:
    """Whether a device event is a copy or a fill (``Memcpy HtoD (Pinned ->
    Device)``, ``Memset (Device)``), not a kernel."""
    return name.startswith("Memcpy") or name.startswith("Memset")


class Tracer:
    """Spans on the host's clock, and with ``device`` the profiler's trace."""

    def __init__(self, device: bool):
        self.device = device
        self._lock = threading.Lock()
        self.spans: List[Tuple[str, float, float]] = []
        self._prof = None
        self.device_intervals: Optional[List[Tuple[float, float]]] = None
        self.kernel_intervals: Optional[List[Tuple[float, float]]] = None
        self.device_ops: List[Tuple[str, float]] = []
        self.trace_spans: List[Tuple[str, float, float]] = []
        self.trace_range: Tuple[float, float] = (0.0, 0.0)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self._prof is not None:
            import torch

            with torch.profiler.record_function(SPAN_PREFIX + name):
                yield
        else:
            yield
        t1 = time.perf_counter()
        with self._lock:
            self.spans.append((name, t0, t1))

    @contextlib.contextmanager
    def window(self):
        """Profile the window when tracing the device; on exit the kernel
        intervals, device ops and spans are read from the trace."""
        if not self.device:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity

        prof = torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
        self._prof = prof
        try:
            yield
        finally:
            self._prof = None
            prof.__exit__(None, None, None)
            self._read(prof)

    def _read(self, prof) -> None:
        """Device and kernel intervals (s), device time by op name, and the
        spans from the raw trace: work on the device that is no user
        annotation, and of it the kernels, which are no copy or fill."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        work, kernels, spans, by_name = [], [], [], defaultdict(float)
        lo, hi = float("inf"), float("-inf")
        for e in prof.profiler.kineto_results.events():
            start, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
            name = e.name()
            if e.device_type() == cuda:
                if dur <= 0 or _annotation(e):
                    continue
                work.append((start, start + dur))
                if not is_copy(name):
                    kernels.append((start, start + dur))
                by_name[name] += dur
            elif name.startswith(SPAN_PREFIX):
                spans.append((name[len(SPAN_PREFIX):], start, start + dur))
                lo, hi = min(lo, start), max(hi, start + dur)
        whole = [s for s in spans if s[0] == "window"]
        if whole:
            lo, hi = whole[0][1], whole[0][2]
        self.device_intervals = work
        self.kernel_intervals = kernels
        self.trace_spans = spans
        self.trace_range = (lo, hi) if spans else (0.0, 0.0)
        self.device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])

    def busy_s(self) -> Optional[float]:
        """The union of all work on the device (kernels, copies, fills), s."""
        if self.device_intervals is None:
            return None
        return union_length(self.device_intervals)

    def kernel_s(self) -> Optional[float]:
        """The union of the kernel launches alone, s."""
        if self.kernel_intervals is None:
            return None
        return union_length(self.kernel_intervals)

    def breakdown(self, top: int = 10) -> Dict[str, List]:
        """The device ops that took most time, and the longest idle gaps
        named by the span the host was in at each gap's middle."""
        lo, hi = self.trace_range
        gaps = sorted(idle_gaps(self.device_intervals or [], lo, hi),
                      key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, s] for n, s in self.device_ops[:top]],
                "idle_gaps": [[span_at(self.trace_spans, (a + b) / 2), b - a] for a, b in gaps]}
