"""Profiling hooks and throughput meters.

Counterpart of ``video_moment_localization_tpu/utils/profiling.py``: a
``torch.profiler`` trace context (a Chrome trace, viewable in Perfetto or
chrome://tracing) and a step timer reporting the north-star metric, query-video
pairs processed per second.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace_context(profile_dir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the host and, where there is a
    card, the device into ``profile_dir/trace.json`` when set."""
    if not profile_dir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


class StepTimer:
    """Accumulates step wall time and sample counts -> throughput."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._samples = 0
        self._elapsed = 0.0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, num_samples: int) -> None:
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() without start()")
        self._elapsed += time.perf_counter() - self._t0
        self._samples += num_samples
        self._t0 = None

    @property
    def seconds(self) -> float:
        return self._elapsed

    @property
    def samples(self) -> int:
        return self._samples

    @property
    def throughput(self) -> float:
        """Samples (query-video pairs) per second."""
        return self._samples / self._elapsed if self._elapsed > 0 else 0.0
