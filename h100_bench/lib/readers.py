"""The arithmetic the per-layer readers of ``h100_bench/metrics/`` share.

Each reader takes the window's `harness.Record` and returns its metric, or
None where the run has nothing to read (no trace, no device time, no span).
The idle share reads the union of all work on the device (``busy_s``); the
roofline and the step's device time read the kernels' union (``kernel_s``).
"""

from __future__ import annotations

from typing import Optional

from h100_bench.counts import flops as counts
from h100_bench.lib import stats


def mfu(record) -> Optional[float]:
    """The frozen count of the work completed in the window over the
    window's length times the chip's peak for the configuration's dtype, %."""
    if record.units <= 0 or record.window_s <= 0:
        return None
    return stats.share_of_peak(record.flops, record.window_s, counts.PEAK_FLOPS[record.dtype])


def kernel_roofline(record) -> Optional[float]:
    """The least time the chip could take for that work (the larger of its
    operations over the peak and its bytes over 3.35 TB/s) over the time
    some kernel ran on the device (copies and fills left out), %."""
    if not record.kernel_s or record.units <= 0:
        return None
    least, _ = counts.least_time_s(record.flops, record.nbytes, record.dtype)
    return stats.roofline_share(least, record.kernel_s)


def device_idle(record) -> Optional[float]:
    """The share of the window in which no work (kernel, copy or fill) ran
    on the device, %."""
    if not record.busy_s or record.window_s <= 0:
        return None
    return stats.idle_share(record.busy_s, record.window_s)


def span_ms_per_call(record, name: str) -> Optional[float]:
    """The benchmark's spans named ``name``: their total over their count, ms."""
    spans = [b - a for n, a, b in record.spans if n == name]
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)


def device_ms_per_step(record) -> Optional[float]:
    """The time some kernel ran on the device over the steps completed, ms."""
    if not record.kernel_s or record.steps <= 0:
        return None
    return 1e3 * record.kernel_s / record.steps
