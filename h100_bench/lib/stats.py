"""The arithmetic of the end-to-end and per-layer metrics."""

from __future__ import annotations

from typing import Optional


def share_of_peak(work: float, seconds: float, peak_per_s: float) -> float:
    """100 * work / (seconds * peak): a share of a peak, in %."""
    return 100.0 * work / (seconds * peak_per_s)


def roofline_share(least_time_s: float, busy_s: float) -> Optional[float]:
    """100 * the least time the chip could take / the time it was busy; None
    when nothing ran on the device."""
    if busy_s <= 0:
        return None
    return 100.0 * least_time_s / busy_s


def idle_share(busy_s: float, window_s: float) -> float:
    return 100.0 * (1.0 - busy_s / window_s)
