"""The yardstick's arithmetic: rates, percentiles, spreads, intervals.

Every number the benchmark reports is computed here or in roofline.py,
from counts, host-clock times and the profiler's intervals.
"""

from __future__ import annotations

import math
import statistics


def streams(lane_ticks: int, seconds: float, tick_hz: float) -> float:
    """Real-time streams: lane-ticks completed a second over the ticks a
    stream needs a second."""
    return lane_ticks / seconds / tick_hz


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of all values, linear between the
    two nearest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    r = (len(v) - 1) * q / 100.0
    lo = math.floor(r)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (r - lo)


def spread(values) -> float:
    """Distance between the first and third quartile as a share of the
    median (statistics.quantiles(n=4))."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def merge(intervals) -> list:
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted((iv[0], iv[1]) for iv in intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def clip(intervals, window) -> list:
    """The parts of the intervals inside window = (start, end)."""
    a, b = window
    return [(max(s, a), min(e, b)) for s, e in intervals
            if min(e, b) > max(s, a)]


def busy_s(intervals, window) -> float:
    """Seconds of the window covered by at least one interval."""
    return sum(e - s for s, e in merge(clip(intervals, window)))


def idle_pct(intervals, window) -> float:
    """100 x (1 - busy / window length)."""
    return 100.0 * (1.0 - busy_s(intervals, window) / (window[1] - window[0]))


def gaps(intervals, window) -> list:
    """The idle (start, end) gaps of the window between busy intervals,
    longest first."""
    a, b = window
    out, t = [], a
    for s, e in merge(clip(intervals, window)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if b > t:
        out.append((t, b))
    return sorted(out, key=lambda g: g[0] - g[1])


def label(gap, spans, default: str = "none") -> str:
    """The innermost host span open at the gap's midpoint."""
    mid = 0.5 * (gap[0] + gap[1])
    inside = [(e - s, name) for s, e, name in spans if s <= mid <= e]
    return min(inside)[1] if inside else default
