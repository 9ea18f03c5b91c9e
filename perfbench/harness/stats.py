"""The benchmark's arithmetic on what a run recorded: rates, percentiles,
the union of device activity and its gaps."""

from __future__ import annotations

import statistics


def rate(work: float, seconds: float) -> float:
    """Work per second over the whole window."""
    if seconds <= 0:
        raise ValueError("an empty window")
    return work / seconds


def p90(values) -> float:
    """The 90th percentile of all values (``statistics.quantiles``, n = 10,
    its default exclusive method); needs at least 2 values."""
    vals = list(values)
    if len(vals) < 2:
        raise ValueError(f"a 90th percentile of {len(vals)} values")
    return statistics.quantiles(vals, n=10)[8]


def union_length(intervals) -> float:
    """Total length covered by ``(start, end)`` intervals."""
    total, reach = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > reach:
            total += b - max(a, reach)
            reach = b
    return total


def gaps(intervals, lo: float, hi: float) -> list:
    """The uncovered stretches ``(start, end)`` of [lo, hi]."""
    out, reach = [], lo
    for a, b in sorted(intervals):
        if a > reach:
            out.append((reach, min(a, hi)))
        reach = max(reach, b)
        if reach >= hi:
            break
    if reach < hi:
        out.append((reach, hi))
    return [(a, b) for a, b in out if b > a]


def idle_share(busy: float, window: float) -> float:
    """The share of the window in which the device ran nothing."""
    return 1.0 - busy / window
