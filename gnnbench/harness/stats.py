"""The arithmetic of the metrics: intervals, their union and gaps, a
percentile over every sample, a rate over a window. Pure functions, with
no torch, so that the CPU tests check them alone.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

__all__ = ["merge", "union_length", "gaps", "percentile", "rate"]

Interval = Tuple[float, float]


def merge(intervals: Sequence[Interval]) -> List[Interval]:
    """The union of [start, end) intervals as disjoint sorted intervals."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def union_length(intervals: Sequence[Interval], lo: float = -math.inf,
                 hi: float = math.inf) -> float:
    """Length of the union of the intervals, clipped to [lo, hi)."""
    total = 0.0
    for s, e in merge(intervals):
        s, e = max(s, lo), min(e, hi)
        if e > s:
            total += e - s
    return total


def gaps(intervals: Sequence[Interval], lo: float, hi: float) -> List[Interval]:
    """The parts of [lo, hi) that no interval covers."""
    out: List[Interval] = []
    t = lo
    for s, e in merge(intervals):
        if e <= lo:
            continue
        if s >= hi:
            break
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
    if t < hi:
        out.append((t, hi))
    return out


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) over every value, linearly interpolated
    between the closest ranks (numpy's default)."""
    if not values:
        raise ValueError("percentile of no values")
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def rate(count: int, seconds: float) -> float:
    """Events per second over a window."""
    if seconds <= 0:
        raise ValueError("a rate needs a window longer than 0")
    return count / seconds

