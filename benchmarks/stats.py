"""The arithmetic of the end-to-end metrics and of the bounds' spreads.

Every statistic is taken over all the work of the window: a rate is all
scans over all the time, a percentile is over every scan, never a median
of pieces or a best of repeats."""

from __future__ import annotations

import statistics


def rate(n_done: int, seconds: float) -> float:
    """Work completed per second over the whole window."""
    if seconds <= 0.0:
        raise ValueError("rate: the window has no length")
    return n_done / seconds


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) of every value, interpolated
    between order statistics (``statistics.quantiles``, inclusive)."""
    vals = sorted(float(v) for v in values)
    if not vals:
        raise ValueError("percentile: no values")
    if len(vals) == 1:
        return vals[0]
    cuts = statistics.quantiles(vals, n=100, method="inclusive")
    lo = int(q) - 1
    frac = q - int(q)
    if frac == 0.0:
        return cuts[lo]
    return cuts[lo] + frac * (cuts[lo + 1] - cuts[lo])


def spread(values) -> float:
    """The distance between the first and the third quartile as a share of
    the median (``statistics.quantiles(values, n=4)``), as the bounds are
    set."""
    q1, med, q3 = statistics.quantiles([float(v) for v in values], n=4)
    return (q3 - q1) / med


def union_length(intervals) -> int:
    """Total length covered by (start, end) intervals (any order, may
    overlap)."""
    total = 0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, start: int, end: int) -> list:
    """The (start, end) stretches of [start, end] that no interval covers,
    in time order."""
    out = []
    t = start
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(a, b) for a, b in out if b > a]
