"""The benchmark's arithmetic on records: percentiles, spreads, the window
rate and the union of busy intervals.  Python only, so the CPU tests can
hold it to hand-computed values."""

from __future__ import annotations

import bisect
import statistics
from typing import Iterable, List, Sequence, Tuple


def percentile(values: Sequence[float], q: int) -> float:
    """The q-th percentile (1 <= q <= 99) of ``values``, linear between
    order statistics (``statistics.quantiles``' "inclusive" method: the
    0th and 100th percentiles are the least and largest values)."""
    if not 1 <= q <= 99:
        raise ValueError(f"percentile {q} outside 1..99")
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartile as a share of the
    median, with ``statistics.quantiles(values, n=4)``'s quartiles."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def window_rate(window_s: float, completed: int) -> float:
    """Seconds per completed analysis: the window's whole wall over the
    analyses it completed."""
    if completed < 1:
        raise ValueError("no analysis completed in the window")
    return window_s / completed


def merge(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Disjoint, sorted union of (start, end) intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of the intervals: time in which at least one
    of them was running (a sum of their lengths counts overlaps twice)."""
    return sum(e - s for s, e in merge(intervals))


def inside(merged: Sequence[Tuple[float, float]],
           ranges: Iterable[Tuple[float, float]]) -> float:
    """Seconds of the merged busy intervals that lie inside the disjoint
    (start, end) ``ranges``."""
    starts = [s for s, _ in merged]
    total = 0.0
    for a, b in ranges:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        for s, e in merged[i:]:
            if s >= b:
                break
            total += max(0.0, min(e, b) - max(s, a))
    return total


def gaps(merged: Sequence[Tuple[float, float]], start: float,
         end: float) -> List[Tuple[float, float]]:
    """The idle stretches of [start, end] between merged busy intervals."""
    out = []
    t = start
    for s, e in merged:
        if s > t:
            out.append((t, min(s, end)))
        t = max(t, e)
        if t >= end:
            break
    if t < end:
        out.append((t, end))
    return [(s, e) for s, e in out if e > s]
