"""Statistics the metrics are computed with."""

from __future__ import annotations

import math
import statistics
from typing import Iterable, Optional, Sequence


def percentile(values: Sequence[float], p: float) -> Optional[float]:
    """Linear-interpolated percentile (numpy's default rule); None for an
    empty sample."""
    xs = sorted(float(v) for v in values)
    if not xs:
        return None
    pos = (len(xs) - 1) * p / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartile as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med) if med else float("inf")


def merge_intervals(intervals: Iterable[tuple[float, float]]
                    ) -> list[tuple[float, float]]:
    """The union of [start, end) intervals, sorted and disjoint."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals: Iterable[tuple[float, float]], lo: float,
            hi: float) -> float:
    """Length of the union of ``intervals`` inside [lo, hi)."""
    total = 0.0
    for s, e in merge_intervals(intervals):
        s, e = max(s, lo), min(e, hi)
        if e > s:
            total += e - s
    return total


def gaps(intervals: Iterable[tuple[float, float]], lo: float,
         hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi) that no interval covers."""
    out, cur = [], lo
    for s, e in merge_intervals(intervals):
        if e <= lo:
            continue
        if s >= hi:
            break
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if cur < hi:
        out.append((cur, hi))
    return out
