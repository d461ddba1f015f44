"""The window's arithmetic: rates over the whole window, tails over every
request, unions of device intervals."""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple


def rate(items: int, seconds: float) -> float:
    """Items per second over the whole window."""
    return items / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0 < q <= 100) of every value, nearest
    rank: the smallest value with at least q% of the values at or under
    it."""
    vals = sorted(values)
    if not vals:
        raise ValueError("no values")
    k = max(math.ceil(q / 100.0 * len(vals)), 1)
    return vals[k - 1]


def union_length(spans: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by ``(start, end)`` intervals."""
    total, lo, hi = 0.0, None, None
    for s, e in sorted(spans):
        if hi is None or s > hi:
            if hi is not None:
                total += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    return total if hi is None else total + hi - lo


def union(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The disjoint intervals that ``spans`` cover, in order."""
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]

