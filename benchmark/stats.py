"""The window's arithmetic: a rate over all the work and all the time, and a
percentile of every sample."""

from __future__ import annotations

import statistics


def rate(work: float, seconds: float) -> float:
    """All the work done in the window over the window's seconds."""
    return work / seconds


def percentile(values, q: int) -> float:
    """The q-th percentile (1 <= q <= 99) of every value, interpolated
    between order statistics (`statistics.quantiles`, inclusive method)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


def spread(values) -> float:
    """The distance between the first and the third quartile over the
    median (`statistics.quantiles`, exclusive method)."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
