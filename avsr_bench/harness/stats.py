"""Window statistics: rates over the whole window, tails over every call,
and the run-to-run spread the bounds are set from."""

from __future__ import annotations

import math
import statistics
from typing import Sequence


def rate(work: float, seconds: float) -> float:
    """Work completed over the time it took, e.g. speech seconds per wall second."""
    if seconds <= 0:
        raise ValueError("a rate needs a window longer than 0 s")
    return work / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of every value, by linear
    interpolation between the closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("a percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartiles as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / abs(med)
