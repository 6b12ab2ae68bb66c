"""The arithmetic of the end-to-end metrics."""

from __future__ import annotations

import statistics


def rate(work: float, seconds: float) -> float:
    """All the work of a window over all of its time."""
    return work / seconds


def percentile(values, q: int) -> float:
    """The ``q``-th percentile of ``values`` (linear between the order
    statistics: ``statistics.quantiles(..., method='inclusive')``)."""
    values = list(values)
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]
