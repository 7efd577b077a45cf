"""Frozen statistics of the benchmark: the nearest-rank percentile."""

from __future__ import annotations

import math
from typing import Optional, Sequence


def nearest_rank(values: Sequence[float], p: float) -> Optional[float]:
    """The nearest-rank ``p`` quantile (0 < p <= 1) of ``values``: the
    smallest value with at least ``p`` of the sample at or below it.
    ``None`` on an empty sample."""
    if not values:
        return None
    vals = sorted(values)
    k = min(len(vals) - 1, max(0, math.ceil(p * len(vals)) - 1))
    return vals[k]

