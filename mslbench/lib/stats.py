"""Order statistics of the harness's samples."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by the nearest rank: the smallest sample
    with at least q% of the samples at or below it (no interpolation, so a
    tail is a latency some request really had)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no samples")
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return float(xs[k - 1])


def median(values) -> float:
    return percentile(values, 50.0)
