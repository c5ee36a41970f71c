"""Percentiles over whole windows: every sample of a window pooled
together, never a median of per-request or per-client pieces."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float | None:
    """The q-th percentile (0-100) of all `values`, linearly interpolated
    between the closest ranks (numpy's default); None when empty."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
