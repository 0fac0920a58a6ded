"""The end-to-end metrics from the window's step records."""
from __future__ import annotations

import math
from typing import Sequence


def cells_per_s(cells: Sequence[int], window_s: float) -> float:
    """Cells of all levels times steps completed in the window, over the
    host seconds from the window's start to the synchronize that ends its
    last step: all the work over all the time."""
    return sum(cells) / window_s


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile, linear between the closest ranks (numpy's
    default)."""
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def step_ms_p90(step_s: Sequence[float]) -> float:
    """The 90th percentile of every step's wall time in the window, ms."""
    return percentile(step_s, 90.0) * 1e3
