"""Small statistics shared by the harness and its readers."""
from __future__ import annotations

from typing import Sequence


def percentile(samples: Sequence[float], p: float) -> float:
    """The p-th percentile (0..100) over all samples: the sample of rank
    round(p / 100 * (n - 1)) in sorted order (the rule of the port's
    ``obs`` histograms, here over every sample, not a reservoir)."""
    xs = sorted(samples)
    if not xs:
        raise ValueError("no samples")
    i = min(len(xs) - 1, max(0, round(p / 100.0 * (len(xs) - 1))))
    return xs[i]
