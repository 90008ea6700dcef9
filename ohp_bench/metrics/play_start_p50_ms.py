"""play_start_p50_ms: the median of the samples of ``play_start_p95_ms``.
It separates a stall, which moves only the 95th percentile, from a slower
first group, which moves both."""

import numpy as np

from .play_start_p95_ms import starts_ms


def read(window: dict):
    s = starts_ms(window)
    return float(np.percentile(s, 50)) if s else None
