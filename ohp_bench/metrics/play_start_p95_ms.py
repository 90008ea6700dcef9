"""play_start_p95_ms: the 95th percentile, over every play of the window,
of the time from ``play_uri`` to the first PCM reaching the sink.  A play
that rendered no PCM counts as the longest."""

import numpy as np


def starts_ms(window: dict) -> list:
    return [float("inf") if r["start_s"] is None else 1e3 * r["start_s"]
            for r in window["records"]]


def read(window: dict):
    s = starts_ms(window)
    return float(np.percentile(s, 95)) if s else None
