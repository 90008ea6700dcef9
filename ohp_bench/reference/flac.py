"""The benchmark's reference for FLAC: the samples the content was encoded
from.  FLAC is lossless, so a decoded track is correct only if it equals,
sample for sample, the track the benchmark made from the seed
(``content/flac.make_track``).  It imports nothing of the port."""

from __future__ import annotations

import numpy as np


def mismatched_samples(pcm: np.ndarray, track: np.ndarray) -> int:
    """Samples of ``pcm`` that differ from ``track``, counting each sample
    missing from or added to either as one."""
    pcm = np.asarray(pcm)
    if pcm.ndim != 2 or pcm.shape[0] != track.shape[0]:
        return int(track.size + pcm.size)
    n = min(pcm.shape[1], track.shape[1])
    extra = abs(pcm.shape[1] - track.shape[1]) * track.shape[0]
    return int(np.count_nonzero(pcm[:, :n] != track[:, :n])) + extra


def compare(content: dict, outputs: list, path: str, cell: dict) -> dict:
    """``outputs``: (stream index, PCM) pairs the timed path produced.
    Returns {"pcm_mismatch": the most samples any output got wrong}."""
    worst = 0
    for i, pcm in outputs:
        worst = max(worst, mismatched_samples(pcm, content["pcm"][i]))
    return {"pcm_mismatch": worst}


def lower_precision(content: dict, outputs: list, path: str,
                    cell: dict) -> list:
    """The control: each output's reference (its track) at the nearest
    lower precision, 15 bits (the least significant bit of every 16-bit
    sample cleared)."""
    return [(i, content["pcm"][i] & ~1) for i, _ in outputs]
