"""HE-AAC v1 radio content from a seed: ADTS streams of the header-led
segments of one asset.

``dryrun_he.aac`` here is a byte copy of ``tests/assets/dryrun_he.aac`` at
commit f4813dd of this repository (46 ADTS frames, 13,405 bytes, sha256
21a8e3e515860b6bf02eace61bcb1852bf09107bd3e903b5d5a01550322663fe): an
AAC-LC core at 22.05 kHz stereo with SBR to 44.1 kHz, ~50 kbps.  Frames 0,
10, 20, 30 and 40 carry an SBR header and code their first envelope and
noise floor in frequency, so each run of frames from one of them to the
next (:data:`SEGMENTS`) decodes without the frames before it.  The
repository has no HE-AAC encoder, so a stream is a sequence of those five
segments in an order the seed draws, cut to the cell's length; every
stream starts at a header frame and the streams of one cell are distinct.
Nothing here imports the port.
"""

from __future__ import annotations

import math
import pathlib

import numpy as np

from .aac import adts_frames

ASSET = pathlib.Path(__file__).resolve().parent / "dryrun_he.aac"
#: The output rate and the output samples of one frame (1024 core samples
#: at 22.05 kHz, doubled by SBR).
RATE = 44100
FRAME = 2048
#: (first, end) frames of the asset's header-led segments.
SEGMENTS = ((0, 10), (10, 20), (20, 30), (30, 40), (40, 46))


def asset_frames() -> list[bytes]:
    return adts_frames(ASSET.read_bytes())


def stream_frames(seconds: float) -> int:
    """Frames of a stream of ``seconds``: ceil(seconds * 44100 / 2048)."""
    return math.ceil(seconds * RATE / FRAME)


def segment_stream(frames: list[bytes], order, n: int) -> bytes:
    """The segments ``order`` names, one after another, cut to ``n``
    frames."""
    out: list = []
    for k in order:
        a, b = SEGMENTS[int(k)]
        out += frames[a:b]
        if len(out) >= n:
            break
    return b"".join(out[:n])


def streams(seed: int, count: int, seconds: float) -> list[bytes]:
    """``count`` distinct streams of ``seconds`` each, their segment orders
    drawn from ``seed`` (a draw that repeats an earlier stream is drawn
    again)."""
    frames = asset_frames()
    n = stream_frames(seconds)
    # enough segments for n frames even if every draw is the short one
    k = -(-n // min(b - a for a, b in SEGMENTS))
    rng = np.random.default_rng(seed)
    out: list = []
    while len(out) < count:
        s = segment_stream(frames, rng.integers(0, len(SEGMENTS), k), n)
        if s not in out:
            out.append(s)
    return out


def make(cfg: dict, cell: dict, seed: int) -> dict:
    """The cell's ``streams`` streams of ``stream_seconds`` each, and the
    indices of the ``check_streams`` of them the comparison decodes, drawn
    from ``seed``: {"streams": ADTS bytes, "check": sorted indices}."""
    count = int(cell["streams"])
    rng = np.random.default_rng([seed, 1])
    check = rng.choice(count, min(int(cell["check_streams"]), count),
                       replace=False)
    return {"streams": streams(seed, count, float(cell["stream_seconds"])),
            "check": sorted(int(i) for i in check)}
