"""AAC-LC radio content from a seed: ADTS streams tiled from one asset.

``dryrun.aac`` here is a byte copy of ``tests/assets/dryrun.aac`` at commit
15c54f8 of this repository (89 ADTS frames, AAC-LC, 44.1 kHz stereo,
~96 kbps; short windows, TNS, escapes, PNS and M/S).  The repository has no
AAC encoder, so a stream is the asset's frames from a start frame on,
cycling through the asset (the tiling of
``ohpipeline_tpu_torch/bench_secondary.py``'s ``aac_streams`` at 15c54f8,
with the start frame drawn from the seed rather than the stream index).
Nothing here imports the port.
"""

from __future__ import annotations

import math
import pathlib

import numpy as np

ASSET = pathlib.Path(__file__).resolve().parent / "dryrun.aac"
RATE = 44100
FRAME = 1024


def adts_frames(data: bytes) -> list[bytes]:
    """The ADTS frames of ``data``, split at each header's frame length."""
    frames, pos = [], 0
    while pos + 7 <= len(data) and data[pos] == 0xFF \
            and (data[pos + 1] & 0xF6) == 0xF0:
        n = ((data[pos + 3] & 0x03) << 11) | (data[pos + 4] << 3) \
            | (data[pos + 5] >> 5)
        if n < 7:
            break
        frames.append(data[pos:pos + n])
        pos += n
    return frames


def asset_frames() -> list[bytes]:
    return adts_frames(ASSET.read_bytes())


def tiled_stream(frames: list[bytes], start: int, seconds: float) -> bytes:
    """``seconds`` of audio as the asset's frames from ``start`` on."""
    n = math.ceil(seconds * RATE / FRAME)
    return b"".join(frames[(start + k) % len(frames)] for k in range(n))


def streams(seed: int, count: int, seconds: float) -> list[bytes]:
    """``count`` streams of ``seconds`` each, their start frames drawn from
    ``seed``."""
    frames = asset_frames()
    starts = np.random.default_rng(seed).integers(0, len(frames), count)
    return [tiled_stream(frames, int(s), seconds) for s in starts]


def make(cfg: dict, cell: dict, seed: int) -> dict:
    """The cell's ``streams`` streams of ``stream_seconds`` each:
    {"streams": ADTS bytes}."""
    return {"streams": streams(seed, int(cell["streams"]),
                               float(cell["stream_seconds"])),
            "suffix": ".aac"}
