"""tone:// protocol — generated test tones (reference ProtocolTone.cpp,
894 LoC): synthesises WAV streams from URIs like

    tone://square.wav?bitdepth=16&samplerate=44100&pitch=1000&channels=2&duration=10
    tone://constant-16.wav?...   (constant value = pitch field)
    tone://silence.wav?...

Waveforms: sine, square, sawtooth, triangle, constant, silence (the
reference's ToneGenerator family).
"""

from __future__ import annotations

import urllib.parse

import numpy as np

from ..codecs.wav import write_wav
from ..core.streaminfo import EncodedStreamInfo
from .base import Protocol, ProtocolStreamResult

DEFAULTS = dict(bitdepth=16, samplerate=44100, pitch=440, channels=2,
                duration=10)


def generate_tone(waveform: str, bitdepth: int, samplerate: int, pitch: int,
                  channels: int, duration: float) -> np.ndarray:
    n = int(samplerate * duration)
    amp = (1 << (bitdepth - 1)) - 1
    t = np.arange(n)
    phase = (t * pitch / samplerate) % 1.0
    if waveform == "sine":
        x = np.sin(2 * np.pi * phase) * amp
    elif waveform == "square":
        x = np.where(phase < 0.5, amp, -amp).astype(np.float64)
    elif waveform == "sawtooth":
        x = (2 * phase - 1) * amp
    elif waveform == "triangle":
        x = (1 - 4 * np.abs(phase - 0.5)) * amp
    elif waveform.startswith("constant"):
        x = np.full(n, float(pitch))
    elif waveform == "silence":
        x = np.zeros(n)
    else:
        raise ValueError(f"unknown waveform {waveform}")
    s = np.rint(x).astype(np.int32)
    return np.tile(s, (channels, 1))


class ProtocolTone(Protocol):
    name = "Tone"

    def recognise(self, uri: str) -> bool:
        return uri.startswith("tone://")

    def stream(self, uri: str) -> ProtocolStreamResult:
        parsed = urllib.parse.urlparse(uri)
        waveform = parsed.netloc.rsplit(".", 1)[0]
        q = {k: v[0] for k, v in urllib.parse.parse_qs(parsed.query).items()}
        try:
            params = {k: type(d)(q.get(k, d)) for k, d in DEFAULTS.items()}
            tone = generate_tone(waveform, **params)
        except (ValueError, KeyError):
            return ProtocolStreamResult.ERROR_UNRECOVERABLE
        data = write_wav(tone, params["samplerate"], params["bitdepth"])
        sid = self.next_stream_id()
        self.supply.output_stream(
            EncodedStreamInfo(uri=uri, total_bytes=len(data), stream_id=sid,
                              seekable=False, live=False),
            stream_handler=self)
        self.supply.output_data(data)
        if hasattr(self.supply, "flush_pending"):
            self.supply.flush_pending()
        return ProtocolStreamResult.SUCCESS
