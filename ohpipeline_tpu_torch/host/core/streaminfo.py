"""Stream/sample format descriptors shared by the whole framework.

Behavioural parity targets: the reference's `PcmStreamInfo`/`DecodedStreamInfo`
(OpenHome/Media/Pipeline/Msg.h:780-930) — sample rate, bit depth, channels,
codec name, seekability, live-ness, bitrate, sample-count bookkeeping.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from . import jiffies


class SampleFormat(enum.Enum):
    """On-the-wire PCM subsample encodings we can ingest/emit.

    Internal processing always uses int32 arrays holding samples in the
    *native range* of `bit_depth` (e.g. a 16-bit stream's samples lie in
    [-32768, 32767]); the framework converts at the edges.
    """

    S8 = ("s8", 8, "int8")
    S16_LE = ("s16le", 16, "<i2")
    S16_BE = ("s16be", 16, ">i2")
    S24_LE = ("s24le", 24, None)   # 3-byte packed
    S24_BE = ("s24be", 24, None)
    S32_LE = ("s32le", 32, "<i4")
    S32_BE = ("s32be", 32, ">i4")
    F32_LE = ("f32le", 32, "<f4")
    F64_LE = ("f64le", 64, "<f8")

    def __init__(self, tag: str, bits: int, np_dtype: str | None):
        self.tag = tag
        self.bits = bits
        self.np_dtype = np_dtype


class AudioFormat(enum.Enum):
    """Decoded audio domain (Msg.h `AudioFormat`): PCM samples or DSD bits."""
    PCM = "pcm"
    DSD = "dsd"


class Latency(enum.Enum):
    """Latency mode for a stream (Msg.h:373-378 `enum class Latency`)."""
    NOT_SUPPORTED = "not_supported"
    INTERNAL = "internal"      # pipeline picks its own buffering
    EXTERNAL = "external"      # sender dictates latency (Songcast/RAOP)


class MultiroomCapability(enum.Enum):
    ALLOWED = "allowed"
    FORBIDDEN = "forbidden"


@dataclass(frozen=True, slots=True)
class PcmStreamInfo:
    """Format of a decoded stream (reference `DecodedStreamInfo`, Msg.h:833)."""

    sample_rate: int
    bit_depth: int
    num_channels: int
    codec_name: str = ""
    bitrate: int = 0                   # bits/sec of the *encoded* stream
    track_length_jiffies: int = 0
    sample_start: int = 0              # absolute sample index of first sample
    lossless: bool = True
    seekable: bool = False
    live: bool = False
    analog_bypass: bool = False
    audio_format: AudioFormat = AudioFormat.PCM
    multiroom: MultiroomCapability = MultiroomCapability.ALLOWED
    profile: str = ""                  # speaker profile / channel layout tag

    def __post_init__(self):
        if self.audio_format is AudioFormat.PCM:
            if not jiffies.Jiffies.is_valid_sample_rate(self.sample_rate):
                raise ValueError(f"unsupported sample rate {self.sample_rate}")
            if self.bit_depth not in (8, 16, 24, 32):
                raise ValueError(f"unsupported bit depth {self.bit_depth}")
        if not 1 <= self.num_channels <= 8:   # Msg.h:171 kMaxNumChannels==8
            raise ValueError(f"unsupported channel count {self.num_channels}")

    @property
    def jiffies_per_sample(self) -> int:
        return jiffies.Jiffies.per_sample(self.sample_rate)

    @property
    def byte_rate(self) -> int:
        return self.sample_rate * self.num_channels * (self.bit_depth // 8)

    def with_(self, **kw) -> "PcmStreamInfo":
        from dataclasses import replace
        return replace(self, **kw)


@dataclass(frozen=True, slots=True)
class EncodedStreamInfo:
    """Format of an encoded stream entering the pipeline (MsgEncodedStream,
    Msg.h:603-663)."""

    uri: str = ""
    metatext: str = ""
    total_bytes: int = 0
    start_pos: int = 0
    stream_id: int = 0
    seekable: bool = False
    live: bool = False
    multiroom: MultiroomCapability = MultiroomCapability.ALLOWED
    # raw PCM/DSD streams carry their format inline (MsgEncodedStream's
    # optional PcmStreamInfo/DsdStreamInfo)
    pcm_format: PcmStreamInfo | None = None
