"""Raw PCM codec for streams whose format is announced out-of-band.

Parity target: OpenHome/Media/Codec/Pcm.cpp (CodecPcm) — accepts streams
whose `EncodedStreamEvent` carries an inline `PcmStreamInfo` (raw PCM from
Songcast/SCD/RAAT-style sources) and passes the bytes through the standard
unpack path.
"""

from __future__ import annotations

from typing import Optional

from ..core.streaminfo import PcmStreamInfo, SampleFormat
from ..ops import pcm
from .base import CodecBase, DecodedBatch, EndOfStream, StreamReader

READ_CHUNK = 64 * 1024


class CodecPcm(CodecBase):
    name = "PCM"
    recognition_cost = 0
    mime_types = ("audio/L16", "audio/pcm")

    def __init__(self, announced: Optional[PcmStreamInfo] = None,
                 sample_format: SampleFormat = SampleFormat.S16_BE):
        self._info = announced
        self._fmt = sample_format
        self._read_bytes = 0

    def set_stream_format(self, info: PcmStreamInfo,
                          sample_format: SampleFormat) -> None:
        """Out-of-band format announcement (CodecController passes
        MsgEncodedStream's PcmStreamInfo through, CodecController.cpp)."""
        self._info = info
        self._fmt = sample_format

    def recognise(self, header: bytes) -> bool:
        # Raw PCM is only selected when a format was announced out-of-band.
        return self._info is not None

    def stream_initialise(self, reader: StreamReader) -> PcmStreamInfo:
        self._read_bytes = 0
        self._frame_bytes = (self._info.num_channels * self._fmt.bits // 8)
        return self._info

    def process(self, reader: StreamReader) -> DecodedBatch:
        data = reader.read(READ_CHUNK - READ_CHUNK % self._frame_bytes)
        if not data:
            raise EndOfStream
        offset = self._read_bytes // self._frame_bytes
        self._read_bytes += len(data)
        data = data[: len(data) - len(data) % self._frame_bytes]
        big_endian = self._fmt.tag.endswith("be")
        samples = pcm.unpack_pcm_bytes(
            data, self._fmt.bits, self._info.num_channels,
            big_endian=big_endian,
            float_format=self._fmt in (SampleFormat.F32_LE, SampleFormat.F64_LE))
        return DecodedBatch(self._info, samples=samples,
                            track_offset_samples=offset)

    def try_seek(self, sample: int) -> Optional[int]:
        self._read_bytes = sample * self._frame_bytes
        return sample * self._frame_bytes
