"""WAV (RIFF) codec — parse headers host-side, samples via ops.pcm.

Parity target: OpenHome/Media/Codec/Wav.cpp (CodecWav): RIFF/WAVE chunk
walk, fmt parsing (PCM and IEEE-float, WAVE_FORMAT_EXTENSIBLE), data chunk
streaming, sample-accurate seek by byte position.
"""

from __future__ import annotations

import struct
from typing import Optional

from ..core.streaminfo import PcmStreamInfo
from ..ops import pcm
from .base import (BufferReader, CodecBase, CodecStreamCorrupt, DecodedBatch,
                   EndOfStream, StreamReader)

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE

READ_CHUNK = 64 * 1024


class CodecWav(CodecBase):
    name = "WAV"
    recognition_cost = 10
    mime_types = ("audio/wav", "audio/wave", "audio/x-wav")

    def __init__(self):
        self._info: Optional[PcmStreamInfo] = None
        self._float = False
        self._data_start = 0
        self._data_bytes = 0
        self._read_bytes = 0

    def recognise(self, header: bytes) -> bool:
        return (len(header) >= 12 and header[:4] == b"RIFF"
                and header[8:12] == b"WAVE")

    def stream_initialise(self, reader: StreamReader) -> PcmStreamInfo:
        hdr = reader.read(12)
        if len(hdr) < 12 or hdr[:4] != b"RIFF" or hdr[8:12] != b"WAVE":
            raise CodecStreamCorrupt("not a RIFF/WAVE stream")
        pos = 12
        fmt = None
        # Chunk walk: fmt must precede data (true of real encoders; the
        # reference makes the same assumption, Wav.cpp).
        while True:
            chdr = reader.read(8)
            if len(chdr) < 8:
                raise CodecStreamCorrupt("no data chunk")
            cid, size = chdr[:4], struct.unpack("<I", chdr[4:])[0]
            pos += 8
            if cid == b"fmt ":
                body = reader.read(size + (size & 1))
                fmt = struct.unpack("<HHIIHH", body[:16])
                if fmt[0] == WAVE_FORMAT_EXTENSIBLE and size >= 40:
                    # SubFormat GUID's first 2 bytes are the real format tag
                    fmt = (struct.unpack("<H", body[24:26])[0],) + fmt[1:]
                pos += size + (size & 1)
            elif cid == b"data":
                if fmt is None:
                    raise CodecStreamCorrupt("data before fmt")
                self._data_start = pos
                self._data_bytes = size
                break
            else:
                body = reader.read(size + (size & 1))
                if len(body) < size:
                    raise CodecStreamCorrupt("truncated chunk")
                pos += size + (size & 1)

        tag, channels, rate, _byte_rate, block_align, bits = fmt
        if tag not in (WAVE_FORMAT_PCM, WAVE_FORMAT_IEEE_FLOAT):
            raise CodecStreamCorrupt(f"unsupported WAVE format 0x{tag:04x}")
        self._float = tag == WAVE_FORMAT_IEEE_FLOAT
        if channels < 1 or bits not in (8, 16, 24, 32, 64):
            raise CodecStreamCorrupt("bad fmt chunk")
        if self._data_bytes == 0 and reader.stream_bytes:
            self._data_bytes = reader.stream_bytes - self._data_start
        frame_bytes = channels * (bits // 8)
        total_samples = self._data_bytes // frame_bytes
        depth = 24 if self._float else min(bits, 32)
        from ..core.jiffies import Jiffies
        self._info = PcmStreamInfo(
            sample_rate=rate, bit_depth=depth, num_channels=channels,
            codec_name="WAV", lossless=not self._float, seekable=True,
            bitrate=rate * frame_bytes * 8,
            track_length_jiffies=total_samples * Jiffies.per_sample(rate))
        self._bits_on_wire = bits
        self._frame_bytes = frame_bytes
        self._read_bytes = 0
        return self._info

    def process(self, reader: StreamReader) -> DecodedBatch:
        remaining = self._data_bytes - self._read_bytes
        if remaining <= 0:
            raise EndOfStream
        want = min(READ_CHUNK, remaining)
        want -= want % self._frame_bytes
        data = reader.read(max(want, self._frame_bytes))
        if not data:
            raise EndOfStream
        offset = self._read_bytes // self._frame_bytes
        self._read_bytes += len(data)
        data = data[: len(data) - len(data) % self._frame_bytes]
        samples = pcm.unpack_pcm_bytes(
            data, self._bits_on_wire, self._info.num_channels,
            big_endian=False, signed=self._bits_on_wire != 8,
            float_format=self._float)
        return DecodedBatch(self._info, samples=samples,
                            track_offset_samples=offset)

    def try_seek(self, sample: int) -> Optional[int]:
        pos = self._data_start + sample * self._frame_bytes
        self._read_bytes = sample * self._frame_bytes
        return pos


def parse_wav(data: bytes) -> tuple[PcmStreamInfo, "np.ndarray"]:
    """Decode a whole in-memory WAV (tests / tools)."""
    import numpy as np
    codec = CodecWav()
    r = BufferReader(data)
    info = codec.stream_initialise(r)
    parts = []
    while True:
        try:
            parts.append(codec.process(r).samples)
        except EndOfStream:
            break
    return info, (np.concatenate(parts, axis=1) if parts
                  else np.zeros((info.num_channels, 0), np.int32))


def write_wav(samples, sample_rate: int, bit_depth: int) -> bytes:
    """(channels, n) int32 native range -> WAV bytes (test-vector source)."""
    payload = pcm.pack_pcm_bytes(samples, bit_depth)
    ch = samples.shape[0]
    frame = ch * bit_depth // 8
    hdr = struct.pack(
        "<4sI4s4sIHHIIHH4sI", b"RIFF", 36 + len(payload), b"WAVE", b"fmt ",
        16, WAVE_FORMAT_PCM, ch, sample_rate, sample_rate * frame, frame,
        bit_depth, b"data", len(payload))
    return hdr + payload
