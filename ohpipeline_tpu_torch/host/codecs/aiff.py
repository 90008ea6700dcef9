"""AIFF / AIFF-C codec.

Parity target: OpenHome/Media/Codec/AiffBase.cpp, Aiff.cpp, Aifc.cpp —
FORM/AIFF chunk walk, COMM parsing (channels, frames, bit depth, 80-bit
extended-float sample rate), big-endian PCM in SSND; AIFF-C additionally
carries a compression id (only 'NONE'/'sowt' raw PCM are accepted, matching
the reference).
"""

from __future__ import annotations

import struct
from typing import Optional

from ..core.jiffies import Jiffies
from ..core.streaminfo import PcmStreamInfo
from ..ops import pcm
from .base import (CodecBase, CodecStreamCorrupt, DecodedBatch, EndOfStream,
                   StreamReader)

READ_CHUNK = 64 * 1024


def _decode_extended80(b: bytes) -> int:
    """80-bit IEEE 754 extended float -> int sample rate (AiffBase.cpp)."""
    if len(b) != 10:
        raise CodecStreamCorrupt("bad extended float")
    exp = ((b[0] & 0x7F) << 8) | b[1]
    mant = int.from_bytes(b[2:10], "big")
    if exp == 0 and mant == 0:
        return 0
    value = mant * 2.0 ** (exp - 16383 - 63)
    if b[0] & 0x80:
        value = -value
    return int(round(value))


def encode_extended80(rate: int) -> bytes:
    """Int sample rate -> 80-bit extended float (for the test encoder)."""
    if rate == 0:
        return bytes(10)
    e = rate.bit_length() - 1
    mant = rate << (63 - e)
    return struct.pack(">H", 16383 + e) + mant.to_bytes(8, "big")


class CodecAiffBase(CodecBase):
    recognition_cost = 10
    _form_type = b"AIFF"

    def __init__(self):
        self._info: Optional[PcmStreamInfo] = None
        self._little_endian = False
        self._data_start = 0
        self._data_bytes = 0
        self._read_bytes = 0

    def recognise(self, header: bytes) -> bool:
        return (len(header) >= 12 and header[:4] == b"FORM"
                and header[8:12] == self._form_type)

    def _check_compression(self, body: bytes) -> None:
        pass

    def stream_initialise(self, reader: StreamReader) -> PcmStreamInfo:
        hdr = reader.read(12)
        if len(hdr) < 12 or hdr[:4] != b"FORM" or hdr[8:12] != self._form_type:
            raise CodecStreamCorrupt("not an AIFF stream")
        pos = 12
        comm = None
        while True:
            chdr = reader.read(8)
            if len(chdr) < 8:
                raise CodecStreamCorrupt("no SSND chunk")
            cid, size = chdr[:4], struct.unpack(">I", chdr[4:])[0]
            pos += 8
            if cid == b"COMM":
                body = reader.read(size + (size & 1))
                channels, frames, bits = struct.unpack(">HIH", body[:8])
                rate = _decode_extended80(body[8:18])
                self._check_compression(body[18:])
                comm = (channels, frames, bits, rate)
                pos += size + (size & 1)
            elif cid == b"SSND":
                if comm is None:
                    raise CodecStreamCorrupt("SSND before COMM")
                ssnd = reader.read(8)
                offset = struct.unpack(">I", ssnd[:4])[0]
                if offset:
                    reader.read(offset)
                self._data_start = pos + 8 + offset
                self._data_bytes = size - 8 - offset
                break
            else:
                body = reader.read(size + (size & 1))
                if len(body) < size:
                    raise CodecStreamCorrupt("truncated chunk")
                pos += size + (size & 1)

        channels, frames, bits, rate = comm
        if bits not in (8, 16, 24, 32) or channels < 1:
            raise CodecStreamCorrupt("unsupported COMM")
        self._frame_bytes = channels * (bits // 8)
        self._bits = bits
        self._read_bytes = 0
        self._info = PcmStreamInfo(
            sample_rate=rate, bit_depth=bits, num_channels=channels,
            codec_name=self.name, lossless=True, seekable=True,
            bitrate=rate * self._frame_bytes * 8,
            track_length_jiffies=frames * Jiffies.per_sample(rate))
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
            data, self._bits, self._info.num_channels,
            big_endian=not self._little_endian)
        return DecodedBatch(self._info, samples=samples,
                            track_offset_samples=offset)

    def try_seek(self, sample: int) -> Optional[int]:
        pos = self._data_start + sample * self._frame_bytes
        self._read_bytes = sample * self._frame_bytes
        return pos


class CodecAiff(CodecAiffBase):
    name = "AIFF"
    mime_types = ("audio/aiff", "audio/x-aiff")
    _form_type = b"AIFF"


class CodecAifc(CodecAiffBase):
    name = "AIFC"
    mime_types = ("audio/aiff", "audio/x-aiff")
    _form_type = b"AIFC"

    def _check_compression(self, body: bytes) -> None:
        if len(body) < 4:
            raise CodecStreamCorrupt("AIFC COMM missing compression id")
        comp = body[:4]
        if comp == b"sowt":
            self._little_endian = True
        elif comp not in (b"NONE", b"twos"):
            raise CodecStreamCorrupt(f"unsupported AIFC compression {comp!r}")


def write_aiff(samples, sample_rate: int, bit_depth: int) -> bytes:
    """(channels, n) int32 -> AIFF bytes (test-vector source)."""
    payload = pcm.pack_pcm_bytes(samples, bit_depth, big_endian=True)
    ch, n = samples.shape
    comm = struct.pack(">4sIHIH", b"COMM", 18, ch, n,
                       bit_depth) + encode_extended80(sample_rate)
    ssnd = struct.pack(">4sIII", b"SSND", 8 + len(payload), 0, 0) + payload
    body = b"AIFF" + comm + ssnd
    return struct.pack(">4sI", b"FORM", len(body)) + body
