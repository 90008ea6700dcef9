"""DSD codecs: DSF, DFF (DSDIFF), raw DSD.

Parity targets: OpenHome/Media/Codec/DsdDsf.cpp, DsdDff.cpp, DsdRaw.cpp and
DsdFiller.cpp — parse the container, emit packed 1-bit DSD blocks
(channels x bytes, MSB-first = oldest bit first), pad partial blocks with
DSD silence (0x69 alternating bit pattern, the reference's kSilence).

DSF stores bits LSB-first within each byte and channel-blocked in 4096-byte
blocks; DFF stores MSB-first interleaved per byte.  Both normalise here to
MSB-first (channels, nbytes) uint8 arrays.  Bit reversal is a table lookup
on the host (cheap) — the dense DSD->PCM conversion, when wanted, is a
device op.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

from ..core.jiffies import Jiffies
from ..core.streaminfo import AudioFormat, PcmStreamInfo
from .base import (CodecBase, CodecStreamCorrupt, DecodedBatch, EndOfStream,
                   StreamReader)

DSD_SILENCE_BYTE = 0x69   # reference DsdFiller kSilenceByte

_BIT_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                        dtype=np.uint8)


class CodecDsdDsf(CodecBase):
    """Sony DSF container (DsdDsf.cpp)."""

    name = "DSF"
    recognition_cost = 10
    mime_types = ("audio/dsf", "audio/x-dsf")

    BLOCK = 4096  # bytes per channel per data block (DSF spec fixed)

    def __init__(self):
        self._info: Optional[PcmStreamInfo] = None

    def recognise(self, header: bytes) -> bool:
        return header[:4] == b"DSD "

    def stream_initialise(self, reader: StreamReader) -> PcmStreamInfo:
        dsd = reader.read(28)
        if dsd[:4] != b"DSD " or len(dsd) < 28:
            raise CodecStreamCorrupt("not DSF")
        fmt = reader.read(52)
        if fmt[:4] != b"fmt ":
            raise CodecStreamCorrupt("DSF missing fmt")
        (_, _, _version, _fmtid, ch_type, channels, rate, bits, samples,
         block, _) = struct.unpack("<4sQIIIIIIQII", fmt)
        if bits != 1 or block != self.BLOCK:
            raise CodecStreamCorrupt("unsupported DSF layout")
        if rate not in (2_822_400, 5_644_800, 11_289_600):
            raise CodecStreamCorrupt(f"unsupported DSD rate {rate}")
        data = reader.read(12)
        if data[:4] != b"data":
            raise CodecStreamCorrupt("DSF missing data")
        self._channels = channels
        self._total_samples = samples
        self._read_blocks = 0
        self._info = PcmStreamInfo(
            sample_rate=rate, bit_depth=1, num_channels=channels,
            codec_name="DSF", audio_format=AudioFormat.DSD, lossless=True,
            seekable=True, bitrate=rate * channels,
            track_length_jiffies=samples * Jiffies.per_sample(rate))
        return self._info

    def process(self, reader: StreamReader) -> DecodedBatch:
        raw = reader.read(self.BLOCK * self._channels)
        if not raw:
            raise EndOfStream
        if len(raw) < self.BLOCK * self._channels:
            raw += bytes([DSD_SILENCE_BYTE]) * (
                self.BLOCK * self._channels - len(raw))
        blocks = np.frombuffer(raw, np.uint8).reshape(self._channels,
                                                      self.BLOCK)
        msb_first = _BIT_REVERSE[blocks]        # DSF is LSB-first on disk
        offset = self._read_blocks * self.BLOCK * 8
        self._read_blocks += 1
        return DecodedBatch(self._info, samples=msb_first,
                            track_offset_samples=offset)


class CodecDsdDff(CodecBase):
    """Philips DSDIFF container (DsdDff.cpp)."""

    name = "DFF"
    recognition_cost = 10
    mime_types = ("audio/dff", "audio/x-dff")

    CHUNK = 16 * 1024

    def __init__(self):
        self._info: Optional[PcmStreamInfo] = None

    def recognise(self, header: bytes) -> bool:
        return header[:4] == b"FRM8" and header[12:16] == b"DSD "

    def stream_initialise(self, reader: StreamReader) -> PcmStreamInfo:
        frm8 = reader.read(16)
        if frm8[:4] != b"FRM8" or frm8[12:16] != b"DSD ":
            raise CodecStreamCorrupt("not DSDIFF")
        rate = 0
        channels = 0
        while True:
            hdr = reader.read(12)
            if len(hdr) < 12:
                raise CodecStreamCorrupt("no DSD data chunk")
            cid, size = hdr[:4], struct.unpack(">Q", hdr[4:])[0]
            if cid == b"PROP":
                body = reader.read(size + (size & 1))
                pos = 4  # skip 'SND ' qualifier
                while pos + 12 <= len(body):
                    sub, ssize = body[pos:pos + 4], struct.unpack(
                        ">Q", body[pos + 4:pos + 12])[0]
                    sbody = body[pos + 12:pos + 12 + ssize]
                    if sub == b"FS  ":
                        rate = struct.unpack(">I", sbody[:4])[0]
                    elif sub == b"CHNL":
                        channels = struct.unpack(">H", sbody[:2])[0]
                    elif sub == b"CMPR" and sbody[:4] != b"DSD ":
                        raise CodecStreamCorrupt("compressed DSDIFF")
                    pos += 12 + ssize + (ssize & 1)
            elif cid == b"DSD ":
                self._data_bytes = size
                break
            else:
                reader.read(size + (size & 1))
        if rate not in (2_822_400, 5_644_800, 11_289_600) or channels < 1:
            raise CodecStreamCorrupt("bad DSDIFF properties")
        self._channels = channels
        self._read_bytes = 0
        self._info = PcmStreamInfo(
            sample_rate=rate, bit_depth=1, num_channels=channels,
            codec_name="DFF", audio_format=AudioFormat.DSD, lossless=True,
            seekable=True, bitrate=rate * channels,
            track_length_jiffies=(size // channels) * 8
            * Jiffies.per_sample(rate))
        return self._info

    def process(self, reader: StreamReader) -> DecodedBatch:
        remaining = self._data_bytes - self._read_bytes
        if remaining <= 0:
            raise EndOfStream
        want = min(self.CHUNK, remaining)
        want -= want % self._channels
        raw = reader.read(max(want, self._channels))
        if not raw:
            raise EndOfStream
        offset = (self._read_bytes // self._channels) * 8
        self._read_bytes += len(raw)
        raw = raw[: len(raw) - len(raw) % self._channels]
        # DFF interleaves one byte per channel, MSB-first already.
        data = np.frombuffer(raw, np.uint8).reshape(-1, self._channels).T
        return DecodedBatch(self._info, samples=np.ascontiguousarray(data),
                            track_offset_samples=offset)


class CodecDsdRaw(CodecBase):
    """Raw DSD announced out-of-band (DsdRaw.cpp) — e.g. from RAAT."""

    name = "DSD-raw"
    recognition_cost = 0
    mime_types = ()

    CHUNK = 16 * 1024

    def __init__(self, announced: Optional[PcmStreamInfo] = None):
        self._info = announced
        self._read_bytes = 0

    def set_stream_format(self, info: PcmStreamInfo) -> None:
        self._info = info

    def recognise(self, header: bytes) -> bool:
        return (self._info is not None
                and self._info.audio_format is AudioFormat.DSD)

    def stream_initialise(self, reader: StreamReader) -> PcmStreamInfo:
        self._read_bytes = 0
        return self._info

    def process(self, reader: StreamReader) -> DecodedBatch:
        ch = self._info.num_channels
        raw = reader.read(self.CHUNK - self.CHUNK % ch)
        if not raw:
            raise EndOfStream
        offset = (self._read_bytes // ch) * 8
        self._read_bytes += len(raw)
        raw = raw[: len(raw) - len(raw) % ch]
        data = np.frombuffer(raw, np.uint8).reshape(-1, ch).T
        return DecodedBatch(self._info, samples=np.ascontiguousarray(data),
                            track_offset_samples=offset)
