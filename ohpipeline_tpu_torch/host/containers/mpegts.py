"""MPEG transport stream container (reference Codec/MpegTs.cpp): 188-byte
packets, PAT -> PMT -> audio PID selection, PES payload extraction (the
payload is typically ADTS AAC for HLS streams)."""

from __future__ import annotations

from typing import Iterator, Optional

from ..codecs.base import StreamReader
from .base import ContainerBase

TS_PACKET = 188
SYNC = 0x47

AUDIO_STREAM_TYPES = {0x03: "mp3", 0x04: "mp3", 0x0F: "aac_adts",
                      0x11: "aac_latm", 0x81: "ac3"}


class TsDemux:
    """Stateful TS packet demultiplexer -> elementary audio stream bytes."""

    def __init__(self):
        self.pmt_pid: Optional[int] = None
        self.audio_pid: Optional[int] = None
        self.audio_type: Optional[str] = None
        self._pes = bytearray()

    def _parse_psi(self, payload: bytes, is_pat: bool) -> None:
        if not payload:
            return
        pointer = payload[0]
        pos = 1 + pointer
        if pos + 8 > len(payload):
            return
        section_len = ((payload[pos + 1] & 0x0F) << 8) | payload[pos + 2]
        end = min(pos + 3 + section_len - 4, len(payload))  # minus CRC
        pos += 8
        if is_pat:
            while pos + 4 <= end:
                prog = (payload[pos] << 8) | payload[pos + 1]
                pid = ((payload[pos + 2] & 0x1F) << 8) | payload[pos + 3]
                if prog != 0:
                    self.pmt_pid = pid
                    break
                pos += 4
        else:
            # PMT: skip PCR PID + program info
            if pos + 4 > end:
                return
            info_len = ((payload[pos + 2] & 0x0F) << 8) | payload[pos + 3]
            pos += 4 + info_len
            while pos + 5 <= end:
                stype = payload[pos]
                pid = ((payload[pos + 1] & 0x1F) << 8) | payload[pos + 2]
                es_len = ((payload[pos + 3] & 0x0F) << 8) | payload[pos + 4]
                pos += 5 + es_len
                if stype in AUDIO_STREAM_TYPES and self.audio_pid is None:
                    self.audio_pid = pid
                    self.audio_type = AUDIO_STREAM_TYPES[stype]

    def feed_packet(self, pkt: bytes) -> bytes:
        """One 188-byte packet in; extracted audio ES bytes out."""
        if len(pkt) < TS_PACKET or pkt[0] != SYNC:
            return b""
        pid = ((pkt[1] & 0x1F) << 8) | pkt[2]
        pusi = bool(pkt[1] & 0x40)
        afc = (pkt[3] >> 4) & 0x3
        pos = 4
        if afc in (2, 3):
            pos += 1 + pkt[4]
        if afc in (1, 3) and pos < TS_PACKET:
            payload = pkt[pos:TS_PACKET]
        else:
            return b""
        if pid == 0:
            self._parse_psi(payload, is_pat=True)
            return b""
        if pid == self.pmt_pid:
            self._parse_psi(payload, is_pat=False)
            return b""
        if pid != self.audio_pid:
            return b""
        if pusi:
            # strip PES header: 00 00 01 sid len(2) flags(2) hdrlen(1)
            if len(payload) >= 9 and payload[:3] == b"\x00\x00\x01":
                hdr_len = payload[8]
                payload = payload[9 + hdr_len:]
        return payload


class _TsReader(StreamReader):
    """StreamReader exposing the demultiplexed audio elementary stream."""

    def __init__(self, inner: StreamReader):
        self._inner = inner
        self._demux = TsDemux()
        self._buf = bytearray()
        self._carry = b""

    def _fill(self, want: int) -> None:
        while len(self._buf) < want:
            raw = self._carry + self._inner.read(64 * TS_PACKET)
            self._carry = b""
            if not raw:
                return
            # align to sync byte
            start = 0
            while start < len(raw) and raw[start] != SYNC:
                start += 1
            usable = len(raw) - start
            usable -= usable % TS_PACKET
            for i in range(start, start + usable, TS_PACKET):
                self._buf += self._demux.feed_packet(raw[i:i + TS_PACKET])
            self._carry = raw[start + usable:]

    def read(self, n: int) -> bytes:
        self._fill(n)
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    def peek(self, n: int) -> bytes:
        self._fill(n)
        return bytes(self._buf[:n])

    @property
    def stream_bytes(self) -> Optional[int]:
        return None   # ES length unknowable without demuxing everything


class ContainerMpegTs(ContainerBase):
    name = "MPEG-TS"

    def __init__(self):
        self.metadata = {}

    def recognise(self, header: bytes) -> bool:
        # two aligned sync bytes
        return (len(header) > TS_PACKET and header[0] == SYNC
                and header[TS_PACKET] == SYNC)

    def wrap(self, reader: StreamReader) -> StreamReader:
        return _TsReader(reader)
