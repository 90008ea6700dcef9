"""Ogg page/packet framing (the role libogg plays for the reference's
ogg-FLAC and Vorbis paths; written from RFC 3533, not from libogg).

`OggReader` demultiplexes one logical stream's packets from a physical Ogg
byte stream (page capture, CRC check, continued-packet reassembly).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Iterator, Optional

from ..codecs.base import StreamReader

_CRC_TABLE = None


def _crc_lookup():
    global _CRC_TABLE
    if _CRC_TABLE is None:
        table = []
        for i in range(256):
            r = i << 24
            for _ in range(8):
                r = ((r << 1) ^ 0x04C11DB7) & 0xFFFFFFFF if r & 0x80000000 \
                    else (r << 1) & 0xFFFFFFFF
            table.append(r)
        _CRC_TABLE = table
    return _CRC_TABLE


def ogg_crc(data: bytes) -> int:
    t = _crc_lookup()
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ t[((crc >> 24) ^ b) & 0xFF]
    return crc


@dataclass(slots=True)
class OggPage:
    version: int
    header_type: int        # 1=continued, 2=bos, 4=eos
    granule: int
    serial: int
    sequence: int
    segments: list[bytes]
    continued_first: bool
    incomplete_last: bool

    @property
    def bos(self) -> bool:
        return bool(self.header_type & 2)

    @property
    def eos(self) -> bool:
        return bool(self.header_type & 4)


def parse_page(data: bytes, offset: int = 0,
               check_crc: bool = True) -> Optional[tuple[OggPage, int]]:
    """Parse one page at `offset`; returns (page, next_offset) or None."""
    if data[offset:offset + 4] != b"OggS":
        return None
    if offset + 27 > len(data):
        return None
    (version, htype, granule, serial, seq, crc,
     nsegs) = struct.unpack_from("<BBqIIIB", data, offset + 4)
    lace = data[offset + 27:offset + 27 + nsegs]
    if len(lace) < nsegs:
        return None
    body_len = sum(lace)
    start = offset + 27 + nsegs
    if start + body_len > len(data):
        return None
    if check_crc:
        raw = bytearray(data[offset:start + body_len])
        raw[22:26] = b"\x00" * 4
        if ogg_crc(bytes(raw)) != crc:
            return None
    segments = []
    pos = start
    cur = bytearray()
    incomplete = False
    for i, l in enumerate(lace):
        cur += data[pos:pos + l]
        pos += l
        if l < 255:
            segments.append(bytes(cur))
            cur = bytearray()
    if cur or (lace and lace[-1] == 255):
        segments.append(bytes(cur))
        incomplete = True
    return OggPage(version, htype, granule, serial, seq, segments,
                   continued_first=bool(htype & 1),
                   incomplete_last=incomplete), start + body_len


class OggReader:
    """Packet iterator over a StreamReader carrying an Ogg stream."""

    def __init__(self, reader: StreamReader, serial: Optional[int] = None):
        self._reader = reader
        self._buf = b""
        self._pos = 0
        self.serial = serial
        self.last_granule = -1

    def _fill(self, want: int = 1 << 16) -> bool:
        data = self._reader.read(want)
        if not data:
            return False
        self._buf = self._buf[self._pos:] + data
        self._pos = 0
        return True

    def pages(self) -> Iterator[OggPage]:
        while True:
            r = parse_page(self._buf, self._pos)
            if r is None:
                # need more data or resync
                sync = self._buf.find(b"OggS", self._pos + 1)
                if sync != -1 and parse_page(self._buf, sync) is not None:
                    self._pos = sync
                    continue
                if not self._fill():
                    return
                continue
            page, nxt = r
            self._pos = nxt
            if self.serial is None and page.bos:
                self.serial = page.serial
            if self.serial is not None and page.serial != self.serial:
                continue
            if page.granule >= 0:
                self.last_granule = page.granule
            yield page

    def packets(self) -> Iterator[bytes]:
        pending = b""
        for page in self.pages():
            segs = list(page.segments)
            if page.continued_first and segs:
                pending += segs.pop(0)
                if segs or not page.incomplete_last:
                    yield pending
                    pending = b""
            elif pending:
                pending = b""      # continuation lost (resync)
            for i, s in enumerate(segs):
                if i == len(segs) - 1 and page.incomplete_last:
                    pending = s
                else:
                    yield s


def build_page(serial: int, sequence: int, granule: int, packets: list[bytes],
               header_type: int = 0) -> bytes:
    """Construct one Ogg page (max 255 lacing values; use build_pages for
    arbitrarily large packets)."""
    lace = bytearray()
    body = bytearray()
    for p in packets:
        n = len(p)
        while n >= 255:
            lace.append(255)
            n -= 255
        lace.append(n)
        body += p
    if len(lace) > 255:
        raise ValueError("packet set needs >255 lacing values; use "
                         "build_pages")
    hdr = struct.pack("<4sBBqIIIB", b"OggS", 0, header_type, granule, serial,
                      sequence, 0, len(lace)) + bytes(lace)
    page = bytearray(hdr + body)
    crc = ogg_crc(bytes(page))
    page[22:26] = struct.pack("<I", crc)
    return bytes(page)


def build_pages(serial: int, packets: list[bytes], first_sequence: int = 0,
                granule: int = 0, bos: bool = False,
                eos: bool = False) -> bytes:
    """Encode packets into as many pages as needed (packets spanning pages
    get continuation flags) — the encode-side counterpart of OggReader."""
    MAX_SEGS = 255
    out = bytearray()
    seq = first_sequence
    # flatten to lacing runs tagged with continuation info
    runs: list[tuple[int, bool]] = []   # (lace_value, ends_packet)
    body = bytearray()
    for p in packets:
        n = len(p)
        body += p
        while n >= 255:
            runs.append((255, False))
            n -= 255
        runs.append((n, True))
    pos = 0
    i = 0
    first_page = True
    while i < len(runs) or first_page:
        page_runs = runs[i:i + MAX_SEGS]
        i += len(page_runs)
        size = sum(v for v, _ in page_runs)
        htype = 0
        if bos and first_page:
            htype |= 2
        if not first_page:
            htype |= 1   # continued from previous page iff mid-packet
            # only set continuation when previous page ended mid-packet
            prev_last = runs[i - len(page_runs) - 1]
            if prev_last[1]:
                htype &= ~1
        if eos and i >= len(runs):
            htype |= 4
        last_complete = page_runs[-1][1] if page_runs else True
        g = granule if (i >= len(runs) or last_complete) else -1
        lace = bytes(v for v, _ in page_runs)
        hdr = struct.pack("<4sBBqIIIB", b"OggS", 0, htype, g, serial, seq,
                          0, len(lace)) + lace
        page = bytearray(hdr + body[pos:pos + size])
        pos += size
        crc = ogg_crc(bytes(page))
        page[22:26] = struct.pack("<I", crc)
        out += page
        seq += 1
        first_page = False
    return bytes(out)
