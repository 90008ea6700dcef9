"""Opus packet framing (RFC 6716 section 3.2): a packet's TOC and frames.

``split_packet_frames`` as the JAX package's ``codecs/opus/__init__.py`` has
it; the rest of that module is the ``CodecOpus`` plug-in, which the port does
not use.
"""

from __future__ import annotations

from ..base import CodecStreamCorrupt
from ..opus_headers import OpusToc, parse_toc


def split_packet_frames(packet: bytes) -> tuple[OpusToc, list[bytes]]:
    """RFC 6716 s3.2 packet -> frames."""
    if not packet:
        raise CodecStreamCorrupt("empty opus packet")
    toc = parse_toc(packet)
    code = packet[0] & 3
    body = packet[1:]

    def read_len(buf, p):
        if p >= len(buf):
            raise CodecStreamCorrupt("truncated opus frame length")
        v = buf[p]
        p += 1
        if v >= 252:
            if p >= len(buf):
                raise CodecStreamCorrupt("truncated opus frame length")
            v += 4 * buf[p]
            p += 1
        return v, p

    if code == 0:
        frames = [body]
    elif code == 1:
        if len(body) % 2:
            raise CodecStreamCorrupt("code-1 packet with odd length")
        h = len(body) // 2
        frames = [body[:h], body[h:]]
    elif code == 2:
        ln, p = read_len(body, 0)
        frames = [body[p:p + ln], body[p + ln:]]
    else:
        if not body:
            raise CodecStreamCorrupt("empty code-3 packet")
        fc = body[0]
        m = fc & 0x3F
        vbr = fc & 0x80
        pad = fc & 0x40
        p = 1
        padding = 0
        if pad:
            while True:
                if p >= len(body):
                    raise CodecStreamCorrupt("truncated opus padding")
                v = body[p]
                p += 1
                padding += v if v < 255 else 254
                if v < 255:
                    break
        if vbr:
            if m == 0:
                raise CodecStreamCorrupt("bad VBR code-3 packet")
            lens = []
            for _ in range(m - 1):
                ln, p = read_len(body, p)
                lens.append(ln)
            avail = len(body) - p - padding
            last = avail - sum(lens)
            if last < 0:
                raise CodecStreamCorrupt("bad VBR code-3 lengths")
            lens.append(last)
            frames = []
            for ln in lens:
                frames.append(body[p:p + ln])
                p += ln
        else:
            avail = len(body) - p - padding
            if m == 0 or avail % m:
                raise CodecStreamCorrupt("bad CBR code-3 packet")
            ln = avail // m
            frames = [body[p + i * ln:p + (i + 1) * ln] for i in range(m)]
    return toc, frames
