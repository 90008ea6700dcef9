"""Ogg Opus framing headers (RFC 7845): OpusHead/OpusTags parse and the
TOC byte decode, shared by CodecOpus (Ogg) and CodecOpusMp4 (dOps)
(reference Media/Codec/Opus.cpp over thirdparty/opus-1.5.2).  The opus
oracle (tools/opus_oracle.c) provides both encode and decode ground
truth."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(slots=True)
class OpusHead:
    version: int
    channels: int
    pre_skip: int
    input_rate: int
    output_gain_q8: int
    mapping_family: int


def parse_opus_head(packet: bytes) -> OpusHead:
    if len(packet) < 19 or packet[:8] != b"OpusHead":
        raise ValueError("not an OpusHead packet")
    return OpusHead(
        version=packet[8],
        channels=packet[9],
        pre_skip=int.from_bytes(packet[10:12], "little"),
        input_rate=int.from_bytes(packet[12:16], "little"),
        output_gain_q8=int.from_bytes(packet[16:18], "little", signed=True),
        mapping_family=packet[18])


def parse_opus_tags(packet: bytes) -> tuple[str, dict]:
    if packet[:8] != b"OpusTags":
        raise ValueError("not an OpusTags packet")
    p = 8
    vl = int.from_bytes(packet[p:p + 4], "little")
    p += 4
    vendor = packet[p:p + vl].decode("utf-8", "replace")
    p += vl
    n = int.from_bytes(packet[p:p + 4], "little")
    p += 4
    tags: dict = {}
    for _ in range(n):
        ln = int.from_bytes(packet[p:p + 4], "little")
        p += 4
        item = packet[p:p + ln].decode("utf-8", "replace")
        p += ln
        k, _, v = item.partition("=")
        tags.setdefault(k.upper(), []).append(v)
    return vendor, tags


# TOC (RFC 6716 §3.1): config -> (mode, bandwidth, frame duration)
_CONFIGS = []
for _mode, _bands, _durs in (
        ("silk", ("nb", "mb", "wb"), (10, 20, 40, 60)),
        ("hybrid", ("swb", "fb"), (10, 20)),
        ("celt", ("nb", "wb", "swb", "fb"), (2.5, 5, 10, 20))):
    for _b in _bands:
        for _d in _durs:
            _CONFIGS.append((_mode, _b, _d))


@dataclass(slots=True)
class OpusToc:
    mode: str                 # silk / hybrid / celt
    bandwidth: str
    frame_ms: float
    stereo: bool
    frames_per_packet: int    # code 0..2 resolved; code 3 needs count byte


def parse_toc(packet: bytes) -> OpusToc:
    toc = packet[0]
    config = toc >> 3
    mode, bw, dur = _CONFIGS[config]
    code = toc & 3
    if code == 0:
        nf = 1
    elif code in (1, 2):
        nf = 2
    else:
        nf = packet[1] & 0x3F if len(packet) > 1 else 0
    return OpusToc(mode, bw, dur, bool(toc & 4), nf)


def packet_samples(packet: bytes, rate: int = 48000) -> int:
    t = parse_toc(packet)
    return int(t.frames_per_packet * t.frame_ms * rate / 1000)
