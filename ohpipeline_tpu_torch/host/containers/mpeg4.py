"""MP4 / ISO-BMFF container (reference Codec/Mpeg4.cpp — a full box parser
with SeekTable and fragmented-MP4 support, Mpeg4.h:122-749).

Parses moov box trees into per-track sample tables (stsd codec config,
stts/stsc/stsz/stco/co64), iterates audio samples (AAC access units, ALAC
frames), supports sample-accurate seek via the tables, and handles
fragmented files (moof/tfhd/trun/sidx).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Iterator, Optional

from ..codecs.base import StreamReader
from .base import ContainerBase

CONTAINER_BOXES = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"udta",
                   b"moof", b"traf", b"edts", b"mvex"}


def iter_boxes(data: bytes, start: int = 0,
               end: Optional[int] = None) -> Iterator[tuple[bytes, int, int]]:
    """Yields (type, body_start, body_end) for each box in [start, end)."""
    end = len(data) if end is None else end
    pos = start
    while pos + 8 <= end:
        size = int.from_bytes(data[pos:pos + 4], "big")
        btype = data[pos + 4:pos + 8]
        hdr = 8
        if size == 1:
            size = int.from_bytes(data[pos + 8:pos + 16], "big")
            hdr = 16
        elif size == 0:
            size = end - pos
        if size < hdr or pos + size > end:
            return
        yield btype, pos + hdr, pos + size
        pos += size


def find_box(data: bytes, path: list[bytes], start: int = 0,
             end: Optional[int] = None) -> Optional[tuple[int, int]]:
    for btype, b0, b1 in iter_boxes(data, start, end):
        if btype == path[0]:
            if len(path) == 1:
                return b0, b1
            return find_box(data, path[1:], b0, b1)
    return None


@dataclass(slots=True)
class Mpeg4Track:
    codec: str = ""                 # 'mp4a' (AAC), 'alac', 'fLaC', ...
    track_id: int = 0               # tkhd track_ID (matches moof tfhd)
    channels: int = 0
    sample_rate: int = 0
    bits: int = 16
    codec_config: bytes = b""       # esds ASC / alac magic cookie / dfLa
    timescale: int = 0
    duration: int = 0
    # sample tables
    sample_sizes: list = field(default_factory=list)
    chunk_offsets: list = field(default_factory=list)
    stsc: list = field(default_factory=list)   # (first_chunk, per_chunk, desc)
    stts: list = field(default_factory=list)   # (count, delta)

    @property
    def total_samples(self) -> int:
        return sum(c for c, _ in self.stts)

    def sample_durations(self) -> Iterator[int]:
        for count, delta in self.stts:
            for _ in range(count):
                yield delta

    def sample_offsets(self) -> Iterator[tuple[int, int]]:
        """Yields (byte_offset, byte_size) per sample via stsc/stco/stsz."""
        stsc = self.stsc
        nchunks = len(self.chunk_offsets)
        si = 0
        for ci in range(nchunks):
            per_chunk = 0
            for i, (first, per, _desc) in enumerate(stsc):
                if ci + 1 >= first:
                    per_chunk = per
                else:
                    break
            pos = self.chunk_offsets[ci]
            for _ in range(per_chunk):
                if si >= len(self.sample_sizes):
                    return
                size = self.sample_sizes[si]
                yield pos, size
                pos += size
                si += 1

    def seek_sample(self, pcm_sample: int) -> tuple[int, int]:
        """PCM sample position -> (mp4 sample index, pcm position of its
        first sample) — the reference's SeekTable lookup."""
        acc = 0
        idx = 0
        for count, delta in self.stts:
            if delta and acc + count * delta > pcm_sample:
                n = (pcm_sample - acc) // delta
                return idx + n, acc + n * delta
            acc += count * delta
            idx += count
        return max(0, idx - 1), acc


def _parse_esds(body: bytes) -> bytes:
    """Extract the AudioSpecificConfig from an esds box body."""
    pos = 4   # version+flags
    def read_len(p):
        ln = 0
        for _ in range(4):
            b = body[p]
            p += 1
            ln = (ln << 7) | (b & 0x7F)
            if not b & 0x80:
                break
        return ln, p
    while pos < len(body):
        tag = body[pos]
        ln, p = read_len(pos + 1)
        if tag == 0x03:             # ES_Descriptor
            pos = p + 3             # ES_ID + flags
        elif tag == 0x04:           # DecoderConfigDescriptor
            pos = p + 13            # objectType..avgBitrate
        elif tag == 0x05:           # DecoderSpecificInfo = ASC
            return body[p:p + ln]
        else:
            pos = p + ln
    return b""


def parse_moov(data: bytes, moov_start: int, moov_end: int) -> list[Mpeg4Track]:
    tracks = []
    for btype, b0, b1 in iter_boxes(data, moov_start, moov_end):
        if btype != b"trak":
            continue
        tr = Mpeg4Track()
        tkhd = find_box(data, [b"tkhd"], b0, b1)
        if tkhd:
            ver = data[tkhd[0]]
            tr.track_id = int.from_bytes(
                data[tkhd[0] + (20 if ver == 1 else 12):
                     tkhd[0] + (24 if ver == 1 else 16)], "big")
        mdhd = find_box(data, [b"mdia", b"mdhd"], b0, b1)
        if mdhd:
            ver = data[mdhd[0]]
            if ver == 1:
                tr.timescale, tr.duration = struct.unpack_from(
                    ">IQ", data, mdhd[0] + 20)
            else:
                tr.timescale, tr.duration = struct.unpack_from(
                    ">II", data, mdhd[0] + 12)
        stbl = find_box(data, [b"mdia", b"minf", b"stbl"], b0, b1)
        if not stbl:
            continue
        s0, s1 = stbl
        for sbt, sb0, sb1 in iter_boxes(data, s0, s1):
            if sbt == b"stsd":
                n = int.from_bytes(data[sb0 + 4:sb0 + 8], "big")
                for et, e0, e1 in iter_boxes(data, sb0 + 8, sb1):
                    tr.codec = et.decode("latin1")
                    # SampleEntry: 6 reserved + 2 data_ref, AudioSampleEntry:
                    # 8 reserved, channels(2), bits(2), 4, rate(4, 16.16)
                    tr.channels = int.from_bytes(data[e0 + 16:e0 + 18], "big")
                    tr.bits = int.from_bytes(data[e0 + 18:e0 + 20], "big")
                    tr.sample_rate = int.from_bytes(
                        data[e0 + 24:e0 + 26], "big")
                    for ct, c0, c1 in iter_boxes(data, e0 + 28, e1):
                        if ct == b"esds":
                            tr.codec_config = _parse_esds(data[c0:c1])
                        elif ct in (b"alac", b"dfLa", b"wave", b"dOps"):
                            # dOps: OpusSpecificBox (opus-in-isobmff 4.3.2)
                            tr.codec_config = data[c0:c1]
                    break
            elif sbt == b"stts":
                cnt = int.from_bytes(data[sb0 + 4:sb0 + 8], "big")
                for i in range(cnt):
                    c, d = struct.unpack_from(">II", data, sb0 + 8 + i * 8)
                    tr.stts.append((c, d))
            elif sbt == b"stsc":
                cnt = int.from_bytes(data[sb0 + 4:sb0 + 8], "big")
                for i in range(cnt):
                    f, p, d = struct.unpack_from(">III", data,
                                                 sb0 + 8 + i * 12)
                    tr.stsc.append((f, p, d))
            elif sbt == b"stsz":
                fixed = int.from_bytes(data[sb0 + 4:sb0 + 8], "big")
                cnt = int.from_bytes(data[sb0 + 8:sb0 + 12], "big")
                if fixed:
                    tr.sample_sizes = [fixed] * cnt
                else:
                    tr.sample_sizes = list(struct.unpack_from(
                        f">{cnt}I", data, sb0 + 12))
            elif sbt == b"stco":
                cnt = int.from_bytes(data[sb0 + 4:sb0 + 8], "big")
                tr.chunk_offsets = list(struct.unpack_from(
                    f">{cnt}I", data, sb0 + 8))
            elif sbt == b"co64":
                cnt = int.from_bytes(data[sb0 + 4:sb0 + 8], "big")
                tr.chunk_offsets = list(struct.unpack_from(
                    f">{cnt}Q", data, sb0 + 8))
        tracks.append(tr)
    return tracks


@dataclass(slots=True)
class Fragment:
    """One moof's sample run (fragmented MP4, reference Mpeg4.cpp moof
    handling)."""
    data_offset: int
    sizes: list
    track_id: int = 0               # tfhd track_ID


def parse_moof(data: bytes, moof_start: int, moof_end: int,
               moof_file_pos: int, default_size: int = 0) -> list[Fragment]:
    frags = []
    for btype, b0, b1 in iter_boxes(data, moof_start, moof_end):
        if btype != b"traf":
            continue
        base = moof_file_pos
        tfhd = find_box(data, [b"tfhd"], b0, b1)
        dsize = default_size
        tid = 0
        if tfhd:
            flags = int.from_bytes(data[tfhd[0] + 1:tfhd[0] + 4], "big")
            tid = int.from_bytes(data[tfhd[0] + 4:tfhd[0] + 8], "big")
            p = tfhd[0] + 8
            if flags & 0x01:
                base = struct.unpack_from(">Q", data, p)[0]
                p += 8
            if flags & 0x02:
                p += 4
            if flags & 0x08:
                p += 4
            if flags & 0x10:
                dsize = struct.unpack_from(">I", data, p)[0]
        trun = find_box(data, [b"trun"], b0, b1)
        if not trun:
            continue
        flags = int.from_bytes(data[trun[0] + 1:trun[0] + 4], "big")
        count = struct.unpack_from(">I", data, trun[0] + 4)[0]
        p = trun[0] + 8
        offset = base
        if flags & 0x01:
            offset = moof_file_pos + struct.unpack_from(">i", data, p)[0]
            p += 4
        if flags & 0x04:
            p += 4
        sizes = []
        for _ in range(count):
            if flags & 0x100:
                p += 4
            if flags & 0x200:
                sizes.append(struct.unpack_from(">I", data, p)[0])
                p += 4
            else:
                sizes.append(dsize)
            if flags & 0x400:
                p += 4
            if flags & 0x800:
                p += 4
        frags.append(Fragment(offset, sizes, tid))
    return frags


class ContainerMpeg4(ContainerBase):
    """Recognition-side MP4 sniffer; the codecs (AAC-MP4, ALAC) drive the
    box parser directly for sample iteration."""

    name = "MP4"

    def __init__(self):
        self.metadata = {}

    def recognise(self, header: bytes) -> bool:
        return len(header) >= 8 and header[4:8] == b"ftyp"

    def wrap(self, reader: StreamReader) -> StreamReader:
        return reader   # codecs consume MP4 structure themselves


def write_m4a(samples: list[bytes], codec_config: bytes, sample_rate: int,
              channels: int, codec: str = "mp4a",
              samples_per_frame: int = 1024) -> bytes:
    """Minimal M4A muxer (tests + encode capability): one audio track,
    one chunk, fixed frame duration."""
    import struct as _s

    def box(t: bytes, body: bytes) -> bytes:
        return _s.pack(">I4s", len(body) + 8, t) + body

    if codec == "mp4a":
        dsi = bytes([0x05, len(codec_config)]) + codec_config
        dcd = bytes([0x04, 13 + len(dsi), 0x40, 0x15]) + b"\x00" * 11 + dsi
        esd = bytes([0x03, 3 + len(dcd)]) + b"\x00\x00\x00" + dcd
        cfg = box(b"esds", b"\x00\x00\x00\x00" + esd)
    elif codec == "Opus":
        cfg = box(b"dOps", codec_config)
    else:
        cfg = box(codec.encode(), codec_config)
    entry = box(codec.encode() if codec != "mp4a" else b"mp4a",
                b"\x00" * 6 + b"\x00\x01" + b"\x00" * 8
                + _s.pack(">HH", channels, 16) + b"\x00" * 4
                + _s.pack(">HH", sample_rate, 0) + cfg)
    stsd = box(b"stsd", b"\x00" * 4 + _s.pack(">I", 1) + entry)
    n = len(samples)
    stts = box(b"stts", _s.pack(">II", 0, 1)
               + _s.pack(">II", n, samples_per_frame))
    stsc = box(b"stsc", _s.pack(">II", 0, 1) + _s.pack(">III", 1, n, 1))
    stsz = box(b"stsz", _s.pack(">III", 0, 0, n)
               + b"".join(_s.pack(">I", len(s)) for s in samples))
    ftyp = box(b"ftyp", b"M4A \x00\x00\x00\x00M4A mp42")
    # compute mdat offset: ftyp + moov sizes; stco written last
    payload = b"".join(samples)

    def make_moov(chunk_off: int) -> bytes:
        stco = box(b"stco", _s.pack(">II", 0, 1) + _s.pack(">I", chunk_off))
        stbl = box(b"stbl", stsd + stts + stsc + stsz + stco)
        mdhd = box(b"mdhd", _s.pack(">IIIII", 0, 0, 0, sample_rate,
                                    n * samples_per_frame) + b"\x00" * 4)
        hdlr = box(b"hdlr", b"\x00" * 8 + b"soun" + b"\x00" * 12 + b"\x00")
        minf = box(b"minf", box(b"smhd", b"\x00" * 8)
                   + box(b"dinf", box(b"dref", b"\x00" * 4
                                      + _s.pack(">I", 1)
                                      + box(b"url ", b"\x00\x00\x00\x01")))
                   + stbl)
        mdia = box(b"mdia", mdhd + hdlr + minf)
        tkhd = box(b"tkhd", _s.pack(">II", 7, 0) + b"\x00" * 72)
        trak = box(b"trak", tkhd + mdia)
        mvhd = box(b"mvhd", _s.pack(">IIIII", 0, 0, 0, sample_rate,
                                    n * samples_per_frame) + b"\x00" * 80)
        return box(b"moov", mvhd + trak)

    guess = len(ftyp) + len(make_moov(0)) + 8
    moov = make_moov(guess)
    assert len(ftyp) + len(moov) + 8 == guess
    return ftyp + moov + box(b"mdat", payload)


def write_fragmented_m4a(fragments: list[list[bytes]], codec_config: bytes,
                         sample_rate: int, channels: int,
                         codec: str = "Opus",
                         samples_per_frame: int = 960) -> bytes:
    """Minimal fragmented-MP4 muxer (tests): an init segment (ftyp +
    moov with empty sample tables + mvex) followed by one moof+mdat per
    fragment — the dOps/DASH shape the reference's CodecOpus consumes
    (Codec/Opus.cpp:94-98)."""
    import struct as _s

    def box(t: bytes, body: bytes) -> bytes:
        return _s.pack(">I4s", len(body) + 8, t) + body

    if codec == "mp4a":
        dsi = bytes([0x05, len(codec_config)]) + codec_config
        dcd = bytes([0x04, 13 + len(dsi), 0x40, 0x15]) + b"\x00" * 11 + dsi
        esd = bytes([0x03, 3 + len(dcd)]) + b"\x00\x00\x00" + dcd
        cfg = box(b"esds", b"\x00\x00\x00\x00" + esd)
    elif codec == "Opus":
        cfg = box(b"dOps", codec_config)
    else:
        cfg = box(codec.encode(), codec_config)
    entry = box(codec.encode() if codec != "mp4a" else b"mp4a",
                b"\x00" * 6 + b"\x00\x01" + b"\x00" * 8
                + _s.pack(">HH", channels, 16) + b"\x00" * 4
                + _s.pack(">HH", sample_rate, 0) + cfg)
    stsd = box(b"stsd", b"\x00" * 4 + _s.pack(">I", 1) + entry)
    stbl = box(b"stbl", stsd + box(b"stts", b"\x00" * 8)
               + box(b"stsc", b"\x00" * 8)
               + box(b"stsz", b"\x00" * 12) + box(b"stco", b"\x00" * 8))
    n_total = sum(len(f) for f in fragments)
    mdhd = box(b"mdhd", _s.pack(">IIIII", 0, 0, 0, sample_rate,
                                n_total * samples_per_frame) + b"\x00" * 4)
    hdlr = box(b"hdlr", b"\x00" * 8 + b"soun" + b"\x00" * 12 + b"\x00")
    minf = box(b"minf", box(b"smhd", b"\x00" * 8)
               + box(b"dinf", box(b"dref", b"\x00" * 4 + _s.pack(">I", 1)
                                  + box(b"url ", b"\x00\x00\x00\x01")))
               + stbl)
    mdia = box(b"mdia", mdhd + hdlr + minf)
    tkhd = box(b"tkhd", _s.pack(">IIII", 7, 0, 0, 1) + b"\x00" * 64)
    trak = box(b"trak", tkhd + mdia)
    mvhd = box(b"mvhd", _s.pack(">IIIII", 0, 0, 0, sample_rate,
                                n_total * samples_per_frame) + b"\x00" * 80)
    trex = box(b"trex", _s.pack(">IIIIII", 0, 1, 1,
                                samples_per_frame, 0, 0))
    moov = box(b"moov", mvhd + trak + box(b"mvex", trex))
    ftyp = box(b"ftyp", b"iso5\x00\x00\x00\x01iso5dash")
    out = [ftyp, moov]
    for samples in fragments:
        # trun flags: data-offset (0x01) + sample-size (0x200)
        trun_body = _s.pack(">II", 0x000201, len(samples))
        payload = b"".join(samples)
        sizes = b"".join(_s.pack(">I", len(s)) for s in samples)
        tfhd = box(b"tfhd", _s.pack(">II", 0, 1))   # track 1, no flags
        # data offset = moof header .. mdat body; trun body is
        # 8 (box hdr) + 8 (flags+count) + 4 (offset) + sizes
        trun_sz = 8 + 8 + 4 + len(sizes)
        traf_sz = 8 + len(tfhd) + trun_sz
        moof_sz = 8 + 16 + traf_sz                  # mfhd is 16
        data_off = moof_sz + 8                      # past mdat header
        trun = box(b"trun", trun_body + _s.pack(">i", data_off) + sizes)
        traf = box(b"traf", tfhd + trun)
        mfhd = box(b"mfhd", _s.pack(">II", 0, 1))
        moof = box(b"moof", mfhd + traf)
        assert len(moof) == moof_sz
        out.append(moof)
        out.append(box(b"mdat", payload))
    return b"".join(out)


def find_audio_track(data: bytes) -> Optional[Mpeg4Track]:
    moov = find_box(data, [b"moov"])
    if moov is None:
        return None
    tracks = parse_moov(data, moov[0], moov[1])
    for t in tracks:
        if t.codec in ("mp4a", "alac", "fLaC", "Opus") and t.sample_rate:
            return t
    return tracks[0] if tracks else None


def iter_fragment_samples(data: bytes,
                          track_id: int = 0) -> Iterator[tuple[int, int]]:
    """Yield (offset, size) for every sample carried in moof fragments
    (fragmented MP4 / DASH media segments, reference Mpeg4.cpp moof +
    SampleSizeTable re-read per fragment — Codec/Opus.cpp:264-281).
    With ``track_id`` set, only that track's trafs contribute (multi-
    track muxes interleave e.g. video runs)."""
    pos = 0
    end = len(data)
    while pos + 8 <= end:
        size = int.from_bytes(data[pos:pos + 4], "big")
        btype = data[pos + 4:pos + 8]
        hdr = 8
        if size == 1:
            size = int.from_bytes(data[pos + 8:pos + 16], "big")
            hdr = 16
        elif size == 0:
            size = end - pos
        if size < hdr or pos + size > end:
            return
        if btype == b"moof":
            for frag in parse_moof(data, pos + hdr, pos + size, pos):
                if track_id and frag.track_id != track_id:
                    continue
                off = frag.data_offset
                for sz in frag.sizes:
                    yield off, sz
                    off += sz
        pos += size
