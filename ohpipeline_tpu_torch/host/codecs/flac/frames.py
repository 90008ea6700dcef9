"""FLAC stream/frame parsing: host entropy decode to dense batch arrays.

Splits FLAC decoding the TPU-first way: everything bit-serial (headers, Rice
residuals, LPC coefficients) is unpacked here on the host into fixed-layout
int32 arrays; the arithmetic-heavy reconstruction (LPC recurrence, stereo
decorrelation, wasted-bit shifts) runs batched on device (ops.lpc, ops.pcm).

Behavioural parity: flac-1.2.1 stream_decoder.c frame/subframe read path as
driven by the reference's adapter (OpenHome/Media/Codec/Flac.cpp).  Output
is bit-exact vs libFLAC by construction (validated in tests against the
arbitrary-precision oracle and the compiled reference decoder).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .bitreader import BitReader, crc8, crc16

SYNC = 0b11111111111110

BLOCKSIZE_TABLE = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                   8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                   13: 8192, 14: 16384, 15: 32768}
RATE_TABLE = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
              7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000}
SAMPLE_SIZE_TABLE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}

# Channel assignment -> ops.pcm decorrelation codes
ASSIGN_INDEPENDENT = 0   # 1..8 independent channels
ASSIGN_LEFT_SIDE = 8
ASSIGN_RIGHT_SIDE = 9
ASSIGN_MID_SIDE = 10

FIXED_COEFFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


class FlacError(Exception):
    pass


@dataclass(slots=True)
class StreamInfo:
    min_blocksize: int
    max_blocksize: int
    min_framesize: int
    max_framesize: int
    sample_rate: int
    channels: int
    bits_per_sample: int
    total_samples: int
    md5: bytes


@dataclass(slots=True)
class Metadata:
    streaminfo: StreamInfo
    vorbis_comments: dict = field(default_factory=dict)
    seek_points: list = field(default_factory=list)   # (sample, byte_offset, nsamples)
    header_bytes: int = 0


def parse_metadata(data: bytes) -> Metadata:
    """Parse 'fLaC' marker + metadata blocks; returns offsets into frames."""
    if data[:4] != b"fLaC":
        raise FlacError("missing fLaC marker")
    pos = 4
    si = None
    meta = None
    while True:
        if pos + 4 > len(data):
            raise FlacError("truncated metadata")
        hdr = data[pos]
        last, btype = hdr >> 7, hdr & 0x7F
        size = int.from_bytes(data[pos + 1:pos + 4], "big")
        body = data[pos + 4:pos + 4 + size]
        pos += 4 + size
        if btype == 0:   # STREAMINFO
            br = BitReader(body)
            si = StreamInfo(
                min_blocksize=br.read(16), max_blocksize=br.read(16),
                min_framesize=br.read(24), max_framesize=br.read(24),
                sample_rate=br.read(20), channels=br.read(3) + 1,
                bits_per_sample=br.read(5) + 1, total_samples=br.read(36),
                md5=body[18:34])
            meta = Metadata(streaminfo=si)
        elif btype == 3 and meta is not None:  # SEEKTABLE
            for i in range(size // 18):
                s, off, n = struct.unpack(">QQH", body[i * 18:(i + 1) * 18])
                if s != 0xFFFFFFFFFFFFFFFF:   # placeholder points skipped
                    meta.seek_points.append((s, off, n))
        elif btype == 4 and meta is not None:  # VORBIS_COMMENT
            try:
                vlen = struct.unpack("<I", body[:4])[0]
                p = 4 + vlen
                count = struct.unpack("<I", body[p:p + 4])[0]
                p += 4
                for _ in range(count):
                    clen = struct.unpack("<I", body[p:p + 4])[0]
                    p += 4
                    item = body[p:p + clen].decode("utf-8", "replace")
                    p += clen
                    if "=" in item:
                        k, v = item.split("=", 1)
                        meta.vorbis_comments[k.upper()] = v
            except (struct.error, IndexError):
                pass
        if last:
            break
    if si is None:
        raise FlacError("no STREAMINFO")
    meta.header_bytes = pos
    return meta


@dataclass(slots=True)
class FrameHeader:
    blocksize: int
    sample_rate: int
    channels: int
    assignment: int          # raw 4-bit channel assignment code
    bits_per_sample: int
    sample_number: int       # first sample of the frame
    header_end_bits: int


def parse_frame_header(br: BitReader, si: StreamInfo) -> FrameHeader:
    start_byte = br.pos >> 3
    if br.read(14) != SYNC:
        raise FlacError("lost frame sync")
    br.read(1)  # reserved
    variable = br.read(1)
    bs_code = br.read(4)
    sr_code = br.read(4)
    assign = br.read(4)
    ss_code = br.read(3)
    br.read(1)  # reserved
    coded = br.read_utf8_coded()
    if bs_code == 0:
        raise FlacError("reserved blocksize code")
    elif bs_code == 6:
        blocksize = br.read(8) + 1
    elif bs_code == 7:
        blocksize = br.read(16) + 1
    else:
        blocksize = BLOCKSIZE_TABLE[bs_code]
    if sr_code == 0:
        rate = si.sample_rate
    elif sr_code == 12:
        rate = br.read(8) * 1000
    elif sr_code == 13:
        rate = br.read(16)
    elif sr_code == 14:
        rate = br.read(16) * 10
    elif sr_code == 15:
        raise FlacError("invalid sample rate code")
    else:
        rate = RATE_TABLE[sr_code]
    if assign <= 7:
        channels = assign + 1
    elif assign <= 10:
        channels = 2
    else:
        raise FlacError("reserved channel assignment")
    bps = si.bits_per_sample if ss_code == 0 else SAMPLE_SIZE_TABLE.get(ss_code)
    if bps is None:
        raise FlacError("reserved sample size")
    end_byte = br.pos >> 3
    expect_crc = br.read(8)
    got = crc8(br.data[start_byte:end_byte])
    if got != expect_crc:
        raise FlacError(f"frame header CRC mismatch ({got:#x}!={expect_crc:#x})")
    sample_number = coded * si.max_blocksize if not variable else coded
    return FrameHeader(blocksize, rate, channels, assign, bps, sample_number,
                       br.pos)


@dataclass(slots=True)
class Subframe:
    """One channel's worth of one frame, entropy-decoded, pre-synthesis."""
    order: int               # 0 for constant/verbatim
    coeffs: np.ndarray       # (order,) int32, c[0] multiplies s[n-1]
    shift: int
    wasted_bits: int
    data: np.ndarray         # (blocksize,) int32: warmup+residuals (or samples)


def _read_residuals(br: BitReader, blocksize: int, order: int,
                    out: np.ndarray) -> None:
    method = br.read(2)
    if method > 1:
        raise FlacError("reserved residual coding method")
    plen = 4 + method
    escape = (1 << plen) - 1
    porder = br.read(4)
    npart = 1 << porder
    if blocksize % npart or (blocksize >> porder) < order:
        raise FlacError("bad partition order")
    idx = order
    for p in range(npart):
        n = (blocksize >> porder) - (order if p == 0 else 0)
        param = br.read(plen)
        if param == escape:
            raw = br.read(5)
            if raw:
                for i in range(n):
                    out[idx + i] = br.read_signed(raw)
            else:
                out[idx:idx + n] = 0
        else:
            rr = br.read_rice
            for i in range(n):
                out[idx + i] = rr(param)
        idx += n


def parse_subframe(br: BitReader, blocksize: int, bps: int) -> Subframe:
    if br.read(1):
        raise FlacError("bad subframe padding bit")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.read_unary()
    bps -= wasted
    data = np.zeros(blocksize, np.int32)
    if stype == 0:          # CONSTANT
        data[:] = br.read_signed(bps)
        return Subframe(0, np.zeros(0, np.int32), 0, wasted, data)
    if stype == 1:          # VERBATIM
        for i in range(blocksize):
            data[i] = br.read_signed(bps)
        return Subframe(0, np.zeros(0, np.int32), 0, wasted, data)
    if 8 <= stype <= 12:    # FIXED, order 0-4
        order = stype & 7
        for i in range(order):
            data[i] = br.read_signed(bps)
        _read_residuals(br, blocksize, order, data)
        coeffs = np.array(FIXED_COEFFS[order], np.int32)
        return Subframe(order, coeffs, 0, wasted, data)
    if stype >= 32:         # LPC
        order = (stype & 31) + 1
        for i in range(order):
            data[i] = br.read_signed(bps)
        precision = br.read(4) + 1
        if precision == 16:
            raise FlacError("invalid qlp precision")
        shift = br.read_signed(5)
        if shift < 0:
            raise FlacError("negative qlp shift")
        coeffs = np.array([br.read_signed(precision) for _ in range(order)],
                          np.int32)
        _read_residuals(br, blocksize, order, data)
        return Subframe(order, coeffs, shift, wasted, data)
    raise FlacError(f"reserved subframe type {stype}")


@dataclass(slots=True)
class Frame:
    header: FrameHeader
    subframes: list[Subframe]
    start_byte: int
    end_byte: int


def parse_frame(br: BitReader, si: StreamInfo,
                check_crc: bool = True) -> Frame:
    start_byte = br.pos >> 3
    hdr = parse_frame_header(br, si)
    subs = []
    for ch in range(hdr.channels):
        bps = hdr.bits_per_sample
        # side channels carry one extra bit (FLAC spec §frame)
        if (hdr.assignment == ASSIGN_LEFT_SIDE and ch == 1) \
                or (hdr.assignment == ASSIGN_RIGHT_SIDE and ch == 0) \
                or (hdr.assignment == ASSIGN_MID_SIDE and ch == 1):
            bps += 1
        subs.append(parse_subframe(br, hdr.blocksize, bps))
    br.align_byte()
    end_byte = br.pos >> 3
    expect = br.read(16)
    if check_crc and crc16(br.data[start_byte:end_byte]) != expect:
        raise FlacError("frame CRC16 mismatch")
    return Frame(hdr, subs, start_byte, (br.pos >> 3))


def resync(data: bytes, byte_pos: int, si: StreamInfo) -> Optional[int]:
    """Scan forward for the next plausible frame header (lost-sync
    recovery; stream_decoder.c does the same two-byte scan)."""
    i = byte_pos
    while i + 2 < len(data):
        if data[i] == 0xFF and (data[i + 1] & 0xFC) == 0xF8:
            try:
                parse_frame_header(BitReader(data, i * 8), si)
                return i
            except (FlacError, ValueError, EOFError):
                pass
        i += 1
    return None
