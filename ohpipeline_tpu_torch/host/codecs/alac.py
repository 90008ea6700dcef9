"""ALAC (Apple Lossless) decoder.

Parity target: OpenHome/Media/Codec/AlacAppleBase.cpp (adapter over the
vendored apple_alac reference decoder) — bit-exact decode, validated
against the compiled apple_alac oracle.

Written from the published ALAC format (Apple's open-sourced codec is the
de-facto specification): adaptive-Golomb entropy coding ("dyn" codes with
a 9-zero escape prefix), the sign-adaptive FIR predictor (coefficients
adapt per sample from the error sign), interlaced stereo (mixres/mixbits),
shifted-byte sidebands, and the SCE/CPE element layout.

The predictor's per-sample data-dependent coefficient adaptation is
inherently serial and branchy — the one codec family in this framework
whose core loop stays on the host (C++ port planned; Python reference
implementation here), while output widening/unmixing still batches.

The port's copy of the JAX package's ``codecs/alac.py``, with one change:
``_decode_element`` imports the port's own native helpers
(``from .. import native``), whose loader raises where ``alac_core.cc``
does not build instead of reading as absent.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..core.jiffies import Jiffies
from ..core.streaminfo import PcmStreamInfo
from .base import (CodecBase, CodecStreamCorrupt, DecodedBatch, EndOfStream,
                   StreamReader)

QBSHIFT = 9
QB = 1 << QBSHIFT
MMULSHIFT = 2
MDENSHIFT = QBSHIFT - MMULSHIFT - 1
MOFF = 1 << (MDENSHIFT - 2)
BITOFF = 24
MAX_PREFIX = 9
MAX_DATATYPE_BITS_16 = 16

ID_SCE, ID_CPE, ID_CCE, ID_LFE, ID_DSE, ID_PCE, ID_FIL, ID_END = range(8)


@dataclass(slots=True)
class AlacConfig:
    frame_length: int
    bit_depth: int
    pb: int
    mb: int
    kb: int
    num_channels: int
    max_run: int
    max_frame_bytes: int
    avg_bit_rate: int
    sample_rate: int

    @staticmethod
    def parse(cookie: bytes) -> "AlacConfig":
        # cookie may be wrapped in 'frma'+'alac' atoms or carry the 12-byte
        # atom header (size + 'alac' + version)
        if len(cookie) >= 12 and cookie[4:8] == b"frma":
            cookie = cookie[12:]
        if len(cookie) >= 12 and cookie[4:8] == b"alac":
            cookie = cookie[12:]
        if len(cookie) < 24:
            raise CodecStreamCorrupt("short ALAC magic cookie")
        (frame_length, _compat, bit_depth, pb, mb, kb, channels, max_run,
         max_frame_bytes, avg_bit_rate, rate) = struct.unpack(
            ">IBBBBBBHIII", cookie[:24])
        return AlacConfig(frame_length, bit_depth, pb, mb, kb, channels,
                          max_run, max_frame_bytes, avg_bit_rate, rate)


class _Bits:
    """MSB-first reader over padded bytes (adaptive-Golomb needs 32-bit
    lookahead past the nominal end)."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data + b"\x00" * 8
        self.pos = 0

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        first, last = p >> 3, (p + n - 1) >> 3
        chunk = int.from_bytes(self.data[first:last + 1], "big")
        chunk >>= (last + 1) * 8 - (p + n)
        self.pos = p + n
        return chunk & ((1 << n) - 1)

    def peek32(self) -> int:
        p = self.pos
        first = p >> 3
        v = int.from_bytes(self.data[first:first + 5], "big")
        return (v >> (8 - (p & 7))) & 0xFFFFFFFF


def _lead_zeros32(x: int) -> int:
    return 32 - x.bit_length() if x else 32


def _lg3a(x: int) -> int:
    return 31 - _lead_zeros32(x + 3)


def _dyn_get_32(bits: _Bits, m: int, k: int, maxbits: int) -> int:
    stream = bits.peek32()
    pre = _lead_zeros32(~stream & 0xFFFFFFFF)
    if pre >= MAX_PREFIX:
        bits.pos += MAX_PREFIX
        return bits.read(maxbits)
    bits.pos += pre + 1
    if k == 1:
        return pre
    v = bits.peek32() >> (32 - k)
    bits.pos += k - 1
    result = pre * m
    if v >= 2:
        result += v - 1
        bits.pos += 1
    return result


def _dyn_get_16(bits: _Bits, m: int, k: int) -> int:
    stream = bits.peek32()
    pre = _lead_zeros32(~stream & 0xFFFFFFFF)
    if pre >= MAX_PREFIX:
        bits.pos += MAX_PREFIX
        return bits.read(MAX_DATATYPE_BITS_16)
    bits.pos += pre + 1
    v = bits.peek32() >> (32 - k)
    bits.pos += k
    result = pre * m + v - 1
    if v < 2:
        result -= (v - 1)
        bits.pos -= 1
    return result


def dyn_decomp(bits: _Bits, num: int, chan_bits: int, mb0: int, pb: int,
               kb: int) -> np.ndarray:
    """Adaptive-Golomb residual decode (the 'dyn' code family)."""
    out = np.zeros(num, np.int64)
    mb = mb0
    wb = (1 << kb) - 1
    zmode = 0
    c = 0
    while c < num:
        m = mb >> QBSHIFT
        k = min(_lg3a(m), kb)
        m = (1 << k) - 1
        n = _dyn_get_32(bits, m, k, chan_bits)
        ndecode = n + zmode
        mult = -(ndecode & 1) | 1
        out[c] = ((ndecode + 1) >> 1) * mult
        c += 1
        mb = pb * (n + zmode) + mb - ((pb * mb) >> QBSHIFT)
        if n > 0xFFFF:
            mb = 0xFFFF
        zmode = 0
        if (mb << MMULSHIFT) < QB and c < num:
            zmode = 1
            k = _lead_zeros32(mb) - BITOFF + ((mb + MOFF) >> MDENSHIFT)
            mz = ((1 << k) - 1) & wb
            n = _dyn_get_16(bits, mz, k)
            if c + n > num:
                raise CodecStreamCorrupt("alac zero-run overrun")
            c += n          # out already zero
            if n >= 0xFFFF:
                zmode = 0
            mb = 0
    return out


def unpc_block(resid: np.ndarray, coefs: np.ndarray, numactive: int,
               chan_bits: int, denshift: int) -> np.ndarray:
    """Sign-adaptive FIR prediction synthesis (dp_dec behaviour)."""
    num = len(resid)
    out = np.zeros(num, np.int64)
    shift_mod = 1 << chan_bits
    half = shift_mod >> 1

    def wrap(v: int) -> int:
        return (v + half) % shift_mod - half

    out[0] = resid[0]
    if numactive == 0:
        out[1:] = resid[1:]
        return out
    if numactive == 31:
        prev = int(out[0])
        for j in range(1, num):
            prev = wrap(int(resid[j]) + prev)
            out[j] = prev
        return out
    for j in range(1, numactive + 1):
        out[j] = wrap(int(resid[j]) + int(out[j - 1]))
    lim = numactive + 1
    co = [int(x) for x in coefs[:numactive]]
    denhalf = 1 << (denshift - 1)
    ol = out.tolist()
    rl = resid.tolist()
    for j in range(lim, num):
        top = ol[j - lim]
        base = j - 1
        sum1 = 0
        for k in range(numactive):
            sum1 += co[k] * (ol[base - k] - top)
        del_ = rl[j]
        del0 = del_
        sg = (del_ > 0) - (del_ < 0)
        del_ += top + ((sum1 + denhalf) >> denshift)
        ol[j] = wrap(del_)
        if sg > 0:
            for k in range(numactive - 1, -1, -1):
                dd = top - ol[base - k]
                sgn = (dd > 0) - (dd < 0)
                co[k] -= sgn
                del0 -= (numactive - k) * ((sgn * dd) >> denshift)
                if del0 <= 0:
                    break
        elif sg < 0:
            for k in range(numactive - 1, -1, -1):
                dd = top - ol[base - k]
                sgn = (dd > 0) - (dd < 0)
                co[k] += sgn
                del0 -= (numactive - k) * ((-sgn * dd) >> denshift)
                if del0 >= 0:
                    break
    return np.asarray(ol, np.int64)


def decode_packet(data: bytes, cfg: AlacConfig) -> tuple[np.ndarray, int]:
    """One ALAC packet -> ((channels, n) int32 native range, num_samples)."""
    bits = _Bits(data)
    outputs = []
    num_samples = cfg.frame_length
    while True:
        tag = bits.read(3)
        if tag == ID_END:
            break
        if tag in (ID_SCE, ID_LFE):
            ch, num_samples = _decode_element(bits, cfg, 1)
            outputs.extend(ch)
        elif tag == ID_CPE:
            ch, num_samples = _decode_element(bits, cfg, 2)
            outputs.extend(ch)
        elif tag == ID_FIL:
            cnt = bits.read(4)
            if cnt == 15:
                cnt += bits.read(8) - 1
            bits.pos += cnt * 8
        elif tag == ID_DSE:
            bits.read(4)
            align = bits.read(1)
            cnt = bits.read(8)
            if cnt == 255:
                cnt += bits.read(8)
            if align:
                bits.pos = (bits.pos + 7) & ~7
            bits.pos += cnt * 8
        else:
            raise CodecStreamCorrupt(f"alac element {tag} unsupported")
        if len(outputs) >= cfg.num_channels:
            break
    if not outputs:
        # keep the (pcm, num_samples) shape: a hostile packet opening
        # with ID_END otherwise desyncs `pcm, n = decode_packet(...)`
        # callers (raop.py:314) into unpacking channel rows
        return np.zeros((cfg.num_channels, 0), np.int32), 0
    n = min(len(o) for o in outputs)
    return np.stack([o[:n] for o in outputs]).astype(np.int32), num_samples


def _decode_element(bits: _Bits, cfg: AlacConfig,
                    nch: int) -> tuple[list[np.ndarray], int]:
    bits.read(4)                        # element instance tag
    if bits.read(12) != 0:
        raise CodecStreamCorrupt("alac unused header bits set")
    header = bits.read(4)
    partial = header >> 3
    bytes_shifted = (header >> 1) & 3
    if bytes_shifted == 3:
        raise CodecStreamCorrupt("alac bytesShifted 3")
    escape = header & 1
    chan_bits = cfg.bit_depth - bytes_shifted * 8 + (1 if nch == 2 else 0)
    num = cfg.frame_length
    if partial:
        num = (bits.read(16) << 16) | bits.read(16)
    shift_vals = None
    if not escape:
        mix_bits = bits.read(8)
        mix_res = bits.read(8)
        if mix_res >= 128:
            mix_res -= 256
        params = []
        for _ in range(nch):
            hb = bits.read(8)
            mode = hb >> 4
            denshift = hb & 0xF
            hb = bits.read(8)
            pbf = hb >> 5
            nactive = hb & 0x1F
            coefs = np.array([bits.read(16) for _ in range(nactive)],
                             np.int64)
            coefs = np.where(coefs >= 32768, coefs - 65536, coefs)
            params.append((mode, denshift, pbf, nactive, coefs))
        if bytes_shifted:
            shift_start = bits.pos
            bits.pos += bytes_shifted * 8 * num * nch
        chans = []
        from .. import native as _nat
        use_native = _nat.have_alac_core()
        for c, (mode, denshift, pbf, nactive, coefs) in enumerate(params):
            if use_native:
                try:
                    resid, bits.pos = _nat.alac_dyn_decomp(
                        bits.data, bits.pos, num, chan_bits, cfg.mb,
                        (cfg.pb * pbf) // 4, cfg.kb)
                except ValueError:
                    raise CodecStreamCorrupt("alac zero-run overrun")
                co32 = np.ascontiguousarray(coefs, np.int32)
                if mode == 0:
                    chans.append(_nat.alac_unpc_block(
                        resid, co32, nactive, chan_bits, denshift)
                        .astype(np.int64))
                else:
                    inter = _nat.alac_unpc_block(
                        resid, np.zeros(32, np.int32), 31, chan_bits, 0)
                    chans.append(_nat.alac_unpc_block(
                        inter, co32, nactive, chan_bits, denshift)
                        .astype(np.int64))
                continue
            resid = dyn_decomp(bits, num, chan_bits, cfg.mb,
                               (cfg.pb * pbf) // 4, cfg.kb)
            if mode == 0:
                chans.append(unpc_block(resid, coefs, nactive, chan_bits,
                                        denshift))
            else:
                inter = unpc_block(resid, np.zeros(0, np.int64), 31,
                                   chan_bits, 0)
                chans.append(unpc_block(inter, coefs, nactive, chan_bits,
                                        denshift))
        if bytes_shifted:
            save = bits.pos
            bits.pos = shift_start
            shift_vals = np.array(
                [bits.read(bytes_shifted * 8)
                 for _ in range(num * nch)], np.int64).reshape(num, nch)
            bits.pos = save
    else:
        # escape: verbatim PCM, channel-interleaved per sample
        chan_bits = cfg.bit_depth
        mix_bits = mix_res = 0
        vals = np.array([bits.read(chan_bits) for _ in range(num * nch)],
                        np.int64)
        half = 1 << (chan_bits - 1)
        vals = np.where(vals >= half, vals - 2 * half, vals)
        chans = [vals[c::nch] for c in range(nch)]
        bytes_shifted = 0
    # unmix + shift restore
    if nch == 2:
        u, v = chans
        if mix_res != 0:
            left = u + v - ((mix_res * v) >> mix_bits)
            right = left - v
        else:
            left, right = u, v
        outs = [left, right]
    else:
        outs = [chans[0]]
    if bytes_shifted and shift_vals is not None:
        shift = bytes_shifted * 8
        outs = [(o << shift) | shift_vals[:, i]
                for i, o in enumerate(outs)]
    return outs, num


class CodecAlac(CodecBase):
    """ALAC in MP4 (reference CodecAlacApple)."""

    name = "ALAC"
    recognition_cost = 25
    mime_types = ("audio/m4a", "audio/mp4")

    def __init__(self):
        self._cfg: Optional[AlacConfig] = None
        self._samples = None
        self._index = 0
        self._data = b""
        self._sample_pos = 0

    def recognise(self, header: bytes) -> bool:
        if len(header) < 12 or header[4:8] != b"ftyp":
            return False
        from ..containers.mpeg4 import find_audio_track
        try:
            track = find_audio_track(header)
        except Exception:                                 # noqa: BLE001
            return False
        return track is not None and track.codec == "alac"

    def stream_initialise(self, reader: StreamReader) -> PcmStreamInfo:
        from ..containers.mpeg4 import find_audio_track
        self._data = reader.read(reader.stream_bytes or (1 << 30))
        track = find_audio_track(self._data)
        if track is None or track.codec != "alac":
            raise CodecStreamCorrupt("no alac track")
        self._cfg = AlacConfig.parse(track.codec_config)
        self._samples = list(track.sample_offsets())
        self._index = 0
        self._sample_pos = 0
        self._track = track
        cfg = self._cfg
        return PcmStreamInfo(
            sample_rate=cfg.sample_rate, bit_depth=cfg.bit_depth,
            num_channels=cfg.num_channels, codec_name="ALAC", lossless=True,
            seekable=True, bitrate=cfg.avg_bit_rate,
            track_length_jiffies=track.total_samples * cfg.frame_length
            * Jiffies.per_sample(cfg.sample_rate) if track.stts else 0)

    def process(self, reader: StreamReader) -> DecodedBatch:
        if self._index >= len(self._samples):
            raise EndOfStream
        chunks = []
        done = 0
        while self._index < len(self._samples) and done < 4:
            off, size = self._samples[self._index]
            self._index += 1
            done += 1
            pcm, _n = decode_packet(self._data[off:off + size], self._cfg)
            chunks.append(pcm)
        out = np.concatenate(chunks, axis=1)
        first = self._sample_pos
        self._sample_pos += out.shape[1]
        info = PcmStreamInfo(
            sample_rate=self._cfg.sample_rate, bit_depth=self._cfg.bit_depth,
            num_channels=self._cfg.num_channels, codec_name="ALAC",
            lossless=True, seekable=True)
        return DecodedBatch(info, samples=out, track_offset_samples=first)

    def try_seek(self, sample: int) -> Optional[int]:
        idx, pcm0 = self._track.seek_sample(sample)
        self._index = idx
        self._sample_pos = pcm0
        return 0
