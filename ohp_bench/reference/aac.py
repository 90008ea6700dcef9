"""Plain float64 NumPy AAC-LC decoder: the benchmark's reference for ADTS
AAC-LC.

Frozen copies, made at commit 15c54f8 of this repository, of:

- the ADTS and raw_data_block parse of
  ``ohpipeline_tpu_torch/host/codecs/aac/bitstream.py`` (whole, but for
  the types it needs only as annotations), with the bit reader of
  ``host/codecs/flac/bitreader.py`` (``read``, ``peek_bits``, ``skip``,
  ``align_byte``) and the tables of ``host/codecs/aac/tables.py``, whose
  ``tables.npz`` is copied beside this file as ``aac_tables.npz``;
- from ``ohpipeline_tpu_torch/codecs/aac/synthesis.py``: the windows
  (``_sine_window``, ``_kbd_window``, ``window_bank``), the IMDCT operator
  (``_imdct_matrix``), the band layout (``_layout``), the PNS noise
  (``_pns_noise``), the dequantisation, PNS, M/S and intensity of
  ``prepare_group`` for one frame, and the TNS filter ``apply_tns``.

Edits: nothing is rounded to float32 (the operators, windows and spectra
stay float64); ``prepare_group``'s per-row loops run for one frame's
channels (:func:`frame_spectra`); the IMDCT, windowing and overlap-add are
written out for one channel (:func:`synthesise`); PNS noise takes its row
seed from the caller (:func:`decode_stream`), since the port seeds it by a
row number that depends on how a call groups the frames.

It imports nothing of the port and takes nothing the port made: it parses
the ADTS bytes itself.
"""

from __future__ import annotations

import functools
import pathlib
from typing import Callable, Optional

import numpy as np

# ---------------------------------------------------------------------------
# tables (host/codecs/aac/tables.py)
# ---------------------------------------------------------------------------

_NPZ = np.load(pathlib.Path(__file__).resolve().parent / "aac_tables.npz")

SAMPLE_RATES = (96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
                16000, 12000, 11025, 8000, 7350)
ESC_CB = 11
NOISE_CB = 13            # PNS
INTENSITY_CB2 = 14       # out of phase
INTENSITY_CB = 15
SF_OFFSET = 100

ONLY_LONG, LONG_START, EIGHT_SHORT, LONG_STOP = 0, 1, 2, 3
ID_SCE, ID_CPE, ID_CCE, ID_LFE, ID_DSE, ID_PCE, ID_FIL, ID_END = range(8)


class AacError(Exception):
    pass


class BitReader:
    """MSB-first bit fields out of a bytes object."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes, bit_pos: int = 0):
        self.data = data
        self.pos = bit_pos

    def read(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        pos = self.pos
        end = pos + nbits
        if end > len(self.data) * 8:
            raise EOFError("bitstream exhausted")
        first, last = pos >> 3, (end - 1) >> 3
        chunk = int.from_bytes(self.data[first:last + 1], "big")
        chunk >>= (last + 1) * 8 - end
        self.pos = end
        return chunk & ((1 << nbits) - 1)

    def align_byte(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def peek_bits(self, nbits: int) -> int:
        pos = self.pos
        avail = len(self.data) * 8 - pos
        if avail >= nbits:
            v = self.read(nbits)
            self.pos = pos
            return v
        if avail <= 0:
            return 0
        v = self.read(avail)
        self.pos = pos
        return v << (nbits - avail)

    def skip(self, nbits: int) -> None:
        self.pos += nbits


class HuffLut:
    """Single-level Huffman LUT: peek ``maxlen`` bits, the table gives
    (length, value-row-index)."""

    __slots__ = ("maxlen", "lengths", "values", "vals")

    def __init__(self, codes, lens, vals):
        self.maxlen = int(lens.max())
        size = 1 << self.maxlen
        self.lengths = np.zeros(size, np.uint8)
        self.values = np.zeros(size, np.int32)
        self.vals = vals
        for i, (c, l) in enumerate(zip(codes, lens)):
            shift = self.maxlen - int(l)
            base = int(c) << shift
            self.lengths[base:base + (1 << shift)] = l
            self.values[base:base + (1 << shift)] = i

    def decode(self, br) -> np.ndarray:
        window = br.peek_bits(self.maxlen)
        length = self.lengths[window]
        if length == 0:
            raise ValueError("bad Huffman code")
        br.skip(int(length))
        return self.vals[self.values[window]]


def _lut(prefix: str) -> HuffLut:
    return HuffLut(_NPZ[f"{prefix}_codes"], _NPZ[f"{prefix}_lens"],
                   _NPZ[f"{prefix}_vals"])


SPECTRAL_LUTS = {cb: _lut(f"cb{cb}") for cb in range(1, 12)}
CB_DIM = {cb: int(_NPZ[f"cb{cb}_dim"]) for cb in range(1, 12)}
CB_UNSIGNED = {cb: cb in (3, 4, 7, 8, 9, 10, 11) for cb in range(1, 12)}
SCL_LUT = HuffLut(_NPZ["scl_codes"], _NPZ["scl_lens"],
                  _NPZ["scl_vals"].reshape(-1, 1))
SFB_LONG = _NPZ["sfb_index_long"]
SFB_SHORT = _NPZ["sfb_index_short"]
SFB_COUNTS = _NPZ["sfb_counts"]


def sfb_offsets(rate_index: int, short: bool) -> np.ndarray:
    nl, ns = SFB_COUNTS[rate_index]
    if short:
        return SFB_SHORT[rate_index][: ns + 1]
    return SFB_LONG[rate_index][: nl + 1]


# ---------------------------------------------------------------------------
# parse (host/codecs/aac/bitstream.py)
# ---------------------------------------------------------------------------

class AdtsHeader:
    __slots__ = ("rate_index", "channels", "frame_bytes", "header_bytes",
                 "profile")

    def __init__(self, rate_index, channels, frame_bytes, header_bytes,
                 profile):
        self.rate_index = rate_index
        self.channels = channels
        self.frame_bytes = frame_bytes
        self.header_bytes = header_bytes
        self.profile = profile


def parse_adts_header(data: bytes, pos: int = 0) -> Optional[AdtsHeader]:
    if pos + 7 > len(data):
        return None
    if data[pos] != 0xFF or (data[pos + 1] & 0xF6) != 0xF0:
        return None
    protection_absent = data[pos + 1] & 1
    profile = (data[pos + 2] >> 6) & 3
    rate_index = (data[pos + 2] >> 2) & 0xF
    channels = ((data[pos + 2] & 1) << 2) | (data[pos + 3] >> 6)
    frame_bytes = ((data[pos + 3] & 0x03) << 11) | (data[pos + 4] << 3) \
        | (data[pos + 5] >> 5)
    header_bytes = 7 if protection_absent else 9
    if rate_index >= len(SAMPLE_RATES) or frame_bytes < header_bytes:
        return None
    return AdtsHeader(rate_index, channels, frame_bytes, header_bytes,
                      profile)


class IcsInfo:
    __slots__ = ("window_sequence", "window_shape", "max_sfb",
                 "scale_factor_grouping")

    def __init__(self):
        self.window_sequence = ONLY_LONG
        self.window_shape = 0
        self.max_sfb = 0
        self.scale_factor_grouping = 0

    @property
    def short(self) -> bool:
        return self.window_sequence == EIGHT_SHORT

    @property
    def num_windows(self) -> int:
        return 8 if self.short else 1

    def window_groups(self) -> list[int]:
        if not self.short:
            return [1]
        groups = [1]
        for b in range(6, -1, -1):
            if (self.scale_factor_grouping >> b) & 1:
                groups[-1] += 1
            else:
                groups.append(1)
        return groups


class ChannelData:
    __slots__ = ("ics", "global_gain", "band_cb", "scalefactors", "quant",
                 "tns")

    def __init__(self):
        self.ics = IcsInfo()
        self.global_gain = 0
        self.band_cb = None
        self.scalefactors = None
        self.quant = None
        self.tns = None          # per window: [(length, order, dir, coeffs)]


class FrameData:
    __slots__ = ("channels", "ms_mask", "rate_index")

    def __init__(self, channels, ms_mask, rate_index):
        self.channels = channels
        self.ms_mask = ms_mask
        self.rate_index = rate_index


def _parse_ics_info(br: BitReader) -> IcsInfo:
    ics = IcsInfo()
    br.read(1)                        # ics_reserved
    ics.window_sequence = br.read(2)
    ics.window_shape = br.read(1)
    if ics.short:
        ics.max_sfb = br.read(4)
        ics.scale_factor_grouping = br.read(7)
    else:
        ics.max_sfb = br.read(6)
        if br.read(1):                # predictor_data_present
            raise AacError("MAIN-profile prediction not supported in LC")
    return ics


def _parse_section_data(br: BitReader, ics: IcsInfo) -> np.ndarray:
    ngroups = len(ics.window_groups())
    bits = 3 if ics.short else 5
    esc = (1 << bits) - 1
    cb = np.zeros((ngroups, max(ics.max_sfb, 1)), np.int8)
    for g in range(ngroups):
        k = 0
        while k < ics.max_sfb:
            sect_cb = br.read(4)
            length = 0
            while True:
                incr = br.read(bits)
                length += incr
                if incr != esc:
                    break
            cb[g, k:k + length] = sect_cb
            k += length
        if k > ics.max_sfb:
            raise AacError("section overrun")
    return cb


def _parse_scale_factors(br: BitReader, ics: IcsInfo, cb: np.ndarray,
                         global_gain: int) -> np.ndarray:
    ngroups = cb.shape[0]
    sf = np.zeros_like(cb, dtype=np.int32)
    sf_val = global_gain
    is_pos = 0
    noise_energy = global_gain - 90
    noise_pcm_seen = False
    for g in range(ngroups):
        for k in range(ics.max_sfb):
            c = cb[g, k]
            if c == 0:
                sf[g, k] = 0
            elif c in (INTENSITY_CB, INTENSITY_CB2):
                is_pos += int(SCL_LUT.decode(br)[0])
                sf[g, k] = is_pos
            elif c == NOISE_CB:
                if not noise_pcm_seen:
                    noise_pcm_seen = True
                    noise_energy += br.read(9) - 256
                else:
                    noise_energy += int(SCL_LUT.decode(br)[0])
                sf[g, k] = noise_energy
            else:
                sf_val += int(SCL_LUT.decode(br)[0])
                if not 0 <= sf_val < 256:
                    raise AacError("scalefactor out of range")
                sf[g, k] = sf_val
    return sf


def _parse_tns(br: BitReader, ics: IcsInfo) -> list:
    tns = []
    for _ in range(ics.num_windows):
        filters = []
        n_filt = br.read(1 if ics.short else 2)
        if n_filt:
            coef_res = br.read(1)
        for _ in range(n_filt):
            length = br.read(4 if ics.short else 6)
            order = br.read(3 if ics.short else 5)
            direction = compress = 0
            coeffs = []
            if order:
                direction = br.read(1)
                compress = br.read(1)
                bits = (coef_res + 3) - compress
                for _ in range(order):
                    coeffs.append(br.read(bits))
                coeffs = _tns_decode_coeffs(coeffs, coef_res, compress)
            filters.append((length, order, direction, coeffs))
        tns.append(filters)
    return tns


def _tns_decode_coeffs(raw: list[int], coef_res: int,
                       compress: int) -> np.ndarray:
    bits = (coef_res + 3) - compress
    vals = np.array(raw, np.int32)
    half = 1 << (bits - 1)
    vals = np.where(vals >= half, vals - (1 << bits), vals)
    iqfac = ((1 << (coef_res + 2)) - 0.5) / (np.pi / 2.0)
    iqfac_m = ((1 << (coef_res + 2)) + 0.5) / (np.pi / 2.0)
    # float32 storage, as the bitstream carries the coefficients to both of
    # the port's parse paths
    return np.sin(vals / np.where(vals >= 0, iqfac, iqfac_m)) \
        .astype(np.float32)


def _parse_spectral(br: BitReader, ics: IcsInfo, cb: np.ndarray,
                    rate_index: int) -> np.ndarray:
    offsets = sfb_offsets(rate_index, ics.short)
    groups = ics.window_groups()
    out = np.zeros(1024, np.int32)
    pos = 0
    for g, wins in enumerate(groups):
        group_start = pos
        for k in range(ics.max_sfb):
            c = int(cb[g, k])
            width = int(offsets[k + 1] - offsets[k])
            n = width * wins
            if c == 0 or c == 12 or c >= NOISE_CB:
                pos += n
                continue
            lut = SPECTRAL_LUTS[c]
            dim = CB_DIM[c]
            unsigned = CB_UNSIGNED[c]
            i = 0
            while i < n:
                vals = lut.decode(br).astype(np.int32).copy()
                if unsigned:
                    for d in range(dim):
                        if vals[d] != 0 and br.read(1):
                            vals[d] = -vals[d]
                if c == ESC_CB:
                    for d in range(dim):
                        if abs(vals[d]) == 16:
                            esc = 4
                            while br.read(1):
                                esc += 1
                            mag = (1 << esc) | br.read(esc)
                            vals[d] = mag if vals[d] > 0 else -mag
                out[pos + i:pos + i + dim] = vals
                i += dim
            pos += n
        group_width = 128 * wins if ics.short else 1024
        pos = group_start + group_width
    return out


def _parse_ics(br: BitReader, rate_index: int, common_window: bool = False,
               shared_ics: Optional[IcsInfo] = None) -> ChannelData:
    ch = ChannelData()
    ch.global_gain = br.read(8)
    if common_window and shared_ics is not None:
        ch.ics = shared_ics
    else:
        ch.ics = _parse_ics_info(br)
    ch.band_cb = _parse_section_data(br, ch.ics)
    ch.scalefactors = _parse_scale_factors(br, ch.ics, ch.band_cb,
                                           ch.global_gain)
    if br.read(1):                    # pulse_data_present
        raise AacError("pulse data not supported")
    if br.read(1):                    # tns_data_present
        ch.tns = _parse_tns(br, ch.ics)
    if br.read(1):                    # gain_control_data_present
        raise AacError("SSR gain control not supported")
    ch.quant = _parse_spectral(br, ch.ics, ch.band_cb, rate_index)
    return ch


def parse_raw_data_block(br: BitReader, rate_index: int) -> FrameData:
    channels = []
    ms_mask = None
    while True:
        el = br.read(3)
        if el == ID_END:
            break
        if el == ID_SCE or el == ID_LFE:
            br.read(4)
            channels.append(_parse_ics(br, rate_index))
        elif el == ID_CPE:
            br.read(4)
            common = br.read(1)
            shared = None
            mask = None
            if common:
                shared = _parse_ics_info(br)
                ms_present = br.read(2)
                ngroups = len(shared.window_groups())
                if ms_present == 1:
                    mask = np.zeros((ngroups, max(shared.max_sfb, 1)), bool)
                    for g in range(ngroups):
                        for k in range(shared.max_sfb):
                            mask[g, k] = bool(br.read(1))
                elif ms_present == 2:
                    mask = np.ones((ngroups, max(shared.max_sfb, 1)), bool)
            left = _parse_ics(br, rate_index, common, shared)
            right = _parse_ics(br, rate_index, common, shared)
            channels.extend([left, right])
            ms_mask = mask
        elif el == ID_DSE:
            br.read(4)
            align = br.read(1)
            cnt = br.read(8)
            if cnt == 255:
                cnt += br.read(8)
            if align:
                br.align_byte()
            for _ in range(cnt):
                br.read(8)
        elif el == ID_FIL:
            cnt = br.read(4)
            if cnt == 15:
                cnt += br.read(8) - 1
            for _ in range(cnt * 8):
                br.read(1)
        elif el == ID_PCE:
            raise AacError("PCE parsing not supported (use ADTS config)")
        else:
            raise AacError(f"unsupported syntactic element {el}")
    return FrameData(channels, ms_mask, rate_index)


def parse_frame(frame: bytes) -> FrameData:
    h = parse_adts_header(frame)
    if h is None:
        raise AacError("not an ADTS frame")
    return parse_raw_data_block(BitReader(frame, h.header_bytes * 8),
                                h.rate_index)


# ---------------------------------------------------------------------------
# spectral prep (codecs/aac/synthesis.py, float64 throughout)
# ---------------------------------------------------------------------------

_POW43 = np.arange(8192, dtype=np.float64) ** (4.0 / 3.0)


@functools.lru_cache(maxsize=None)
def _layout(rate_index: int, seq: int, grouping: int, max_sfb: int):
    """Transmission positions -> spectral positions, and the band slot
    (group * 15 + sfb) of each spectral position, for one ICS config."""
    short = seq == EIGHT_SHORT
    ics = IcsInfo()
    ics.window_sequence, ics.max_sfb = seq, max_sfb
    ics.scale_factor_grouping = grouping
    offsets = sfb_offsets(rate_index, short)
    src, dst, band = [], [], []
    if not short:
        for k in range(max_sfb):
            a, b = int(offsets[k]), int(offsets[k + 1])
            src.extend(range(a, b))
            dst.extend(range(a, b))
            band.extend([k] * (b - a))
    else:
        pos = 0
        win_base = 0
        for g, wins in enumerate(ics.window_groups()):
            for k in range(max_sfb):
                width = int(offsets[k + 1] - offsets[k])
                for w in range(wins):
                    a = (win_base + w) * 128 + int(offsets[k])
                    src.extend(range(pos, pos + width))
                    dst.extend(range(a, a + width))
                    band.extend([g * 15 + k] * width)
                    pos += width
            win_base += wins
            pos = win_base * 128
    return (np.asarray(src, np.int64), np.asarray(dst, np.int64),
            np.asarray(band, np.int64))


def _slots(ch: ChannelData, plane: np.ndarray) -> np.ndarray:
    """A (groups, max_sfb) plane as the (120,) band-slot row g * 15 + k."""
    out = np.zeros(120, plane.dtype)
    for g in range(plane.shape[0]):
        n = min(ch.ics.max_sfb, plane.shape[1])
        out[g * 15:g * 15 + n] = plane[g, :n]
    return out


def _ch_layout(ch: ChannelData, rate_index: int):
    seq = ch.ics.window_sequence
    return _layout(rate_index, seq if seq == EIGHT_SHORT else 0,
                   ch.ics.scale_factor_grouping if seq == EIGHT_SHORT else 0,
                   ch.ics.max_sfb)


def _pns_noise(row: int, pos: int, n: int) -> np.ndarray:
    """The port's PNS noise: seeded per (row, first band position)."""
    return np.random.default_rng(
        (0x9A5 << 32) ^ (row * 2048 + pos)).standard_normal(n)


def frame_spectra(fr: FrameData, pns_rows: Optional[list]) -> np.ndarray:
    """(channels, 1024) float64 spectra of one frame: dequantisation and
    scalefactors, PNS (channel c's noise seeded by ``pns_rows[c]``), M/S
    and intensity, then TNS."""
    ri = fr.rate_index
    C = len(fr.channels)
    specs = np.zeros((C, 1024))
    cbs = [_slots(ch, ch.band_cb) for ch in fr.channels]
    sfs = [_slots(ch, ch.scalefactors) for ch in fr.channels]
    for c, ch in enumerate(fr.channels):
        if ch.ics.max_sfb == 0:
            continue
        src, dst, band = _ch_layout(ch, ri)
        q = ch.quant.astype(np.int64)
        dq = np.sign(q) * np.where(
            np.abs(q) < 8192, _POW43[np.minimum(np.abs(q), 8191)],
            np.abs(q).astype(np.float64) ** (4.0 / 3.0))
        gains = np.exp2(0.25 * (sfs[c].astype(np.float64) - SF_OFFSET))
        coded = (cbs[c] >= 1) & (cbs[c] <= 11)
        specs[c, dst] = dq[src] * gains[band] * coded[band]
        sel = cbs[c][band] == NOISE_CB
        if sel.any():
            d = dst[sel]
            n = _pns_noise(int(pns_rows[c]), int(d[0]), len(d))
            bids = band[sel]
            for b in np.unique(bids):
                m = bids == b
                seg = n[m]
                e = 2.0 ** (0.25 * sfs[c][b])
                n[m] = seg * (e / np.sqrt(np.mean(seg * seg) + 1e-30))
            specs[c, d] = n
    if C == 2:
        _stereo(fr, specs, cbs, sfs)
    for c, ch in enumerate(fr.channels):
        apply_tns(ch, specs[c], ri)
    return specs


def _stereo(fr: FrameData, specs: np.ndarray, cbs: list, sfs: list) -> None:
    """M/S and intensity on a channel pair, in place."""
    lch = fr.channels[0]
    cbr = cbs[1]
    is_band = np.isin(cbr, (INTENSITY_CB, INTENSITY_CB2))
    mask_band = np.zeros(120, bool)
    if fr.ms_mask is not None:
        mask_band = _slots(lch, fr.ms_mask).astype(bool)
    if not mask_band.any() and not is_band.any():
        return
    if lch.ics.max_sfb == 0:
        return
    _, dst, band = _ch_layout(lch, fr.rate_index)
    ms_sel = mask_band[band] & ~is_band[band] & (cbr[band] != NOISE_CB)
    if ms_sel.any():
        d = dst[ms_sel]
        mid = specs[0, d].copy()
        side = specs[1, d].copy()
        specs[0, d] = mid + side
        specs[1, d] = mid - side
    if is_band.any():
        isel = is_band[band]
        d = dst[isel]
        bsel = band[isel]
        sign = np.where(cbr[bsel] == INTENSITY_CB, 1.0, -1.0)
        sign *= np.where(mask_band[bsel], -1.0, 1.0)
        scale = sign * 0.5 ** (0.25 * sfs[1][bsel])
        specs[1, d] = specs[0, d] * scale


def apply_tns(ch: ChannelData, spec: np.ndarray, rate_index: int) -> None:
    """TNS synthesis filtering (ISO 14496-3 4.6.9): an all-pole filter
    along frequency per window, in place."""
    if ch.tns is None:
        return
    ics = ch.ics
    offsets = sfb_offsets(rate_index, ics.short)
    nbands = len(offsets) - 1
    for w, filters in enumerate(ch.tns):
        base = w * 128 if ics.short else 0
        bottom = nbands
        for (length, order, direction, coeffs) in filters:
            top = bottom
            bottom = max(top - length, 0)
            if order == 0:
                continue
            start = int(offsets[min(bottom, nbands)])
            end = int(offsets[min(top, nbands)])
            end = min(end, 128 if ics.short else 1024)
            if end <= start:
                continue
            lpc = _lattice_to_lpc(np.asarray(coeffs, np.float64))
            seg = spec[base + start:base + end]
            if direction:
                seg = seg[::-1]
            state = np.zeros(len(lpc))
            for i in range(len(seg)):
                y = seg[i] - np.dot(lpc, state)
                state = np.roll(state, 1)
                state[0] = y
                seg[i] = y


def _lattice_to_lpc(refl: np.ndarray) -> np.ndarray:
    a = np.zeros(0)
    for k in refl:
        a = np.concatenate([a + k * a[::-1], [k]]) if len(a) else np.array([k])
    return a


# ---------------------------------------------------------------------------
# filterbank (float64)
# ---------------------------------------------------------------------------

def _sine_window(n: int) -> np.ndarray:
    return np.sin(np.pi / n * (np.arange(n) + 0.5))


def _kbd_window(n: int, alpha: float) -> np.ndarray:
    half = n // 2
    t = np.arange(half + 1)
    kaiser = np.i0(np.pi * alpha * np.sqrt(1.0 - (2.0 * t / half - 1.0) ** 2))
    cum = np.cumsum(kaiser)
    w = np.sqrt(cum[:half] / cum[half])
    return np.concatenate([w, w[::-1]])


@functools.lru_cache(maxsize=None)
def imdct_matrix(n_out: int) -> np.ndarray:
    """(n_out / 2, n_out) float64 operator: x = X @ M."""
    N = n_out
    k = np.arange(N // 2)
    n = np.arange(N)
    return (2.0 / N) * np.cos(2.0 * np.pi / N * (n[None, :] + 0.5 + N / 4)
                              * (k[:, None] + 0.5))


@functools.lru_cache(maxsize=None)
def window_bank():
    """(16, 2048) windows per op (sequence * 4 + left shape * 2 + right
    shape) for the long sequences, and (4, 8, 256) short windows per
    op & 3."""
    ls_ = {0: _sine_window(2048), 1: _kbd_window(2048, 4.0)}
    ss_ = {0: _sine_window(256), 1: _kbd_window(256, 6.0)}
    W = np.zeros((16, 2048))
    SW = np.zeros((4, 8, 256))
    for mode in (ONLY_LONG, LONG_START, LONG_STOP):
        for ls in (0, 1):
            for rs in (0, 1):
                left = ls_[ls][:1024]
                if mode == ONLY_LONG:
                    win = np.concatenate([left, ls_[rs][1024:]])
                elif mode == LONG_START:
                    win = np.concatenate([left, np.ones(448), ss_[rs][128:],
                                          np.zeros(448)])
                else:
                    win = np.concatenate([np.zeros(448), ss_[ls][:128],
                                          np.ones(448), ls_[rs][1024:]])
                W[mode * 4 + ls * 2 + rs] = win
    for ls in (0, 1):
        for rs in (0, 1):
            for w in range(8):
                SW[ls * 2 + rs, w] = np.concatenate(
                    [(ss_[ls] if w == 0 else ss_[rs])[:128], ss_[rs][128:]])
    return W, SW


def synthesise(specs: np.ndarray, ops: np.ndarray,
               matmul: Callable = np.matmul) -> np.ndarray:
    """Windowed IMDCT of (R, 1024) spectra with ops (R,): (R, 2048).
    ``matmul`` computes the products (the control passes a lower-precision
    one)."""
    W, SW = window_bank()
    x = matmul(specs, imdct_matrix(2048)) * W[ops]
    short = (ops >> 2) == EIGHT_SHORT
    if short.any():
        xs = matmul(specs[short].reshape(-1, 128), imdct_matrix(256)) \
            .reshape(-1, 8, 256) * SW[ops[short] & 3]
        xsh = np.zeros((int(short.sum()), 2048))
        for w in range(8):
            xsh[:, 448 + w * 128:448 + w * 128 + 256] += xs[:, w]
        x[short] = xsh
    return x


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

def split_frames(data: bytes) -> list[bytes]:
    frames, pos = [], 0
    while (h := parse_adts_header(data, pos)) is not None:
        frames.append(data[pos:pos + h.frame_bytes])
        pos += h.frame_bytes
    return frames


def serving_pns_rows(frames: list[FrameData], group: int) -> list:
    """PNS row seeds of the port's serving call (groups of ``group``
    frames): a channel's row is j * channels + c, j the frame's rank among
    the frames of its group that carry a PNS or intensity band."""
    rows = []
    for g0 in range(0, len(frames), group):
        j = 0
        for fr in frames[g0:g0 + group]:
            C = len(fr.channels)
            exotic = any(ch.band_cb is not None and (ch.band_cb >= 13).any()
                         for ch in fr.channels)
            rows.append([j * C + c for c in range(C)])
            j += exotic
    return rows


def render_pns_rows(frames: list[FrameData], group: int) -> list:
    """PNS row seeds of the port's ``CodecAacAdts`` (groups of ``group``
    frames): a channel's row is f * channels + c, f the frame's index in
    its group."""
    return [[(t % group) * len(fr.channels) + c
             for c in range(len(fr.channels))]
            for t, fr in enumerate(frames)]


class Decoder:
    """Decodes ADTS AAC-LC streams to float64 PCM.  Frames are parsed and
    their spectra and windowed IMDCT computed once per distinct frame bytes,
    PNS seeds and window op, then laid out per stream."""

    def __init__(self, matmul: Callable = np.matmul):
        self.matmul = matmul
        self._parsed: dict = {}
        self._spectra: dict = {}

    def parse(self, frame: bytes) -> FrameData:
        fr = self._parsed.get(frame)
        if fr is None:
            fr = self._parsed[frame] = parse_frame(frame)
        return fr

    def decode_stream(self, data: bytes, pns_rows: Callable) -> np.ndarray:
        """(channels, frames * 1024) float64 PCM of one stream, from zero
        overlap and sine-window history.  ``pns_rows(parsed frames)`` gives
        each frame's PNS row seeds (:func:`serving_pns_rows`,
        :func:`render_pns_rows`)."""
        raw = split_frames(data)
        frames = [self.parse(f) for f in raw]
        if not frames:
            return np.zeros((2, 0))
        seeds = pns_rows(frames)
        C = len(frames[0].channels)
        keys, specs = [], []
        for f, fr, rows in zip(raw, frames, seeds):
            exotic = any(ch.band_cb is not None and (ch.band_cb == NOISE_CB)
                         .any() for ch in fr.channels)
            key = (f, tuple(rows) if exotic else None)
            if key not in self._spectra:
                self._spectra[key] = frame_spectra(fr, rows)
            keys.append(key)
            specs.append(self._spectra[key])
        spec = np.stack(specs)                           # (F, C, 1024)
        seq = np.array([[ch.ics.window_sequence for ch in fr.channels]
                        for fr in frames])
        shape = np.array([[ch.ics.window_shape for ch in fr.channels]
                          for fr in frames])
        prev = np.concatenate([np.zeros((1, C), np.int64), shape[:-1]])
        ops = (seq * 4 + prev * 2 + shape).astype(np.int64)
        # one windowed IMDCT per distinct (spectrum, channel, op)
        uniq: dict = {}
        idx = np.empty((len(frames), C), np.int64)
        for t, key in enumerate(keys):
            for c in range(C):
                idx[t, c] = uniq.setdefault((key, c, int(ops[t, c])),
                                            len(uniq))
        rows = np.empty((len(uniq), 1024))
        rops = np.empty(len(uniq), np.int64)
        for (key, c, op), i in uniq.items():
            rows[i] = self._spectra[key][c]
            rops[i] = op
        x = synthesise(rows, rops, self.matmul)[idx]     # (F, C, 2048)
        out = x[:, :, :1024].copy()
        out[1:] += x[:-1, :, 1024:]
        return out.transpose(1, 0, 2).reshape(C, -1)


#: What a PCM gap reads when an output has the wrong shape: wider than any
#: 16-bit sample can be off.
SHAPE_GAP = 65536.0


def pcm_gap(pcm: np.ndarray, ref: np.ndarray) -> float:
    """The widest gap, in LSB, between 16-bit ``pcm`` and the float64
    reference clipped to the 16-bit range."""
    pcm = np.asarray(pcm)
    if pcm.shape != ref.shape:
        return SHAPE_GAP
    if pcm.size == 0:
        return 0.0
    return float(np.abs(pcm - np.clip(ref, -32768.0, 32767.0)).max())


def pns_rows(path: str, cell: dict) -> Callable:
    """The PNS row seeds of the port's path: "serving" (the batch call's
    groups of ``frames_per_group``) or "render" (``CodecAacAdts``'s groups
    of ``render_group_frames``)."""
    if path == "serving":
        g = int(cell["frames_per_group"])
        return lambda frames: serving_pns_rows(frames, g)
    g = int(cell["render_group_frames"])
    return lambda frames: render_pns_rows(frames, g)


def expected(content: dict, indices, path: str, cell: dict,
             decoder: Optional[Decoder] = None) -> dict:
    """{stream index: float64 reference PCM} for ``indices``."""
    dec = decoder or Decoder()
    rows = pns_rows(path, cell)
    return {i: dec.decode_stream(content["streams"][i], rows)
            for i in sorted(set(indices))}


def compare(content: dict, outputs: list, path: str, cell: dict) -> dict:
    """``outputs``: (stream index, PCM) pairs the timed path produced.
    Returns {"pcm_gap_lsb": the widest gap of any of them}."""
    refs = expected(content, [i for i, _ in outputs], path, cell)
    return {"pcm_gap_lsb": max((pcm_gap(pcm, refs[i]) for i, pcm in outputs),
                               default=0.0)}


def tf32_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """A float32 product in TF32: on the card, torch's matmul with TF32
    allowed; elsewhere both operands rounded to TF32's 10-bit mantissa and
    multiplied in float32."""
    import torch

    if torch.cuda.is_available():
        flag = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            out = torch.from_numpy(a.astype(np.float32)).cuda() \
                @ torch.from_numpy(b.astype(np.float32)).cuda()
            return out.cpu().numpy().astype(np.float64)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = flag

    def tf32(x):
        u = np.ascontiguousarray(x, np.float32).view(np.uint32)
        return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)) \
            .view(np.float32)
    return (tf32(a) @ tf32(b)).astype(np.float64)


def lower_precision(content: dict, outputs: list, path: str,
                    cell: dict) -> list:
    """The control: the reference in the program's place with its
    products in TF32, the precision below the float32 that the
    configuration states, rounded to 16-bit PCM as the program rounds."""
    refs = expected(content, [i for i, _ in outputs], path, cell,
                    Decoder(tf32_matmul))
    return [(i, np.clip(np.rint(refs[i]), -32768, 32767).astype(np.int32))
            for i, _ in outputs]
