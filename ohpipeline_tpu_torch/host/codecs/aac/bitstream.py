"""AAC-LC host bitstream parse: ADTS framing + raw_data_block ->
quantized-spectrum batches for device synthesis.

Written from ISO/IEC 14496-3 subpart 4 syntax (adts_frame,
raw_data_block, individual_channel_stream, section_data,
scale_factor_data, tns_data, spectral_data).  Behavioural parity target:
the reference's fdk-aac decode path (OpenHome/Media/Codec/AacFdkAdts.cpp
-> libAACdec) for AAC-LC streams.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..flac.bitreader import BitReader
from . import tables as T

ONLY_LONG, LONG_START, EIGHT_SHORT, LONG_STOP = 0, 1, 2, 3

ID_SCE, ID_CPE, ID_CCE, ID_LFE, ID_DSE, ID_PCE, ID_FIL, ID_END = range(8)


class AacError(Exception):
    pass


@dataclass(slots=True)
class AdtsHeader:
    rate_index: int
    channels: int
    frame_bytes: int
    header_bytes: int
    profile: int

    @property
    def sample_rate(self) -> int:
        return T.SAMPLE_RATES[self.rate_index]


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
    if rate_index >= len(T.SAMPLE_RATES) or frame_bytes < header_bytes:
        return None
    return AdtsHeader(rate_index, channels, frame_bytes, header_bytes,
                      profile)


@dataclass(slots=True)
class IcsInfo:
    window_sequence: int = ONLY_LONG
    window_shape: int = 0
    max_sfb: int = 0
    scale_factor_grouping: int = 0

    @property
    def short(self) -> bool:
        return self.window_sequence == EIGHT_SHORT

    @property
    def num_windows(self) -> int:
        return 8 if self.short else 1

    def window_groups(self) -> list[int]:
        """Window count per group (short blocks; [1] for long)."""
        if not self.short:
            return [1]
        groups = [1]
        for b in range(6, -1, -1):
            if (self.scale_factor_grouping >> b) & 1:
                groups[-1] += 1
            else:
                groups.append(1)
        return groups


@dataclass(slots=True)
class TnsData:
    """Per-window TNS filters: list per window of (start_sfb_len, order,
    direction, coeffs)."""
    filters: list = field(default_factory=list)


@dataclass(slots=True)
class ChannelData:
    """One channel's parse result for one frame."""
    ics: IcsInfo = field(default_factory=IcsInfo)
    global_gain: int = 0
    band_cb: np.ndarray = None        # (groups, max_sfb) codebook ids
    scalefactors: np.ndarray = None   # (groups, max_sfb) int
    quant: np.ndarray = None          # (1024,) int32, window-interleaved raw
    tns: Optional[TnsData] = None
    pulse_present: bool = False


@dataclass(slots=True)
class FrameData:
    channels: list        # list of ChannelData (1 or 2)
    ms_mask: np.ndarray = None    # (groups, max_sfb) bool, CPE only
    rate_index: int = 0
    # SBR extension payload from the FIL element following the channel
    # element: (bytes, nbits, crc_flag) or None (ISO 14496-3 4.4.2.7,
    # extension_type EXT_SBR_DATA / EXT_SBR_DATA_CRC)
    sbr: tuple = None


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
            if c == 0:                        # ZERO_HCB
                sf[g, k] = 0
            elif c in (T.INTENSITY_CB, T.INTENSITY_CB2):
                is_pos += int(T.SCL_LUT.decode(br)[0])
                sf[g, k] = is_pos
            elif c == T.NOISE_CB:             # PNS
                if not noise_pcm_seen:
                    noise_pcm_seen = True
                    noise_energy += br.read(9) - 256
                else:
                    noise_energy += int(T.SCL_LUT.decode(br)[0])
                sf[g, k] = noise_energy
            else:
                sf_val += int(T.SCL_LUT.decode(br)[0])
                if not 0 <= sf_val < 256:
                    raise AacError("scalefactor out of range")
                sf[g, k] = sf_val
    return sf


def _parse_pulse(br: BitReader) -> None:
    n = br.read(2)
    br.read(6)
    for _ in range(n + 1):
        br.read(5)
        br.read(4)
    raise AacError("pulse data not supported")


def _parse_tns(br: BitReader, ics: IcsInfo) -> TnsData:
    tns = TnsData()
    nwin = ics.num_windows
    for w in range(nwin):
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
        tns.filters.append(filters)
    return tns


def _tns_decode_coeffs(raw: list[int], coef_res: int,
                       compress: int) -> np.ndarray:
    bits = (coef_res + 3) - compress
    # sign-extend, then inverse-quantize (ISO 14496-3 tns_data semantics)
    vals = np.array(raw, np.int32)
    half = 1 << (bits - 1)
    vals = np.where(vals >= half, vals - (1 << bits), vals)
    iqfac = ((1 << (coef_res + 2)) - 0.5) / (np.pi / 2.0)
    iqfac_m = ((1 << (coef_res + 2)) + 0.5) / (np.pi / 2.0)
    # float32 storage matches the native unpacker's tnsc plane exactly
    # (both compute the double sin first), keeping the two parse paths
    # bit-identical end to end
    return np.sin(vals / np.where(vals >= 0, iqfac, iqfac_m)) \
        .astype(np.float32)


def _parse_spectral(br: BitReader, ics: IcsInfo, cb: np.ndarray,
                    rate_index: int) -> np.ndarray:
    """Huffman-decode quantized coefficients.

    Returns (1024,) int32 in transmission order: for short windows the
    layout is per group: [sfb][window-in-group][4 bins] interleaved as the
    spec transmits; deinterleaving happens in the synthesis prep.
    """
    offsets = T.sfb_offsets(rate_index, ics.short)
    groups = ics.window_groups()
    out = np.zeros(1024, np.int32)
    pos = 0
    for g, wins in enumerate(groups):
        group_start = pos
        for k in range(ics.max_sfb):
            c = int(cb[g, k])
            width = int(offsets[k + 1] - offsets[k])
            n = width * wins
            if c == 0 or c == 12 or c >= T.NOISE_CB:
                pos += n
                continue
            lut = T.SPECTRAL_LUTS[c]
            dim = T.CB_DIM[c]
            unsigned = T.CB_UNSIGNED[c]
            i = 0
            while i < n:
                vals = lut.decode(br).astype(np.int32).copy()
                if unsigned:
                    for d in range(dim):
                        if vals[d] != 0 and br.read(1):
                            vals[d] = -vals[d]
                if c == T.ESC_CB:
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
        group_width = (128 if ics.short else 1024) * wins if ics.short \
            else 1024
        pos = group_start + group_width
    return out


def parse_individual_channel_stream(br: BitReader, rate_index: int,
                                    common_window: bool = False,
                                    shared_ics: Optional[IcsInfo] = None
                                    ) -> ChannelData:
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
        _parse_pulse(br)
    if br.read(1):                    # tns_data_present
        ch.tns = _parse_tns(br, ch.ics)
    if br.read(1):                    # gain_control_data_present
        raise AacError("SSR gain control not supported")
    ch.quant = _parse_spectral(br, ch.ics, ch.band_cb, rate_index)
    return ch


def parse_raw_data_block(br: BitReader, rate_index: int) -> FrameData:
    channels = []
    ms_mask = None
    sbr_payload = None
    while True:
        el = br.read(3)
        if el == ID_END:
            break
        if el == ID_SCE or el == ID_LFE:
            br.read(4)            # element_instance_tag
            channels.append(parse_individual_channel_stream(br, rate_index))
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
            left = parse_individual_channel_stream(br, rate_index, common,
                                                   shared)
            right = parse_individual_channel_stream(br, rate_index, common,
                                                    shared)
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
            if cnt > 0:
                ext_type = br.read(4)
                if ext_type in (13, 14):          # EXT_SBR_DATA(_CRC)
                    nbits = cnt * 8 - 4
                    payload = bytearray((nbits + 7) // 8)
                    for i in range(nbits):
                        if br.read(1):
                            payload[i >> 3] |= 1 << (7 - (i & 7))
                    sbr_payload = (bytes(payload), nbits, ext_type == 14)
                else:
                    for _ in range(cnt * 8 - 4):
                        br.read(1)
        elif el == ID_PCE:
            raise AacError("PCE parsing not supported (use ADTS config)")
        else:
            raise AacError(f"unsupported syntactic element {el}")
    return FrameData(channels, ms_mask, rate_index, sbr_payload)
