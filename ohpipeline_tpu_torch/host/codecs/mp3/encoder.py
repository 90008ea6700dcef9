"""Minimal MPEG-1/2/2.5 Layer III frame builder — the conformance-vector
source.

Builds spec-valid MP3 streams from chosen quantized spectra (no bit
reservoir, one Huffman table).  This gives the test suite real bitstreams
whose exact spectral content is known, decodable both by our decoder and
the libmad oracle for cross-validation (no MP3 encoder exists on this
system, and the reference's test tones are not vendored).  LSF frames
(version 2/2.5) carry one granule and support 9-bit scalefac_compress
values with explicit scalefactor payloads (ISO 13818-3 §2.4.3.2).
"""

from __future__ import annotations

import numpy as np

from ..flac.bitreader import BitWriter
from . import tables as T
from .bitstream import (BITRATES_V1_L3, BITRATES_V2_L3, NSFB_LSF, RATES_V1,
                        RATES_V2, RATES_V25)


def lsf_slens(scalefac_compress: int, intensity: bool = False,
              index: int = 0) -> tuple[tuple, tuple]:
    """(slen[4], nsfb[4]) for an LSF scalefac_compress value (decoder's
    partition rules, used here to size the scalefactor payload)."""
    sc = scalefac_compress
    if not intensity:
        if sc < 400:
            return (((sc >> 4) // 5, (sc >> 4) % 5, (sc % 16) >> 2, sc % 4),
                    NSFB_LSF[0][index])
        if sc < 500:
            sc -= 400
            return (((sc >> 2) // 5, (sc >> 2) % 5, sc % 4, 0),
                    NSFB_LSF[1][index])
        sc -= 500
        return ((sc // 3, sc % 3, 0, 0), NSFB_LSF[2][index])
    sc >>= 1
    if sc < 180:
        return ((sc // 36, (sc % 36) // 6, (sc % 36) % 6, 0),
                NSFB_LSF[3][index])
    if sc < 244:
        sc -= 180
        return (((sc % 64) >> 4, (sc % 16) >> 2, sc % 4, 0),
                NSFB_LSF[4][index])
    sc -= 244
    return ((sc // 3, sc % 3, 0, 0), NSFB_LSF[5][index])

_ENC_CACHE: dict = {}


def _encode_table(tid: int) -> dict:
    """(x, y) -> (code, length) reverse map for a pair codebook."""
    if tid in _ENC_CACHE:
        return _ENC_CACHE[tid]
    import pathlib
    npz = np.load(pathlib.Path(__file__).resolve().parent / "tables.npz")
    codes = npz[f"pair{tid}_codes"]
    lens = npz[f"pair{tid}_lens"]
    vals = npz[f"pair{tid}_vals"]
    m = {(int(v[0]), int(v[1])): (int(c), int(l))
         for c, l, v in zip(codes, lens, vals)}
    _ENC_CACHE[tid] = m
    return m


def build_frame(spectrum: list[np.ndarray], sample_rate: int = 44100,
                bitrate: int = 320, global_gain: int = 210,
                table: int = 15, block_type: int = 0, version: int = 1,
                scalefac_compress: int = 0,
                scalefacs: list | None = None,
                intensity: bool = False) -> bytes:
    """One Layer III frame from per-channel quantized spectra.

    spectrum: list (1 or 2 channels) of (576,) ints with |v| <= 15; the
    same spectrum is used for both granules (MPEG-1) or the single
    granule (LSF).  Values beyond big_values must be zero.  For LSF,
    `scalefacs[ch]` (linear order) are written with the slens implied by
    `scalefac_compress`; `intensity` emits joint stereo with the
    intensity mode_extension bit (ch1 scalefactors become is-positions).
    """
    nch = len(spectrum)
    lsf = version != 1
    if version == 1:
        rate_idx = RATES_V1.index(sample_rate)
        bitrate_idx = BITRATES_V1_L3.index(bitrate)
    elif version == 2:
        rate_idx = RATES_V2.index(sample_rate)
        bitrate_idx = BITRATES_V2_L3.index(bitrate)
    else:
        rate_idx = RATES_V25.index(sample_rate)
        bitrate_idx = BITRATES_V2_L3.index(bitrate)
    enc = _encode_table(table)

    # huffman-encode one granule-channel
    def encode_spectrum(spec) -> tuple[bytes, int, int]:
        nz = np.nonzero(spec)[0]
        last = int(nz[-1]) + 1 if len(nz) else 0
        big_values = (last + 1) // 2
        bw = BitWriter()
        for i in range(big_values * 2)[::2]:
            x = int(spec[i])
            y = int(spec[i + 1]) if i + 1 < 576 else 0
            code, length = enc[(abs(x), abs(y))]
            bw.write(code, length)
            if x:
                bw.write(1 if x < 0 else 0, 1)
            if y:
                bw.write(1 if y < 0 else 0, 1)
        nbits = bw.bit_length
        bw.align_byte()
        return bw.getvalue(), nbits, big_values

    payloads = []
    for ch in range(nch):
        payloads.append(encode_spectrum(spectrum[ch]))

    # LSF scalefactor payload: (value, nbits) runs per channel
    sf_payload: list[tuple[list, int]] = []
    for ch in range(nch):
        if lsf:
            slen, nsfb = lsf_slens(scalefac_compress,
                                   intensity and ch == 1,
                                   index=1 if block_type == 2 else 0)
            vals = list(scalefacs[ch]) if scalefacs else [0] * 39
            runs = []
            n = 0
            for part in range(4):
                for _ in range(nsfb[part]):
                    v = vals[n] if n < len(vals) else 0
                    if slen[part]:
                        runs.append((v, slen[part]))
                    n += 1
            sf_payload.append((runs, sum(b for _, b in runs)))
        else:
            sf_payload.append(([], 0))

    ngr = 1 if lsf else 2
    side = BitWriter()
    side.write(0, 8 if lsf else 9)        # main_data_begin
    if lsf:
        side.write(0, 1 if nch == 1 else 2)   # private
    else:
        side.write(0, 5 if nch == 1 else 3)
        for _ in range(nch):
            for _ in range(4):
                side.write(0, 1)          # scfsi
    for _gr in range(ngr):
        for ch in range(nch):
            _, nbits, big_values = payloads[ch]
            side.write(nbits + sf_payload[ch][1], 12)  # part2_3_length
            side.write(big_values, 9)
            side.write(global_gain, 8)
            side.write(scalefac_compress, 9 if lsf else 4)
            if block_type:
                side.write(1, 1)          # window_switching on
                side.write(block_type, 2)
                side.write(0, 1)          # not mixed
                for _ in range(2):
                    side.write(table, 5)
                for _ in range(3):
                    side.write(0, 3)      # subblock_gain
            else:
                side.write(0, 1)          # window_switching off
                for _ in range(3):
                    side.write(table, 5)
                side.write(7, 4)          # region0_count
                side.write(7, 3)          # region1_count
            if not lsf:
                side.write(0, 1)          # preflag
            side.write(0, 1)              # scalefac_scale
            side.write(0, 1)              # count1table_select
    side_bytes = side.getvalue()
    if lsf:
        assert len(side_bytes) == (9 if nch == 1 else 17)
    else:
        assert len(side_bytes) == (17 if nch == 1 else 32)

    # main data: granule-major, channel-minor (scalefactors then huffman)
    main = BitWriter()
    for _gr in range(ngr):
        for ch in range(nch):
            for v, b in sf_payload[ch][0]:
                main.write(v, b)
            data, nbits, _ = payloads[ch]
            # re-write the exact bit payload (unaligned concatenation)
            val = int.from_bytes(data, "big") >> (len(data) * 8 - nbits) \
                if nbits else 0
            main.write(val, nbits)
    main.align_byte()
    main_bytes = main.getvalue()

    frame_bytes = (72 if lsf else 144) * bitrate * 1000 // sample_rate
    vc = {1: 3, 2: 2, 25: 0}[version]
    if nch == 1:
        mode_byte = 3 << 6
    elif intensity:
        mode_byte = (1 << 6) | (1 << 4)   # joint stereo, intensity on
    else:
        mode_byte = 0
    hdr = bytes([0xFF,
                 0xE0 | (vc << 3) | (1 << 1) | 1,   # Layer III, no CRC
                 (bitrate_idx << 4) | (rate_idx << 2),
                 mode_byte])
    need = frame_bytes - 4 - len(side_bytes)
    if len(main_bytes) > need:
        raise ValueError("payload too large for bitrate")
    return hdr + side_bytes + main_bytes + b"\x00" * (need - len(main_bytes))


def build_stream(spectrum: list[np.ndarray], nframes: int = 20,
                 **kw) -> bytes:
    frame = build_frame(spectrum, **kw)
    return frame * nframes


def tone_spectrum(bin_index: int, value: int = 13) -> np.ndarray:
    spec = np.zeros(576, np.int32)
    spec[bin_index] = value
    spec[bin_index + 1] = -(value // 2)
    return spec
