"""AAC constant tables: loaded from tables.npz (canonical ISO 14496-3
codebooks/sfb offsets, see tools/extract_aac_tables.py) plus fast decode
LUTs built at import."""

from __future__ import annotations

import pathlib

import numpy as np

_NPZ = np.load(pathlib.Path(__file__).resolve().parent / "tables.npz")

SAMPLE_RATES = (96000, 88200, 64000, 48000, 44100, 32000, 24000, 22050,
                16000, 12000, 11025, 8000, 7350)

ESC_CB = 11
NOISE_CB = 13            # PNS
INTENSITY_CB2 = 14       # out of phase
INTENSITY_CB = 15
SF_OFFSET = 100


class HuffLut:
    """Single-level Huffman LUT: peek `maxlen` bits, table gives
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
        """Decode one codeword from a BitReader; returns the value row."""
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

SFB_LONG = _NPZ["sfb_index_long"]      # (13, 52) offsets
SFB_SHORT = _NPZ["sfb_index_short"]    # (13, 16)
SFB_COUNTS = _NPZ["sfb_counts"]        # (13, 2) (n_long, n_short)


def sfb_offsets(rate_index: int, short: bool) -> np.ndarray:
    nl, ns = SFB_COUNTS[rate_index]
    if short:
        return SFB_SHORT[rate_index][: ns + 1]
    return SFB_LONG[rate_index][: nl + 1]
