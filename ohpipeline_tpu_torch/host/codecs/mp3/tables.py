"""MP3 constant tables: canonical ISO 11172-3 data from tables.npz (see
tools/extract_mp3_tables.py) + decode LUTs."""

from __future__ import annotations

import functools
import pathlib

import numpy as np

_NPZ = np.load(pathlib.Path(__file__).resolve().parent / "tables.npz")


class HuffLut:
    __slots__ = ("maxlen", "lengths", "rows", "vals")

    def __init__(self, codes, lens, vals):
        self.maxlen = max(int(lens.max()), 1)
        size = 1 << self.maxlen
        self.lengths = np.zeros(size, np.uint8)
        self.rows = np.zeros(size, np.int32)
        self.vals = vals
        for i, (c, l) in enumerate(zip(codes, lens)):
            shift = self.maxlen - int(l)
            base = int(c) << shift
            self.lengths[base:base + (1 << shift)] = max(int(l), 1)
            self.rows[base:base + (1 << shift)] = i

    def decode(self, br):
        w = br.peek_bits(self.maxlen)
        length = self.lengths[w]
        if length == 0:
            raise ValueError("bad mp3 huffman code")
        br.skip(int(length))
        return self.vals[self.rows[w]]


def _pair(tid: int):
    codes = _NPZ[f"pair{tid}_codes"]
    if len(codes) == 0:
        return None
    return HuffLut(codes, _NPZ[f"pair{tid}_lens"], _NPZ[f"pair{tid}_vals"])


PAIR_LUTS = {}
PAIR_LINBITS = {}
for _tid in list(range(0, 4)) + list(range(5, 14)) + [15] + \
        list(range(16, 32)):
    lut = _pair(_tid)
    if lut is not None and _tid != 0:
        PAIR_LUTS[_tid] = lut
    PAIR_LINBITS[_tid] = int(_NPZ[f"pair{_tid}_linbits"])
PAIR_LINBITS[4] = PAIR_LINBITS[14] = 0

QUAD_LUTS = (HuffLut(_NPZ["quadA_codes"], _NPZ["quadA_lens"],
                     _NPZ["quadA_vals"]),
             HuffLut(_NPZ["quadB_codes"], _NPZ["quadB_lens"],
                     _NPZ["quadB_vals"]))

SYNTHESIS_WINDOW = _NPZ["synthesis_window"]   # ISO Table B.3, 512 taps

_RATE_TAG = {44100: "44100", 48000: "48000", 32000: "32000",
             22050: "22050", 24000: "24000", 16000: "16000",
             11025: "11025", 12000: "12000", 8000: "8000"}


# NpzFile.__getitem__ re-reads and decompresses from the zip on every
# access; these run per-granule, so memoise (arrays are treated as
# read-only by all callers).

@functools.lru_cache(maxsize=None)
def sfb_long(rate: int) -> np.ndarray:
    """Long-block scalefactor band widths (22 bands covering 576)."""
    return _NPZ[f"sfb_{_RATE_TAG[rate]}_long"].astype(np.int32)


@functools.lru_cache(maxsize=None)
def sfb_short(rate: int) -> np.ndarray:
    """Short-block per-band widths (13 bands covering 192 lines/window).

    The stored table is window-interleaved (13 x 3 equal entries); return
    the per-band width."""
    return _NPZ[f"sfb_{_RATE_TAG[rate]}_short"].astype(
        np.int32).reshape(-1, 3)[:, 0]


@functools.lru_cache(maxsize=None)
def sfb_short_interleaved(rate: int) -> np.ndarray:
    """Window-interleaved short-block widths (39 entries: sfb-major,
    window-minor) — the order scalefactors and frequency lines walk."""
    return _NPZ[f"sfb_{_RATE_TAG[rate]}_short"].astype(np.int32)


@functools.lru_cache(maxsize=None)
def sfb_mixed(rate: int) -> np.ndarray:
    return _NPZ[f"sfb_{_RATE_TAG[rate]}_mixed"].astype(np.int32)
