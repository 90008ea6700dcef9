"""The CELT 48 kHz mode: band layout, allocation matrix, PVQ bit cache,
window (RFC 6716 wire constants, extracted via tools/extract_celt_tables.py
from the normative tables)."""

from __future__ import annotations

import pathlib

import numpy as np

_NPZ = pathlib.Path(__file__).with_name("celt_mode.npz")


class CeltMode:
    def __init__(self):
        d = np.load(_NPZ)
        self.overlap = int(d["overlap"])
        self.nb_ebands = int(d["nb_ebands"])
        self.eff_ebands = int(d["eff_ebands"])
        self.preemph = d["preemph"]
        self.max_lm = int(d["max_lm"])
        self.short_mdct_size = int(d["short_mdct_size"])
        self.nb_short_mdcts = int(d["nb_short_mdcts"])
        self.ebands = d["ebands"].astype(np.int32)
        self.alloc_vectors = d["alloc_vectors"]
        self.logn = d["logn"].astype(np.int32)
        self.window = d["window"]
        self.cache_index = d["cache_index"].astype(np.int32)
        self.cache_bits = d["cache_bits"]
        self.cache_caps = d["cache_caps"]


_MODE = None


def celt_mode() -> CeltMode:
    global _MODE
    if _MODE is None:
        _MODE = CeltMode()
    return _MODE
