"""Plain float64 HE-AAC v1 decoder (AAC-LC core + SBR): the benchmark's
reference for ADTS HE-AAC v1 radio.

The core is ``reference/aac.py``'s float64 AAC-LC decoder, with the PNS
row seeding of the port's serving call for the cell's ``frames_per_group``.
The SBR stage (ISO/IEC 14496-3 §4.6.18) is a frozen copy, made at commit
f4813dd of this repository, of the v1 chain of
``ohpipeline_tpu_torch/host/codecs/aac/sbr.py``: the bit reader ``Bits``,
``parse_sbr_header``, the frequency tables (``master_freq_table``,
``derive_tables``, ``_build_patches``, ``_build_limiter``), ``parse_grid``,
``parse_sbr_data``, ``map_invf_bw`` and ``SbrDecoder``'s ``dequant``,
``unmap_coupled``, ``process_frame``, ``_reconstruct`` (QMF analysis and the
HF generator with its LPC), ``_adjust`` (the envelope adjuster with its
limiter, boost, gain smoothing, noise and sinusoids) and ``_synthesize``.
Its tables (the Huffman trees, the noise table and the two QMF kernels of
``host/codecs/aac/sbr_tables.npz``) are copied beside this file as
``sbr_tables.npz``.

Departures from the copy, none of which changes what is computed beyond
the order of float64 sums:

- the DSP runs in PyTorch, float64 (complex128) on the CPU, with TF32 set
  off for the duration (:func:`_no_tf32`);
- the QMF analysis and synthesis run once over a channel's whole stream
  (one product over every slot, one overlap-add), which is the per-frame
  analysis with its 320-sample history and the per-frame synthesis with
  its 704-sample state, started from zeros;
- the HF generator's per-band loops are tensor ops over the patched bands,
  and the envelope adjuster's per-slot loop is tensor ops over an
  envelope's slots (the noise index of slot k of an envelope is the
  envelope's start index + k * M, its sine phase the start phase + k);
- ``Bits.read`` reads a field at once rather than bit by bit, with the
  same overrun error; a parametric-stereo extension (v2) raises, as the
  port's serving call does; the diagnostic taps (``ALPHA_SINK``,
  ``ENV_SINK``, ``GAIN_OVERRIDE``, ``PATCH_SINK``) and the native parser
  are left out;
- the SBR payload is taken from each frame's FIL element by this module's
  own walk of the raw data block (:func:`sbr_payload`), which parses the
  channel elements with ``reference/aac.py``.

**What a run checks** (``compare``).  A serving call decodes the same
streams every call, so each checked stream is decoded here once, from its
first frame, and every kept call's output of that stream is held to it.
The streams checked are the content's ``check``: ``check_streams`` indices
of the cell's streams, drawn from the seed (the cell parameter
``check_streams``; ``content/he_aac.py``).  The float64 SBR chain costs
milliseconds a frame in Python, so a run checks a few whole streams
rather than all of them; ``compare`` prints the time it took on standard
error.

It imports nothing of the port and no JAX.
"""

from __future__ import annotations

import contextlib
import functools
import math
import pathlib
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from . import aac as R

# ---------------------------------------------------------------------------
# tables (host/codecs/aac/sbr_tables.npz, the v1 entries)
# ---------------------------------------------------------------------------

T = dict(np.load(pathlib.Path(__file__).resolve().parent / "sbr_tables.npz"))
#: QMF analysis kernel (32, 320) complex and synthesis responses (64, 2,
#: 768): band k's +1 at [k, 0], its +1j at [k, 1].
K_ANA = T["ana32"]
SYN64 = T["syn64"]
#: libSBRdec's V noise table, unit magnitude.
NOISE_TAB = T["random_phase"][:, 0] + 1j * T["random_phase"][:, 1]
EXT_SBR_DATA, EXT_SBR_DATA_CRC = 13, 14


class SbrError(Exception):
    pass


class Bits:
    """MSB-first fields of an SBR payload of ``nbits`` bits."""

    def __init__(self, data: bytes, bitpos: int = 0,
                 nbits: Optional[int] = None):
        self.data = data
        self.pos = bitpos
        self.limit = nbits if nbits is not None else len(data) * 8

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        end = self.pos + n
        if end > self.limit:
            raise SbrError("SBR payload overrun")
        first, last = self.pos >> 3, (end - 1) >> 3
        v = int.from_bytes(self.data[first:last + 1], "big")
        v >>= (last + 1) * 8 - end
        self.pos = end
        return v & ((1 << n) - 1)


def _huff(bits: Bits, book: np.ndarray) -> int:
    """Walk a (n, 2) binary-tree book; a negative entry is a leaf and
    decodes as entry + 64."""
    node = 0
    while True:
        node = int(book[node][bits.read(1)])
        if node < 0:
            return node + 64


# ---------------------------------------------------------------------------
# header & frequency tables (ISO 14496-3 4.6.18.3)
# ---------------------------------------------------------------------------

START_FREQ = {
    16000: [16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31],
    22050: [12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 26, 28, 30],
    24000: [11, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 25, 27, 29, 32],
    32000: [10, 12, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 25, 27, 29, 32],
    44100: [8, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 21, 23, 25, 28, 32],
    48000: [7, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 27, 31],
    64000: [6, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 19, 21, 23, 26, 30],
    88200: [5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 16, 18, 20, 23, 27, 31],
    96000: [5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 16, 18, 20, 23, 27, 31],
}


@dataclass
class SbrHeader:
    amp_res: int = 1
    start_freq: int = 5
    stop_freq: int = 0
    xover_band: int = 0
    freq_scale: int = 2
    alter_scale: int = 1
    noise_bands: int = 2
    limiter_bands: int = 2
    limiter_gains: int = 2
    interpol_freq: int = 1
    smoothing_mode: int = 1


def parse_sbr_header(b: Bits) -> SbrHeader:
    h = SbrHeader()
    h.amp_res = b.read(1)
    h.start_freq = b.read(4)
    h.stop_freq = b.read(4)
    h.xover_band = b.read(3)
    b.read(2)                               # bs_reserved
    extra1 = b.read(1)
    extra2 = b.read(1)
    if extra1:
        h.freq_scale = b.read(2)
        h.alter_scale = b.read(1)
        h.noise_bands = b.read(2)
    if extra2:
        h.limiter_bands = b.read(2)
        h.limiter_gains = b.read(2)
        h.interpol_freq = b.read(1)
        h.smoothing_mode = b.read(1)
    return h


def _number_of_bands(bpo: float, start: int, stop: int, warp: bool) -> int:
    octaves = math.log2(stop / start)
    n = octaves * bpo
    if warp:
        n *= 25200.0 / 32768.0 * 2.0      # fdk's 1/1.3 approximation
        n /= 2.0
    return 2 * int(n / 2 + 0.5)


def _calc_bands(start: int, stop: int, num: int) -> list:
    """Band widths on a log scale (spec CalcBands)."""
    widths = []
    previous = stop
    exact = float(stop)
    factor = (start / stop) ** (1.0 / num)
    for _ in range(num):
        exact *= factor
        current = int(exact + 0.5)
        widths.append(previous - current)
        previous = current
    return widths[::-1]


def master_freq_table(fs: int, h: SbrHeader) -> np.ndarray:
    """v_k_master per 4.6.18.3.2.1 (fs = output rate)."""
    try:
        k0 = START_FREQ[fs][h.start_freq]
    except KeyError:
        raise SbrError(f"unsupported SBR rate {fs}")
    if h.stop_freq < 14:
        if fs < 32000:
            stop_min = ((2 * 6000 * 2 * 64) // fs + 1) >> 1
        elif fs < 64000:
            stop_min = ((2 * 8000 * 2 * 64) // fs + 1) >> 1
        else:
            stop_min = ((2 * 10000 * 2 * 64) // fs + 1) >> 1
        diffs = sorted(_calc_bands(stop_min, 64, 13))
        borders = np.cumsum([stop_min] + diffs)
        k2 = int(borders[h.stop_freq])
    elif h.stop_freq == 14:
        k2 = 2 * k0
    else:
        k2 = 3 * k0
    k2 = min(k2, 64)
    if k2 <= k0 or (k2 - k0) > 48:
        raise SbrError("invalid SBR range")

    if h.freq_scale > 0:
        bpo = {1: 12.0, 2: 10.0, 3: 8.0}[h.freq_scale]
        if 1000 * k2 > 2245 * k0:
            k1 = 2 * k0
            n0 = _number_of_bands(bpo, k0, k1, False)
            n1 = _number_of_bands(bpo, k1, k2, bool(h.alter_scale))
            d0 = sorted(_calc_bands(k0, k1, n0))
            d1 = sorted(_calc_bands(k1, k2, n1))
            if d0[-1] > d1[0]:
                change = d0[-1] - d1[0]
                max_change = (d1[-1] - d1[0]) // 2
                change = min(change, max_change)
                d1[0] += change
                d1[-1] -= change
                d1 = sorted(d1)
            master = np.cumsum([k0] + d0 + d1)
        else:
            n0 = _number_of_bands(bpo, k0, k2, False)
            d0 = sorted(_calc_bands(k0, k2, n0))
            master = np.cumsum([k0] + d0)
    else:
        if h.alter_scale == 0:
            dk = 1
            n0 = (k2 - k0) & 254
        else:
            dk = 2
            n0 = (((k2 - k0) >> 1) + 1) & 254
        if n0 < 1:
            raise SbrError("invalid linear scale")
        diffs = [dk] * n0
        k2_diff = k2 - (k0 + n0 * dk)
        i = 0 if k2_diff < 0 else n0 - 1
        incr = 1 if k2_diff < 0 else -1
        while k2_diff != 0:
            diffs[i] -= incr
            i += incr
            k2_diff += incr
        master = np.cumsum([k0] + diffs)
    return master.astype(np.int32)


@dataclass
class FreqTables:
    master: np.ndarray
    f_high: np.ndarray
    f_low: np.ndarray
    f_noise: np.ndarray
    f_lim: np.ndarray
    kx: int
    M: int
    n_high: int
    n_low: int
    n_q: int
    patches: list                      # (target_start, source_start, width)


SHIFT_START_SB = 1


def _closest_entry(goal: int, master: np.ndarray, up: bool) -> int:
    """findClosestEntry: nearest master border (ties resolved by `up`)."""
    arr = np.asarray(master, np.int64)
    lo = arr[np.searchsorted(arr, goal, side="right") - 1] \
        if goal >= arr[0] else arr[0]
    hi_idx = int(np.searchsorted(arr, goal, side="left"))
    hi = arr[min(hi_idx, len(arr) - 1)]
    if up:
        return int(hi if hi >= goal else lo)
    return int(lo if lo <= goal else hi)


def _build_patches(master: np.ndarray, kx: int, usb: int, fs: int) -> list:
    """Transposer patch construction (ISO 14496-3 figure 4.48)."""
    lsb = int(master[0])
    xover_offset = kx - lsb
    desired = ((2048000 * 2) // fs + 1) >> 1
    desired = _closest_entry(desired, master, True)
    source_start = SHIFT_START_SB + xover_offset
    target_stop = lsb + xover_offset
    patches = []
    while target_stop < usb:
        if len(patches) > 6:
            raise SbrError("too many patches")
        target_start = target_stop
        num = desired - target_stop
        if num >= lsb - source_start:
            dist = (target_stop - source_start) & ~1
            num = lsb - (target_stop - dist)
            num = _closest_entry(target_stop + num, master, False) \
                - target_stop
        dist = (num + target_stop - lsb + 1) & ~1
        if num > 0:
            patches.append((target_start, target_stop - dist, num))
            target_stop += num
        source_start = SHIFT_START_SB
        if desired - target_stop < 3:
            desired = usb
    if len(patches) > 1 and patches[-1][2] < 3:
        patches.pop()
    if not patches:
        raise SbrError("no patches")
    return patches


def _build_limiter(f_low: np.ndarray, patches: list, kx: int, M: int,
                   limiter_bands: int) -> np.ndarray:
    """Limiter band borders (env_calc.cpp ResetLimiterBands)."""
    if limiter_bands == 0:
        return np.asarray([0, M], np.int32)
    per_octave = {1: 1.2, 2: 2.0, 3: 3.0}[limiter_bands]
    patch_borders = [p[0] - kx for p in patches] + [M]
    work = [int(k) - kx for k in f_low] + \
        [patch_borders[k] for k in range(1, len(patches))]
    work = sorted(work)
    n = len(work) - 1
    lo = 0
    hi = 1
    while hi <= n:
        k2 = work[hi] + kx
        kx_ = work[lo] + kx
        octaves = math.log2(k2 / kx_) if kx_ > 0 else 1.0
        if octaves * per_octave < 0.49:
            if work[hi] == work[lo]:
                work[hi] = M
                hi += 1
                continue
            if work[hi] not in patch_borders:
                work[hi] = M
                hi += 1
                continue
            if work[lo] not in patch_borders:
                work[lo] = M
        lo = hi
        hi += 1
    out = sorted(set(w for w in work if 0 <= w <= M))
    if out[0] != 0:
        out = [0] + out
    if out[-1] != M:
        out.append(M)
    return np.asarray(out, np.int32)


def derive_tables(fs: int, h: SbrHeader) -> FreqTables:
    master = master_freq_table(fs, h)
    n_master = len(master) - 1
    if h.xover_band >= n_master:
        raise SbrError("xover_band out of range")
    f_high = master[h.xover_band:]
    n_high = len(f_high) - 1
    n_low = n_high - n_high // 2
    if n_high & 1:
        idx = [0] + list(range(1, n_high + 1, 2))
    else:
        idx = list(range(0, n_high + 1, 2))
    f_low = f_high[idx]
    kx = int(f_high[0])
    M = int(f_high[-1]) - kx
    n_q = max(1, round(h.noise_bands * math.log2(f_high[-1] / kx)))
    n_q = min(n_q, 5)
    i = 0
    f_noise = [int(f_low[0])]
    for k in range(1, n_q + 1):
        i += (len(f_low) - 1 - i) // (n_q - k + 1)
        f_noise.append(int(f_low[i]))
    f_noise = np.asarray(f_noise, np.int32)
    patches = _build_patches(master, kx, kx + M, fs)
    f_lim = _build_limiter(f_low, patches, kx, M, h.limiter_bands)
    return FreqTables(master, f_high, f_low, f_noise, f_lim, kx, M,
                      n_high, n_low, n_q, patches)


# ---------------------------------------------------------------------------
# frame data (grid / dtdf / invf / envelopes / noise)
# ---------------------------------------------------------------------------

FIXFIX, FIXVAR, VARFIX, VARVAR = range(4)


@dataclass
class ChannelGrid:
    n_env: int = 1
    t_env: list = field(default_factory=lambda: [0, 16])
    freq_res: list = field(default_factory=lambda: [1])
    n_noise: int = 1
    t_noise: list = field(default_factory=lambda: [0, 16])
    pointer: int = 0
    frame_class: int = FIXFIX
    tran_env: int = -1


@dataclass
class ChannelData:
    grid: ChannelGrid = None
    df_env: list = None
    df_noise: list = None
    invf: list = None
    env: list = None                   # n_env rows of band ints
    noise: list = None                 # n_noise rows of n_q ints
    add_harmonic: np.ndarray = None


def _ceil_log2(x: int) -> int:
    return 0 if x <= 1 else int(math.ceil(math.log2(x)))


def parse_grid(b: Bits) -> ChannelGrid:
    g = ChannelGrid()
    g.frame_class = b.read(2)
    nts = 16
    if g.frame_class == FIXFIX:
        tmp = b.read(2)
        g.n_env = min(4, 1 << tmp)
        g.freq_res = [b.read(1)] * g.n_env
        g.t_env = [round(i * nts / g.n_env) for i in range(g.n_env + 1)]
        g.pointer = 0
    elif g.frame_class == FIXVAR:
        var_bord = b.read(2)
        n_rel = b.read(2)
        g.n_env = n_rel + 1
        rel = [2 * b.read(2) + 2 for _ in range(n_rel)]
        g.pointer = b.read(_ceil_log2(g.n_env + 1))
        fr = [b.read(1) for _ in range(g.n_env)]
        g.freq_res = fr[::-1]
        borders = [nts + var_bord]
        for r in rel:
            borders.append(borders[-1] - r)
        g.t_env = [0] + borders[::-1]
        g.tran_env = (n_rel + 2 - g.pointer) if g.pointer else -1
    elif g.frame_class == VARFIX:
        var_bord = b.read(2)
        n_rel = b.read(2)
        g.n_env = n_rel + 1
        rel = [2 * b.read(2) + 2 for _ in range(n_rel)]
        g.pointer = b.read(_ceil_log2(g.n_env + 1))
        g.freq_res = [b.read(1) for _ in range(g.n_env)]
        borders = [var_bord]
        for r in rel:
            borders.append(borders[-1] + r)
        g.t_env = borders + [nts]
        g.tran_env = -1 if g.pointer < 2 else g.pointer - 1
    else:                               # VARVAR
        bord0 = b.read(2)
        bord1 = b.read(2)
        nrel0 = b.read(2)
        nrel1 = b.read(2)
        g.n_env = min(5, nrel0 + nrel1 + 1)
        rel0 = [2 * b.read(2) + 2 for _ in range(nrel0)]
        rel1 = [2 * b.read(2) + 2 for _ in range(nrel1)]
        g.pointer = b.read(_ceil_log2(g.n_env + 1))
        g.freq_res = [b.read(1) for _ in range(g.n_env)]
        lo = [bord0]
        for r in rel0:
            lo.append(lo[-1] + r)
        hi = [nts + bord1]
        for r in rel1:
            hi.append(hi[-1] - r)
        g.t_env = sorted(set(lo + hi))
        g.tran_env = ((nrel0 + nrel1 + 2) - g.pointer) if g.pointer else -1
    if g.pointer > g.n_env + 1:
        raise SbrError("bs_pointer out of range")
    if g.n_env == 1:
        g.n_noise = 1
        g.t_noise = [g.t_env[0], g.t_env[-1]]
    else:
        g.n_noise = 2
        if g.frame_class == FIXFIX:
            mi = g.n_env // 2
        elif g.frame_class in (VARFIX,):
            if g.pointer == 0:
                mi = 1
            elif g.pointer == 1:
                mi = g.n_env - 1
            else:
                mi = g.pointer - 1
        else:
            if g.pointer > 1:
                mi = g.n_env + 1 - g.pointer
            else:
                mi = g.n_env - 1
        if not 0 <= mi < len(g.t_env):
            raise SbrError("corrupt envelope grid")
        g.t_noise = [g.t_env[0], g.t_env[mi], g.t_env[-1]]
    return g


def parse_sbr_data(b: Bits, hdr: SbrHeader, ft: FreqTables, stereo: bool,
                   prev_state: list) -> tuple:
    """sbr_single_channel_element / sbr_channel_pair_element payload
    (after the header): ([ChannelData], coupling).  ``prev_state`` carries
    (prev_env_row, prev_freq_res, prev_noise_row) per channel across
    frames, for the delta-time coded envelopes."""
    chans = [ChannelData(), ChannelData()] if stereo else [ChannelData()]
    coupling = False
    if stereo:
        if b.read(1):                   # bs_data_extra
            b.read(4)
            b.read(4)
        coupling = bool(b.read(1))
    else:
        if b.read(1):
            b.read(4)

    if stereo and coupling:
        g = parse_grid(b)
        chans[0].grid = g
        chans[1].grid = ChannelGrid(g.n_env, list(g.t_env),
                                    list(g.freq_res), g.n_noise,
                                    list(g.t_noise), g.pointer,
                                    g.frame_class, g.tran_env)
    else:
        chans[0].grid = parse_grid(b)
        if stereo:
            chans[1].grid = parse_grid(b)

    for ch in chans:
        g = ch.grid
        ch.df_env = [b.read(1) for _ in range(g.n_env)]
        ch.df_noise = [b.read(1) for _ in range(g.n_noise)]
    if stereo and coupling:
        chans[0].invf = [b.read(2) for _ in range(ft.n_q)]
        chans[1].invf = list(chans[0].invf)
    else:
        chans[0].invf = [b.read(2) for _ in range(ft.n_q)]
        if stereo:
            chans[1].invf = [b.read(2) for _ in range(ft.n_q)]

    def _map_prev(prev, prev_res, k, res):
        if prev is None:
            return 0
        if prev_res == res:
            return int(prev[min(k, len(prev) - 1)])
        if res == 1 and prev_res == 0:
            f = ft.f_high[k]
            i = int(np.searchsorted(ft.f_low, f, side="right") - 1)
            return int(prev[min(max(i, 0), len(prev) - 1)])
        f = ft.f_low[k]
        i = int(np.searchsorted(ft.f_high, f, side="right") - 1)
        return int(prev[min(max(i, 0), len(prev) - 1)])

    def read_env(ch: ChannelData, second: bool):
        g = ch.grid
        amp = hdr.amp_res
        if g.frame_class == FIXFIX and g.n_env == 1:
            amp = 0
        bal = stereo and coupling and second
        if amp:
            t_book = T["huff_EnvBalance11T" if bal else "huff_EnvLevel11T"]
            f_book = T["huff_EnvBalance11F" if bal else "huff_EnvLevel11F"]
            start_bits = 5 if bal else 6
        else:
            t_book = T["huff_EnvBalance10T" if bal else "huff_EnvLevel10T"]
            f_book = T["huff_EnvBalance10F" if bal else "huff_EnvLevel10F"]
            start_bits = 6 if bal else 7
        rows = []
        for e in range(g.n_env):
            nb = ft.n_high if g.freq_res[e] else ft.n_low
            row = np.zeros(nb, np.int32)
            if ch.df_env[e] == 0:
                row[0] = b.read(start_bits)
                if bal:
                    row[0] *= 2
                for k in range(1, nb):
                    d = _huff(b, f_book)
                    row[k] = row[k - 1] + (d * 2 if bal else d)
            else:
                prev = rows[e - 1] if e > 0 else ch.prev_env
                prev_res = g.freq_res[e - 1] if e > 0 else ch.prev_res
                for k in range(nb):
                    d = _huff(b, t_book) * (2 if bal else 1)
                    row[k] = _map_prev(prev, prev_res, k, g.freq_res[e]) + d
            rows.append(row)
        ch.env = rows

    def read_noise(ch: ChannelData, second: bool):
        g = ch.grid
        bal = stereo and coupling and second
        t_book = T["huff_NoiseBalance11T" if bal else "huff_NoiseLevel11T"]
        f_book = T["huff_EnvBalance11F" if bal else "huff_EnvLevel11F"]
        rows = []
        for e in range(g.n_noise):
            row = np.zeros(ft.n_q, np.int32)
            if ch.df_noise[e] == 0:
                row[0] = b.read(5)
                if bal:
                    row[0] *= 2
                for k in range(1, ft.n_q):
                    d = _huff(b, f_book)
                    row[k] = row[k - 1] + (d * 2 if bal else d)
            else:
                prev = rows[e - 1] if e > 0 else ch.prev_noise
                for k in range(ft.n_q):
                    d = _huff(b, t_book) * (2 if bal else 1)
                    row[k] = (prev[k] if prev is not None else 0) + d
            rows.append(row)
        ch.noise = rows

    for i, ch in enumerate(chans):
        if prev_state[i] is not None:
            ch.prev_env, ch.prev_res, ch.prev_noise = prev_state[i]
        else:
            ch.prev_env, ch.prev_res, ch.prev_noise = None, 1, None
    if stereo and not coupling:
        read_env(chans[0], False)
        read_env(chans[1], False)
        read_noise(chans[0], False)
        read_noise(chans[1], False)
    else:
        read_env(chans[0], False)
        read_noise(chans[0], False)
        if stereo:
            read_env(chans[1], True)
            read_noise(chans[1], True)

    for ch in chans:
        ch.add_harmonic = np.zeros(ft.n_high, np.int32)
        if b.read(1):
            for k in range(ft.n_high):
                ch.add_harmonic[k] = b.read(1)
    if b.read(1):                       # bs_extended_data
        cnt = b.read(4)
        if cnt == 15:
            cnt += b.read(8)
        end = min(b.pos + 8 * cnt, b.limit)
        while end - b.pos > 7:
            if b.read(2) == 2:
                raise SbrError("parametric stereo (v2): not HE-AAC v1")
            while end - b.pos >= 8:
                b.read(8)
        while b.pos < end:
            b.read(1)
    for i, ch in enumerate(chans):
        prev_state[i] = (ch.env[-1], ch.grid.freq_res[-1], ch.noise[-1])
    return chans, coupling


def map_invf_bw(invf, prev_invf) -> np.ndarray:
    """Chirp level per noise band from the current and previous inverse-
    filtering modes (fdk mapInvfMode)."""
    out = np.empty(len(invf), np.float64)
    for i in range(len(invf)):
        m, pm = invf[i], prev_invf[i]
        if m == 1:
            out[i] = 0.6 if pm == 0 else 0.75
        elif m == 2:
            out[i] = 0.90
        elif m == 3:
            out[i] = 0.98
        else:
            out[i] = 0.6 if pm == 1 else 0.0
    return out


#: Envelope dequantisation reference: E = 2^(sf/a) * 64 * ENERGY_CAL.
ENERGY_CAL = 262144.0
#: The previous envelope's share of the gains and noise levels in the
#: first 4 slots of an envelope (libSBRdec sbr_smoothFilter).
_SMOOTH_FILTER = (0.66666666666666, 0.36516383427084,
                  0.14699433520835, 0.03183050093751)


# ---------------------------------------------------------------------------
# the SBR payload of an ADTS frame
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4096)
def sbr_payload(frame: bytes):
    """(payload bytes, nbits, crc) of the frame's SBR extension in its FIL
    element, or None.  The channel elements are parsed (and skipped) with
    ``reference/aac.py``."""
    h = R.parse_adts_header(frame)
    if h is None:
        raise R.AacError("not an ADTS frame")
    br = R.BitReader(frame, h.header_bytes * 8)
    found = None
    while True:
        el = br.read(3)
        if el == R.ID_END:
            return found
        if el in (R.ID_SCE, R.ID_LFE):
            br.read(4)
            R._parse_ics(br, h.rate_index)
        elif el == R.ID_CPE:
            br.read(4)
            common = br.read(1)
            shared = None
            if common:
                shared = R._parse_ics_info(br)
                ms_present = br.read(2)
                if ms_present == 1:
                    br.skip(len(shared.window_groups()) * shared.max_sfb)
            R._parse_ics(br, h.rate_index, common, shared)
            R._parse_ics(br, h.rate_index, common, shared)
        elif el == R.ID_DSE:
            br.read(4)
            align = br.read(1)
            cnt = br.read(8)
            if cnt == 255:
                cnt += br.read(8)
            if align:
                br.align_byte()
            br.skip(8 * cnt)
        elif el == R.ID_FIL:
            cnt = br.read(4)
            if cnt == 15:
                cnt += br.read(8) - 1
            if cnt > 0:
                ext = br.read(4)
                nbits = cnt * 8 - 4
                if ext in (EXT_SBR_DATA, EXT_SBR_DATA_CRC):
                    payload = bytearray((nbits + 7) // 8)
                    for i in range(nbits):
                        if br.read(1):
                            payload[i >> 3] |= 1 << (7 - (i & 7))
                    found = (bytes(payload), nbits, ext == EXT_SBR_DATA_CRC)
                else:
                    br.skip(nbits)
        else:
            raise R.AacError(f"unsupported syntactic element {el}")


# ---------------------------------------------------------------------------
# the SBR decoder (SbrDecoder), float64 tensors
# ---------------------------------------------------------------------------

C128 = torch.complex128
F64 = torch.float64


@contextlib.contextmanager
def _no_tf32():
    """TF32 off for torch's float32 products and convolutions while the
    reference runs (its own products are float64 on the CPU)."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def analysis(pcm: np.ndarray, matmul: Callable) -> torch.Tensor:
    """32-band QMF analysis of one channel's whole core PCM (n * 1024,)
    from a zero history: (n * 32, 32) complex slots.  Slot l's window is
    the 320 samples ending with its 32 new ones."""
    x = torch.cat([torch.zeros(320, dtype=F64), torch.from_numpy(
        np.asarray(pcm, np.float64))])
    ns = len(pcm) // 32
    win = x.unfold(0, 320, 32)[1:ns + 1]                # (ns, 320)
    K = torch.from_numpy(np.ascontiguousarray(K_ANA.T))
    return torch.complex(matmul(win, K.real.contiguous()),
                         matmul(win, K.imag.contiguous()))


def synthesis(slots: torch.Tensor, matmul: Callable) -> torch.Tensor:
    """64-band QMF synthesis of one channel's whole run of adjusted slots
    (ns, 64) from a zero state: (ns * 64,) float64.  Each slot's bands
    contribute a 768-sample response, overlap-added at a hop of 64."""
    ns = slots.shape[0]
    syn_re = torch.from_numpy(np.ascontiguousarray(SYN64[:, 0]))
    syn_im = torch.from_numpy(np.ascontiguousarray(SYN64[:, 1]))
    contrib = matmul(slots.real.contiguous(), syn_re) \
        + matmul(slots.imag.contiguous(), syn_im)       # (ns, 768)
    z = contrib.reshape(ns, 12, 64)
    acc = torch.zeros((ns + 12, 64), dtype=F64)
    for j in range(12):
        acc[j:j + ns] += z[:, j]
    return acc.reshape(-1)[:ns * 64]


class ChannelState:
    """One channel's SBR state carried from frame to frame."""

    def __init__(self):
        # buffer slots [32, 38) of the previous frame, HF-generated and
        # adjusted up to its last border
        self.x_hist = torch.zeros((6, 64), dtype=C128)
        # the transposer's LPC prehistory: previous buffer slots 30, 31
        self.lpp_pre = torch.zeros((2, 64), dtype=C128)
        self.bw = np.zeros(5, np.float64)
        self.prev_invf = np.zeros(5, np.int64)
        self.noise_index = 0
        self.sine_index = 0
        self.prev_harm_bins: set = set()
        self.prev_tran_env = -1
        self.filt_gain = None
        self.filt_noise = None


class SbrDecoder:
    """One stream's SBR: ``parse`` each frame's payload in turn, then
    ``reconstruct`` each channel's frames from the core's analysis slots."""

    def __init__(self, core_rate: int):
        self.out_rate = core_rate * 2
        self.header: Optional[SbrHeader] = None
        self.ft: Optional[FreqTables] = None
        self._prev = [None, None]
        self.noise_tab = torch.from_numpy(NOISE_TAB)

    def parse(self, payload: bytes, nbits: int, stereo: bool, crc: bool):
        b = Bits(payload, 0, nbits)
        if crc:
            b.read(10)
        if b.read(1):                     # bs_header_flag
            h = parse_sbr_header(b)
            if h != self.header:
                self.header = h
                self.ft = derive_tables(self.out_rate, h)
        if self.header is None:
            raise SbrError("SBR data before header")
        return parse_sbr_data(b, self.header, self.ft, stereo, self._prev)

    def dequant(self, grid: ChannelGrid, env_rows, noise_rows):
        amp = self.header.amp_res
        if grid.frame_class == FIXFIX and grid.n_env == 1:
            amp = 0
        a = 2.0 if amp == 0 else 1.0
        E = [np.exp2(np.asarray(r, np.float64) / a) * (64.0 * ENERGY_CAL)
             for r in env_rows]
        Q = [np.exp2(6.0 - np.asarray(r, np.float64)) for r in noise_rows]
        return E, Q, a

    @staticmethod
    def unmap_coupled(E0, Q0, E1, Q1, a):
        """Channel-pair unmapping: right = 2 L / (1 + b), left = b right,
        b from the balance channel's raw values."""
        outL_E, outR_E = [], []
        for e0, e1 in zip(E0, E1):
            b = np.exp2(np.asarray(e1, np.float64) / a - 12.0)
            r = 2.0 * e0 / (1.0 + b)
            outL_E.append(b * r)
            outR_E.append(r)
        outL_Q, outR_Q = [], []
        for q0, q1 in zip(Q0, Q1):
            b = np.exp2(np.asarray(q1, np.float64) - 12.0)
            r = 2.0 * q0 / (1.0 + b)
            outL_Q.append(b * r)
            outR_Q.append(r)
        return (outL_E, outL_Q), (outR_E, outR_Q)

    def levels(self, chans: list, coupling: bool) -> list:
        """[(E, Q)] per channel of one frame: dequantised, and unmapped
        where the pair is coupled."""
        EQ = [self.dequant(c.grid, c.env, c.noise) for c in chans]
        if len(chans) == 2 and coupling:
            a = EQ[0][2]
            (EL, QL), (ER, QR) = self.unmap_coupled(
                EQ[0][0], EQ[0][1], chans[1].env, chans[1].noise, a)
            return [(EL, QL), (ER, QR)]
        return [(E, Q) for E, Q, _ in EQ]

    def reconstruct(self, st: ChannelState, Xlow: torch.Tensor,
                    data: ChannelData, E, Q) -> torch.Tensor:
        """One frame of one channel: Xlow (32, 32) its analysis slots.
        The 38-slot buffer is [6 carried slots | 32 new ones]; the HF
        generator and the envelope adjuster run over buffer slots
        [2 t_env[0], 2 t_env[-1]); the frame outputs buffer slots [0, 32)
        and carries [32, 38) into the next.  Returns (32, 64) complex."""
        ft = self.ft
        nsl = Xlow.shape[0]
        X = torch.zeros((nsl, 64), dtype=C128)
        X[:, :32] = Xlow
        Xbuf = torch.cat([st.x_hist, X])                # (38, 64)
        nbuf = Xbuf.shape[0]
        g = data.grid
        kx, M = ft.kx, ft.M
        start = max(0, min(2 * g.t_env[0], nbuf))
        stop = max(start, min(2 * g.t_env[-1], nbuf))
        # chirp factors, one a noise band, smoothed across frames
        nq = ft.n_q
        nbs = map_invf_bw(data.invf[:nq], st.prev_invf[:nq])
        prev = st.bw[:nq]
        bw = np.where(nbs < prev, 0.75 * nbs + 0.25 * prev,
                      0.90625 * nbs + 0.09375 * prev)
        bw[bw < 0.015625] = 0.0
        bw = np.minimum(bw, 0.99609375)
        st.bw[:nq] = bw
        st.prev_invf[:nq] = data.invf[:nq]

        # HF generation: a 2nd-order LPC a source band over its 2-slot
        # prehistory + 38 buffer slots, then the chirped patch of buffer
        # slots [start, stop) of each target band
        tgt, src = [], []
        for (t0, s0, width) in ft.patches:
            for j in range(width):
                k, p = t0 + j, s0 + j
                if kx <= k < kx + M and 0 <= p < kx:
                    tgt.append(k)
                    src.append(p)
        if tgt and stop > start:
            cols = sorted(set(src))
            z = torch.cat([st.lpp_pre[:, cols], Xbuf[:, cols]])  # (40, P)
            x0, x1, x2 = z[2:], z[1:-1], z[:-2]

            def vdot(a, b):
                return (a.conj() * b).sum(0)

            phi01 = vdot(x1, x0)
            phi02 = vdot(x2, x0)
            phi11 = vdot(x1, x1).real
            phi12 = vdot(x2, x1)
            phi22 = vdot(x2, x2).real
            d = phi22 * phi11 - phi12.abs() ** 2 / 1.000001
            d_ok = d.abs() > 1e-9
            a1 = torch.where(d_ok, (phi01 * phi12 - phi02 * phi11)
                             / torch.where(d_ok, d, 1.0), 0.0)
            p_ok = phi11 > 1e-9
            a0 = torch.where(p_ok, -(phi01 + a1 * phi12.conj())
                             / torch.where(p_ok, phi11, 1.0), 0.0)
            big = (a0.abs() >= 4) | (a1.abs() >= 4)
            a0 = torch.where(big, 0.0, a0)
            a1 = torch.where(big, 0.0, a1)
            at = [cols.index(p) for p in src]
            qi = np.clip(np.searchsorted(ft.f_noise, tgt, side="right") - 1,
                         0, nq - 1)
            bwk = torch.from_numpy(bw[qi])
            a0k, a1k, zk = a0[at], a1[at], z[:, at]
            sl = torch.arange(start, stop)
            Xbuf[start:stop, tgt] = (zk[sl + 2] + bwk * a0k * zk[sl + 1]
                                     + bwk * bwk * a1k * zk[sl])
        Xadj = self.adjust(st, Xbuf, data, E, Q)
        st.lpp_pre = Xadj[nsl - 2:nsl].clone()
        st.x_hist = Xadj[nsl:nsl + 6].clone()
        return Xadj[:nsl]

    def adjust(self, st: ChannelState, Xbuf: torch.Tensor,
               data: ChannelData, E, Q) -> torch.Tensor:
        """The envelope adjuster over the buffer, in place: each
        envelope's gains (with the limiter and its boost), smoothed over
        the first 4 slots of a non-attack envelope, noise and sinusoids."""
        ft, hdr = self.ft, self.header
        g = data.grid
        kx, M = ft.kx, ft.M
        # sine start envelope per mid bin: a sine flagged last frame
        # continues from envelope 0, a new one starts at the transient
        sine_start = {}
        cur_bins = set()
        for b_ in range(ft.n_high):
            if data.add_harmonic[b_]:
                mid = (int(ft.f_high[b_]) + int(ft.f_high[b_ + 1])) // 2 - kx
                if 0 <= mid < M:
                    cur_bins.add(mid)
                    sine_start[mid] = 0 if mid in st.prev_harm_bins \
                        else max(g.tran_env, 0)
        prev_tran = st.prev_tran_env
        st.prev_harm_bins = cur_bins
        st.prev_tran_env = 0 if g.tran_env == g.n_env else -1
        limgain = {0: 10 ** 0.15, 1: 10 ** 0.3,
                   2: 10 ** 0.45, 3: 1e10}[hdr.limiter_gains]
        bins = np.arange(M)
        parity = torch.from_numpy(np.where(((bins + kx) & 1) > 0, -1.0, 1.0))
        for e in range(g.n_env):
            sl0 = max(0, min(g.t_env[e] * 2, Xbuf.shape[0]))
            sl1 = max(sl0, min(g.t_env[e + 1] * 2, Xbuf.shape[0]))
            if sl1 <= sl0:
                continue
            fr = g.freq_res[e]
            bands = ft.f_high if fr else ft.f_low
            nb = len(bands) - 1
            Erow = np.asarray(E[e], np.float64)
            ne = 0
            for q in range(g.n_noise):
                if g.t_noise[q] <= g.t_env[e] < g.t_noise[q + 1]:
                    ne = q
            Qrow = np.asarray(Q[ne], np.float64)
            Emap = np.zeros(M)
            Qmap = np.zeros(M)
            sine = np.zeros(M, bool)
            for b_ in range(nb):
                lo, hi = int(bands[b_]) - kx, int(bands[b_ + 1]) - kx
                Emap[lo:hi] = Erow[min(b_, len(Erow) - 1)]
            for q in range(ft.n_q):
                lo = int(ft.f_noise[q]) - kx
                hi = int(ft.f_noise[q + 1]) - kx
                Qmap[lo:hi] = Qrow[min(q, len(Qrow) - 1)]
            for mid, s0 in sine_start.items():
                if e >= s0:
                    sine[mid] = True
            no_noise_env = (e == g.tran_env or e == prev_tran)
            Xe = Xbuf[sl0:sl1, kx:kx + M]
            Ecurr = (Xe.abs() ** 2).mean(0).numpy()
            if not hdr.interpol_freq:
                for b_ in range(nb):
                    lo, hi = int(bands[b_]) - kx, int(bands[b_ + 1]) - kx
                    if hi > lo:
                        Ecurr[lo:hi] = Ecurr[lo:hi].mean()
            sine_in_band = np.zeros(M, bool)
            for b_ in range(nb):
                lo, hi = int(bands[b_]) - kx, int(bands[b_ + 1]) - kx
                if sine[lo:hi].any():
                    sine_in_band[lo:hi] = True
            qfac = Qmap / (1.0 + Qmap)
            gain = np.where(
                sine_in_band,
                np.sqrt(Emap * qfac / np.maximum(Ecurr, 1e-12)),
                np.sqrt(Emap / np.maximum(Ecurr, 1e-12)
                        / (1.0 if no_noise_env else 1.0 + Qmap)))
            noise_lvl = np.sqrt(Emap * qfac)
            sine_lvl = np.where(sine, np.sqrt(Emap / (1.0 + Qmap)), 0.0)
            for li in range(len(ft.f_lim) - 1):
                lo, hi = int(ft.f_lim[li]), int(ft.f_lim[li + 1])
                if hi <= lo:
                    continue
                gmax = min(limgain * np.sqrt(
                    (Emap[lo:hi].sum() + 1e-12)
                    / (Ecurr[lo:hi].sum() + 1e-12)), 1e10)
                ratio = np.minimum(1.0, gmax
                                   / np.maximum(gain[lo:hi], 1e-12))
                noise_lvl[lo:hi] *= ratio
                gain[lo:hi] = np.minimum(gain[lo:hi], gmax)
                target = Emap[lo:hi].sum()
                noise_acc = 0.0 if no_noise_env else \
                    (noise_lvl[lo:hi] ** 2 * (sine_lvl[lo:hi] == 0.0)).sum()
                achieved = (Ecurr[lo:hi] * gain[lo:hi] ** 2).sum() \
                    + noise_acc + (sine_lvl[lo:hi] ** 2).sum()
                boost = min(np.sqrt(target / max(achieved, 1e-12)),
                            1.584893192)
                gain[lo:hi] *= boost
                noise_lvl[lo:hi] *= boost
                sine_lvl[lo:hi] *= boost
            smooth_len = 0 if no_noise_env or hdr.smoothing_mode else 4
            if st.filt_gain is None:
                st.filt_gain = gain.copy()
                st.filt_noise = noise_lvl.copy()
            # the envelope's n slots at once: slot k's gains (smoothed
            # for k < smooth_len), noise entries and sine phase
            n = sl1 - sl0
            r = np.zeros((n, 1))
            ks = min(smooth_len, n)
            r[:ks, 0] = _SMOOTH_FILTER[:ks]
            g_sl = torch.from_numpy(r * st.filt_gain + (1.0 - r) * gain)
            n_sl = torch.from_numpy(r * st.filt_noise
                                    + (1.0 - r) * noise_lvl)
            k = np.arange(n)[:, None]
            idx = (st.noise_index + 1 + bins[None] + k * M) & 511
            st.noise_index = (st.noise_index + n * M) & 511
            rows = Xbuf[sl0:sl1, kx:kx + M] * g_sl
            if not no_noise_env:
                sine_t = torch.from_numpy(sine)
                rows = rows + self.noise_tab[torch.from_numpy(idx)] \
                    * torch.where(sine_t, 0.0, n_sl)
            if sine.any():
                ph = torch.from_numpy((st.sine_index + k) & 3)
                amp = torch.from_numpy(sine_lvl)
                re = torch.where(ph == 0, amp, torch.where(ph == 2, -amp,
                                                           0.0))
                im = torch.where(ph == 1, amp * parity,
                                 torch.where(ph == 3, -amp * parity, 0.0))
                rows = rows + torch.complex(re, im)
            st.sine_index = (st.sine_index + n) & 3
            Xbuf[sl0:sl1, kx:kx + M] = rows
            st.filt_gain = gain.copy()
            st.filt_noise = noise_lvl.copy()
        return Xbuf


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------

def decode_stream(data: bytes, cell: dict, matmul: Callable = np.matmul,
                  core: Optional[R.Decoder] = None) -> np.ndarray:
    """(channels, frames * 2048) float64 PCM of one HE-AAC v1 stream, from
    its first frame.  ``matmul`` computes the core IMDCT's and the QMF
    stages' products (float64 here; the control passes TF32's); ``core``,
    a core decoder with that ``matmul``, keeps its parsed frames from
    stream to stream."""
    def mm(a, b):
        if matmul is np.matmul:
            return torch.matmul(a, b)
        return torch.from_numpy(matmul(a.numpy(), b.numpy()))

    frames = R.split_frames(data)
    if not frames:
        return np.zeros((2, 0))
    core = (core or R.Decoder(matmul)).decode_stream(
        data, R.pns_rows("serving", cell))
    C = core.shape[0]
    h = R.parse_adts_header(frames[0])
    dec = SbrDecoder(R.SAMPLE_RATES[h.rate_index])
    with _no_tf32():
        Xlow = [analysis(core[c], mm) for c in range(C)]   # (F*32, 32)
        states = [ChannelState() for _ in range(C)]
        slots = [[] for _ in range(C)]
        for f, frame in enumerate(frames):
            pl = sbr_payload(frame)
            if pl is None:
                raise SbrError("frame without SBR payload")
            chans, coupling = dec.parse(*pl[:2], stereo=(C == 2),
                                        crc=pl[2])
            for c, (E, Q) in enumerate(dec.levels(chans, coupling)):
                slots[c].append(dec.reconstruct(
                    states[c], Xlow[c][32 * f:32 * (f + 1)], chans[c], E,
                    Q))
        return np.stack([synthesis(torch.cat(s), mm).numpy()
                         for s in slots])


def expected(content: dict, indices, cell: dict,
             matmul: Callable = np.matmul) -> dict:
    """{stream index: float64 reference PCM} for ``indices``."""
    core = R.Decoder(matmul)
    return {i: decode_stream(content["streams"][i], cell, matmul, core)
            for i in sorted(set(indices))}


def compare(content: dict, outputs: list, path: str, cell: dict) -> dict:
    """``outputs``: (stream index, PCM) pairs the timed path produced.
    Each of the content's ``check`` streams is decoded once and every
    output of it is held to that.  Returns {"pcm_gap_lsb": the widest
    gap}."""
    t0 = time.perf_counter()
    check = set(content["check"])
    kept = [(i, pcm) for i, pcm in outputs if i in check]
    refs = expected(content, [i for i, _ in kept], cell)
    gap = max((R.pcm_gap(pcm, refs[i]) for i, pcm in kept), default=0.0)
    print(f"he_aac reference: {len(refs)} streams, {len(kept)} outputs "
          f"compared in {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    return {"pcm_gap_lsb": gap}


def lower_precision(content: dict, outputs: list, path: str,
                    cell: dict) -> list:
    """The control: the reference in the program's place with its core
    IMDCT and QMF products in TF32 (``reference/aac.tf32_matmul``), the
    precision below the float32 the configuration states, rounded to
    16-bit PCM as the program rounds; for the streams a run checks."""
    check = set(content["check"])
    refs = expected(content, [i for i, _ in outputs if i in check], cell,
                    R.tf32_matmul)
    return [(i, np.clip(np.rint(refs[i]), -32768, 32767).astype(np.int32))
            for i in refs]
