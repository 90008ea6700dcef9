"""SBR (Spectral Band Replication) decoder — HE-AAC v1 support.

Parity target: the reference's fdk-aac adapter decodes HE-AAC
(OpenHome/Media/Codec/AacFdkBase.cpp over thirdparty/fdk-aac/libSBRdec);
this module implements the SBR payload decode from ISO/IEC 14496-3
4.6.18 — bitstream (header, grids, envelopes, noise floors), frequency
band derivation, LPC-based high-frequency transposition, envelope
adjustment, and the 32-band analysis / 64-band synthesis QMF pair.

TPU-first shape: both QMF stages and the HF generator are expressed as
dense matmuls over (slots x bands) blocks (kernels measured from the
normative filterbank, tools/extract_sbr_tables.py), so the whole
reconstruction lifts onto the MXU; this module runs them in numpy for
the codec's correctness path.

SBR is parametric above the crossover, so output is conformance-bounded
(not bit-exact) against libSBRdec; tests/test_sbr.py asserts SNR vs the
fdk oracle decode of the same streams.
"""

from __future__ import annotations

import math
import os
import pathlib
from dataclasses import dataclass, field

import numpy as np

_TABLES = None


def tables():
    global _TABLES
    if _TABLES is None:
        p = pathlib.Path(__file__).with_name("sbr_tables.npz")
        _TABLES = dict(np.load(p))
    return _TABLES


# ---------------------------------------------------------------------------
# bit reader over a FIL-extension payload
# ---------------------------------------------------------------------------


class Bits:
    def __init__(self, data: bytes, bitpos: int = 0, nbits: int | None = None):
        self.data = data
        self.pos = bitpos
        self.limit = nbits if nbits is not None else len(data) * 8

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            if self.pos >= self.limit:
                raise SbrError("SBR payload overrun")
            byte = self.data[self.pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def left(self) -> int:
        return self.limit - self.pos


class SbrError(Exception):
    pass


def _huff(bits: Bits, book: np.ndarray) -> int:
    """Walk a (n, 2) binary-tree book; a negative entry is a leaf and
    decodes as entry + 64 (libSBRdec huff_dec convention)."""
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
                # modifyBands: increase the smallest of d1
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
    i = int(np.argmin(np.abs(arr - goal)))
    lo = arr[np.searchsorted(arr, goal, side="right") - 1] \
        if goal >= arr[0] else arr[0]
    hi_idx = int(np.searchsorted(arr, goal, side="left"))
    hi = arr[min(hi_idx, len(arr) - 1)]
    if up:
        return int(hi if hi >= goal else lo)
    return int(lo if lo <= goal else hi)


def _build_patches(master: np.ndarray, kx: int, usb: int,
                   fs: int) -> list:
    """Transposer patch construction (ISO 14496-3 figure 4.48; mirrors
    libSBRdec lpp_tran.cpp resetLppTransposer behaviour)."""
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
    """Limiter band borders (mirrors env_calc.cpp ResetLimiterBands)."""
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
                work[hi] = kx + M - kx      # mark as removed (highSubband)
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
    tran_env: int = -1          # transient envelope (env_extr frameInfo)


@dataclass
class ChannelData:
    grid: ChannelGrid = None
    df_env: list = None
    df_noise: list = None
    invf: list = None
    env: np.ndarray = None             # (n_env, bands) ints
    noise: np.ndarray = None           # (n_noise, n_q) ints
    add_harmonic: np.ndarray = None
    ps: "PsData" = None                # parametric stereo (channel 0)


@dataclass
class PsData:
    """One frame of parametric-stereo data (ISO 14496-3 8.4.2.2
    ps_data(); float reformulation target: libSBRdec psbitdec.cpp
    ReadPsData).  Header fields persist across frames until the next
    bs_enable_header."""
    header_valid: bool = False
    enable_iid: bool = False
    mode_iid: int = 0
    enable_icc: bool = False
    mode_icc: int = 0
    enable_ext: bool = False
    frame_class: int = 0
    n_env: int = 0
    borders: list = None               # var-border envelope stops
    iid_index: list = None             # per env, raw huffman deltas
    iid_dt: list = None
    icc_index: list = None
    icc_dt: list = None


_PS_FIX_ENV = (0, 1, 2, 4)             # aFixNoEnvDecode
_PS_BINS = (10, 20, 34)                # low/mid/hi-res IID+ICC bins


def parse_ps_data(b: Bits, end: int, prev: PsData = None) -> PsData:
    """ps_data() within an sbr extension block ending at bit ``end``
    (psbitdec.cpp:436-593).  Header fields carry over from ``prev``
    when bs_enable_header is 0; returns None (with the block consumed)
    on unsupported iid/icc modes, like the reference.  IPD/OPD
    extension payloads are parsed and skipped — deliberately matching
    the reference product: fdk's PS decoder "does not implemet
    IPD/OPD" and "IPD/OPD data is ignored and set to 0"
    (thirdparty/fdk-aac/libSBRdec/src/psdec.h:96-98), so applying them
    would *diverge* from the fdk-based reference renderer."""
    T = tables()
    ps = PsData()
    if prev is not None:
        ps.header_valid = prev.header_valid
        ps.enable_iid, ps.mode_iid = prev.enable_iid, prev.mode_iid
        ps.enable_icc, ps.mode_icc = prev.enable_icc, prev.mode_icc
        ps.enable_ext = prev.enable_ext
    if b.read(1):                       # bs_enable_header
        ps.header_valid = True
        ps.enable_iid = bool(b.read(1))
        if ps.enable_iid:
            ps.mode_iid = b.read(3)
        ps.enable_icc = bool(b.read(1))
        if ps.enable_icc:
            ps.mode_icc = b.read(3)
        ps.enable_ext = bool(b.read(1))
    ps.frame_class = b.read(1)
    if ps.frame_class == 0:
        ps.n_env = _PS_FIX_ENV[b.read(2)]
    else:
        ps.n_env = 1 + b.read(2)
        ps.borders = [b.read(5) + 1 for _ in range(ps.n_env)]
    if ps.mode_iid > 5 or ps.mode_icc > 5 or not ps.header_valid:
        while b.pos < end:              # discard the rest of the block
            b.read(1)
        return None
    fine_iid = ps.mode_iid > 2
    res_iid = ps.mode_iid - 3 if fine_iid else ps.mode_iid
    res_icc = ps.mode_icc - 3 if ps.mode_icc > 2 else ps.mode_icc
    ps.iid_index, ps.iid_dt = [], []
    if ps.enable_iid:
        for _e in range(ps.n_env):
            dt = b.read(1)
            book = T["ps_PsIidFineTime" if fine_iid else "ps_PsIidTime"]                 if dt else                 T["ps_PsIidFineFreq" if fine_iid else "ps_PsIidFreq"]
            ps.iid_index.append(
                [_huff(b, book) for _ in range(_PS_BINS[res_iid])])
            ps.iid_dt.append(dt)
    ps.icc_index, ps.icc_dt = [], []
    if ps.enable_icc:
        for _e in range(ps.n_env):
            dt = b.read(1)
            book = T["ps_PsIccTime"] if dt else T["ps_PsIccFreq"]
            ps.icc_index.append(
                [_huff(b, book) for _ in range(_PS_BINS[res_icc])])
            ps.icc_dt.append(dt)
    if ps.enable_ext:
        cnt = b.read(4)
        if cnt == 15:
            cnt += b.read(8)
        for _ in range(cnt):
            b.read(8)
    return ps


def _ps_delta_decode(enable: bool, raw: list, prev: np.ndarray,
                     dt: int, n: int, stride: int,
                     lo: int, hi: int) -> np.ndarray:
    """psbitdec.cpp deltaDecodeArray: freq deltas accumulate across
    bins, time deltas reference the previous (smeared) row at stride
    positions; low-res rows are then smeared to double length."""
    out = np.zeros(n * stride, np.int64)
    if enable:
        acc = 0
        for i in range(n):
            if dt:
                acc = int(prev[i * stride]) + raw[i]
            else:
                acc = (acc + raw[i]) if i else raw[i]
            acc = min(max(acc, lo), hi)
            out[i] = acc
    if stride == 2:
        for i in range(n * stride - 1, 0, -1):
            out[i] = out[i >> 1]
    return out


def _ps_map34_to_20(a: np.ndarray) -> np.ndarray:
    """psbitdec.cpp map34IndexTo20 (integer truncation preserved)."""
    idx = [int(v) for v in a]

    def d3(x):
        return x // 3 if x >= 0 else -((-x) // 3)

    def d2(x):
        return x // 2 if x >= 0 else -((-x) // 2)

    def d4(x):
        return x // 4 if x >= 0 else -((-x) // 4)

    out = [d3(2 * idx[0] + idx[1]), d3(idx[1] + 2 * idx[2]),
           d3(2 * idx[3] + idx[4]), d3(idx[4] + 2 * idx[5]),
           d2(idx[6] + idx[7]), d2(idx[8] + idx[9]),
           idx[10], idx[11],
           d2(idx[12] + idx[13]), d2(idx[14] + idx[15]),
           idx[16], idx[17], idx[18], idx[19],
           d2(idx[20] + idx[21]), d2(idx[22] + idx[23]),
           d2(idx[24] + idx[25]), d2(idx[26] + idx[27]),
           d4(idx[28] + idx[29] + idx[30] + idx[31]),
           d2(idx[32] + idx[33])]
    return np.asarray(out, np.int64)


def decode_ps_indices(ps: PsData, prev_iid: np.ndarray = None,
                      prev_icc: np.ndarray = None):
    """Delta-decode a frame's IID/ICC huffman indices to absolute
    per-bin values (psbitdec.cpp DecodePs envelope loop): env 0
    references the previous frame's row, later envelopes the previous
    envelope; a FIX frame with 0 envelopes holds the previous values.
    Returns (iid_rows, icc_rows, prev_iid', prev_icc') with 34-wide
    persistent rows."""
    if prev_iid is None:
        prev_iid = np.zeros(34, np.int64)
    if prev_icc is None:
        prev_icc = np.zeros(34, np.int64)
    fine = ps.mode_iid > 2
    res_iid = ps.mode_iid - 3 if fine else ps.mode_iid
    res_icc = ps.mode_icc - 3 if ps.mode_icc > 2 else ps.mode_icc
    steps = 15 if fine else 7
    iid_rows, icc_rows = [], []
    for e in range(ps.n_env):
        pi = prev_iid if e == 0 else _pad34(iid_rows[-1])
        pc = prev_icc if e == 0 else _pad34(icc_rows[-1])
        n = _PS_BINS[res_iid]
        iid_rows.append(_ps_delta_decode(
            ps.enable_iid, ps.iid_index[e] if ps.enable_iid else [],
            pi, ps.iid_dt[e] if ps.enable_iid else 0,
            n, 1 if res_iid else 2, -steps, steps))
        n = _PS_BINS[res_icc]
        icc_rows.append(_ps_delta_decode(
            ps.enable_icc, ps.icc_index[e] if ps.enable_icc else [],
            pc, ps.icc_dt[e] if ps.enable_icc else 0,
            n, 1 if res_icc else 2, 0, 7))
    if not iid_rows:
        # FIX with noEnv=0: hold previous parameters (DecodePs:308-339)
        iid_rows = [prev_iid[:20].copy() if ps.enable_iid
                    else np.zeros(20, np.int64)]
        icc_rows = [prev_icc[:20].copy() if ps.enable_icc
                    else np.zeros(20, np.int64)]
    return (iid_rows, icc_rows,
            _pad34(iid_rows[-1], prev_iid), _pad34(icc_rows[-1], prev_icc))


def _pad34(row: np.ndarray, base: np.ndarray = None) -> np.ndarray:
    out = (base.copy() if base is not None else np.zeros(34, np.int64))
    out[:len(row)] = row[:34]
    return out


#: hybrid-group layout for 20-band PS (sbr_rom.cpp groupBorders20 /
#: bins2groupMap20): 10 sub-QMF groups over QMF bands 0-2, then plain
#: QMF bands 3..63 in widening groups
_PS_GROUP_BORDERS20 = (6, 7, 0, 1, 2, 3, 9, 8, 10, 11,
                       3, 4, 5, 6, 7, 8, 9, 11, 14, 18, 23, 35, 64)
_PS_BINS2GROUP20 = (1, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12,
                    13, 14, 15, 16, 17, 18, 19)


def ps_mixing_matrices(iid_row, icc_row, fine: bool):
    """Per-stereo-bin type-A rotation coefficients (h11, h12, h21,
    h22) from absolute IID/ICC indices — float reformulation of
    psdec.cpp:1000-1045: c_l/c_r looked up in the IID scale-factor
    tables (c_l^2 + c_r^2 = 2), alpha from the ICC rotation-angle
    table, beta = alpha * (c_r - c_l) / sqrt(2).  L = h11*s + h21*d,
    R = h12*s + h22*d with s the mid signal and d its decorrelation;
    per-envelope linear interpolation of these matrices happens at
    synthesis time (psdec.cpp:1046-1070)."""
    T = tables()
    sf = T["ps_ScaleFactorsFine" if fine else "ps_ScaleFactors"]
    al = T["ps_Alphas"]
    steps = 15 if fine else 7
    iid = np.clip(np.asarray(iid_row[:20], np.int64), -steps, steps)
    icc = np.clip(np.asarray(icc_row[:20], np.int64), 0, 7)
    cr = sf[steps + iid]
    cl = sf[steps - iid]
    alpha = al[icc]
    beta = alpha * (cr - cl) * (0.5 ** 0.5)
    return (cl * np.cos(beta + alpha), cr * np.cos(beta - alpha),
            cl * np.sin(beta + alpha), cr * np.sin(beta - alpha))


#: hybrid filterbank prototypes (13 taps; psdec_hybrid.cpp:118-216
#: documented filter designs: 8-band h[q,n]=g8[n]*exp(j*2pi/8*(q+.5)*
#: (n-6)), 2-band h[q,n]=g2[n]*cos(pi*q*(n-6)))
_PS_G8 = np.array([0.00746082949812, 0.02270420949825, 0.04546865930473,
                   0.07266113929591, 0.09885108575264, 0.11793710567217,
                   0.125,
                   0.11793710567217, 0.09885108575264, 0.07266113929591,
                   0.04546865930473, 0.02270420949825, 0.00746082949812])
_PS_G2 = np.array([0.0, 0.01899487526049, 0.0, -0.07293139167538, 0.0,
                   0.30596630545168, 0.5, 0.30596630545168, 0.0,
                   -0.07293139167538, 0.0, 0.01899487526049, 0.0])


class PsHybrid:
    """PS hybrid analysis filterbank (psdec_hybrid.cpp
    fillHybridDelayLine/slotBasedHybridAnalysis): QMF bands 0-2 split
    into 12 sub-subbands (8 complex + 2 + 2; channels 3+4 and 2+5
    merged for the 20-band layout), QMF bands 3..63 delayed by the
    filterbank's 6-slot group delay.  The FIRs are (13, nsub) matmuls
    over slot windows — MXU-shaped like the QMF kernels."""

    def __init__(self):
        n = np.arange(13)[:, None]
        q8 = np.arange(8)[None, :]
        self.H8 = _PS_G8[:, None] * np.exp(
            1j * 2.0 * np.pi / 8.0 * (q8 + 0.5) * (6 - n))
        q2 = np.arange(2)[None, :]
        self.H2 = _PS_G2[:, None] * np.cos(np.pi * q2 * (6 - n))
        self._hist = np.zeros((12, 3), np.complex128)
        self._dline = np.zeros((6, 61), np.complex128)

    def analyze(self, X: np.ndarray) -> tuple:
        """(slots, 64) complex QMF -> ((slots, 12) hybrid sub-bands,
        (slots, 61) delayed QMF bands 3..63)."""
        nsl = X.shape[0]
        low = np.concatenate([self._hist, X[:, :3]], axis=0)
        self._hist = low[nsl:nsl + 12].copy()
        win = np.stack([low[s:s + 13] for s in range(nsl)], axis=0)
        hyb = np.zeros((nsl, 12), np.complex128)
        hyb[:, 0:8] = np.einsum("snb,nq->sbq", win[:, :, :1],
                                self.H8)[:, 0]
        hyb[:, 8:10] = np.einsum("sn,nq->sq", win[:, :, 1], self.H2)
        hyb[:, 10:12] = np.einsum("sn,nq->sq", win[:, :, 2], self.H2)
        # group channels 3+4 -> 3 and 2+5 -> 2 (20-band layout)
        hyb[:, 3] += hyb[:, 4]
        hyb[:, 2] += hyb[:, 5]
        hyb[:, 4] = 0
        hyb[:, 5] = 0
        rest = np.concatenate([self._dline, X[:, 3:]], axis=0)
        self._dline = rest[nsl:nsl + 6].copy()
        return hyb, rest[:nsl]

    @staticmethod
    def synthesize(hyb: np.ndarray, rest: np.ndarray) -> np.ndarray:
        """Sum sub-subbands back per QMF band (slotBasedHybridSynthesis)
        -> (slots, 64) complex QMF."""
        nsl = hyb.shape[0]
        X = np.zeros((nsl, 64), np.complex128)
        X[:, 0] = hyb[:, 0:8].sum(axis=1)
        X[:, 1] = hyb[:, 8:10].sum(axis=1)
        X[:, 2] = hyb[:, 10:12].sum(axis=1)
        X[:, 3:] = rest
        return X


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
        borders = [round(i * nts / g.n_env) for i in range(g.n_env + 1)]
        g.t_env = borders
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
        # tranEnv = #borders - pointer = nEnv + 1 - p
        # (env_extr.cpp:1256: "tranEnv = p ? b - p : -1", b = nEnv+1)
        g.tran_env = ((nrel0 + nrel1 + 2) - g.pointer) if g.pointer else -1
    # out-of-spec pointer: fdk's extractFrameInfo rejects the frame
    # (bs_pointer > bs_num_env + 1); an unchecked value would index
    # outside t_env below
    if g.pointer > g.n_env + 1:
        raise SbrError("bs_pointer out of range")
    # noise grid
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
            # VARVAR border-set dedup can shrink t_env below n_env+1
            raise SbrError("corrupt envelope grid")
        g.t_noise = [g.t_env[0], g.t_env[mi], g.t_env[-1]]
    return g


def parse_sbr_data(b: Bits, hdr: SbrHeader, ft: FreqTables,
                   stereo: bool, prev_state: list = None,
                   ps_prev: "PsData" = None) -> list:
    """sbr_single_channel_element / sbr_channel_pair_element payload
    (after the header).  Returns list of ChannelData.  ``prev_state``
    carries (prev_env_row, prev_freq_res, prev_noise_row) per channel
    across frames — delta-time coded envelopes reference the previous
    frame's last envelope (ISO 14496-3 4.6.18.3.5)."""
    T = tables()
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
        import copy
        chans[1].grid = copy.deepcopy(g)
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
            # order in CPE without coupling: invf0, invf1 come after each
            # channel's noise in fdk; spec reads both here
            chans[1].invf = [b.read(2) for _ in range(ft.n_q)]

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
                prev_res = (g.freq_res[e - 1] if e > 0 else ch.prev_res)
                for k in range(nb):
                    d = _huff(b, t_book) * (2 if bal else 1)
                    row[k] = _map_prev(prev, prev_res, k,
                                       g.freq_res[e], ft) + d
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

    def _map_prev(prev, prev_res, k, res, ft):
        if prev is None:
            return 0
        if prev_res == res:
            return int(prev[min(k, len(prev) - 1)])
        if res == 1 and prev_res == 0:
            # high-res band k -> covering low-res band
            f = ft.f_high[k]
            i = int(np.searchsorted(ft.f_low, f, side="right") - 1)
            return int(prev[min(max(i, 0), len(prev) - 1)])
        f = ft.f_low[k]
        i = int(np.searchsorted(ft.f_high, f, side="right") - 1)
        return int(prev[min(max(i, 0), len(prev) - 1)])

    # envelope/noise interleaving per spec: SCE: env, noise.
    # CPE coupled: env0, noise0, env1, noise1; uncoupled: env0, env1,
    # noise0, noise1.
    for i, ch in enumerate(chans):
        if prev_state is not None and prev_state[i] is not None:
            ch.prev_env, ch.prev_res, ch.prev_noise = prev_state[i]
        else:
            ch.prev_env = None
            ch.prev_res = 1
            ch.prev_noise = None
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

    for i, ch in enumerate(chans):
        ch.add_harmonic = np.zeros(ft.n_high, np.int32)
        if b.read(1):
            for k in range(ft.n_high):
                ch.add_harmonic[k] = b.read(1)
    # bs_extended_data: 2-bit sub-extension ids; PS rides here
    # (env_extr.cpp:400-455, EXTENSION_ID_PS_CODING = 2)
    ps = None
    if b.read(1):
        cnt = b.read(4)
        if cnt == 15:
            cnt += b.read(8)
        end = min(b.pos + 8 * cnt, b.limit)
        while end - b.pos > 7:
            ext_id = b.read(2)
            if ext_id == 2:
                ps = parse_ps_data(b, end, ps_prev)
            else:
                while end - b.pos >= 8:
                    b.read(8)
        while b.pos < end:
            b.read(1)
    if prev_state is not None:
        for i, ch in enumerate(chans):
            prev_state[i] = (ch.env[-1], ch.grid.freq_res[-1],
                             ch.noise[-1])
    chans[0].ps = ps
    return chans, coupling


# ---------------------------------------------------------------------------
# decoder state & DSP
# ---------------------------------------------------------------------------

BW_TABLE = [0.0, 0.6, 0.9, 0.98]    # legacy flat map (kept for tools)


def map_invf_bw(invf, prev_invf):
    """Whitening (chirp) level per noise band from the current AND
    previous inverse-filtering modes — fdk mapInvfMode
    (lpp_tran.cpp:128-153): LOW whitens at 0.75 in steady state and
    0.6 only on the OFF->LOW transition; NONE after LOW decays through
    0.6.  The whFactorsTable rows are identical for every start
    frequency (sbr_rom.cpp:145-156), so the five levels are constants.
    Getting this wrong (a flat per-mode table) leaves every steady
    LOW-mode band under-whitened: the patch carries ~10% more energy
    relative to its source and the whole SBR band lands ~0.4 dB hot
    after self-normalization — the former per-sample conformance
    ceiling on noise-like content."""
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

#: diagnostic tap: when a list, _reconstruct appends (ch, {band: (a0,
#: a1)}) per frame — used by tools/lpc_compare.py to align this
#: decoder's transposer coefficients with the instrumented oracle's
ALPHA_SINK: list | None = None

#: diagnostic tap: when a list, _adjust appends "CALL" at each frame
#: then per envelope (e, gain, noise_lvl, sine_lvl, Emap, Ecurr) —
#: post-limiter/boost, pre-smoothing (comparable with the instrumented
#: oracle's env_calc dump; tools/lpc_compare.py env mode)
ENV_SINK: list | None = None

#: diagnostic override: {(call_idx, env): (gain, noise_lvl, sine_lvl)}
#: — when set, _adjust uses these post-boost values instead of its own
#: (units: gain dimensionless; noise/sine in this decoder's QMF
#: amplitude units).  Used by tools/env_compare.py to isolate the gain
#: pipeline from the patch/noise-walk when chasing per-sample deltas.
GAIN_OVERRIDE: dict | None = None
_GAIN_CALL = [0]

#: diagnostic tap: per _reconstruct call, (start, stop, patched HF
#: buffer slots [start:stop) x bins [kx:kx+M)) before adjustment
PATCH_SINK: list | None = None

#: global envelope-reference calibration: ratio between the encoder's
#: envelope energy reference and this decoder's analysis-kernel scale,
#: measured once against libSBRdec output (tests/test_sbr.py)
# envelope dequant reference level: E = 2^(sf/a) * 64 * ENERGY_CAL maps
# the bitstream scalefactors to this implementation's QMF |X|^2 units
# (64 * 262144 = 2^24).  Measured against fdk's HQ decoder in its own
# QMF analysis domain: the gained-signal part of every HF band tracks
# libSBRdec only at this level (at 32768 every SBR band came out 9 dB
# low, historically masked by an 8x-too-loud noise table — both halves
# of that wrong pair reproduced the band-energy sums but neither
# per-sample waveforms nor noise/sine amplitudes)
ENERGY_CAL = 262144.0


#: ratio of the previous envelope's gains/noise for the first 4 slots
#: of an envelope (libSBRdec sbr_rom.cpp FDK_sbrDecoder_sbr_smoothFilter)
_SMOOTH_FILTER = (0.66666666666666, 0.36516383427084,
                  0.14699433520835, 0.03183050093751)


class SbrChannelState:
    def __init__(self):
        self.ana_hist = np.zeros(320, np.float64)
        # buffer slots [32, 38) of the previous frame, HF-generated and
        # envelope-adjusted up to that frame's last border (sbr_dec.cpp
        # overlap update: QmfBuffer[i] = QmfBuffer[i+noCols])
        self.x_hist = np.zeros((6, 64), np.complex128)
        # transposer LPC prehistory: previous buffer slots [30, 32)
        # (sbr_dec.cpp:537 lpcFilterStates = QmfBuffer[noCols-2+i])
        self.lpp_pre = np.zeros((2, 64), np.complex128)
        self.syn_state = None
        self.prev_env = None
        self.prev_res = 1
        self.prev_noise = None
        self.bw = np.zeros(5, np.float64)
        # previous frame's inverse-filtering modes (fdk
        # h_prev_data->sbr_invf_mode, init INVF_OFF — env_extr.cpp:255)
        self.prev_invf = np.zeros(5, np.int64)
        self.noise_index = 0
        self.sine_index = 0
        self.prev_harm_bins: set = set()    # mid bins flagged last frame
        self.prev_tran_env = -1
        self.filt_gain = None       # previous envelope's gains (M,)
        self.filt_noise = None      # previous envelope's noise levels


class SbrDecoder:
    """Per-stream SBR decoder: feed the core (low-rate) PCM frame plus the
    frame's SBR payload, get 2x-rate output PCM.  The QMF stages run as
    dense kernel matmuls (see module docstring)."""

    #: envelope timing offset in QMF slots within the buffered frame
    #: (the 6-slot SBR overlap; kept for the device-path cond builder)
    ENV_LAG = 6
    #: amplitude calibration for values injected directly into the QMF
    #: domain (noise, synthetic sines).  1.0: with ENERGY_CAL fixed the
    #: levels sqrt(E*...) are already in |X| units — fdk's decoded noise
    #: measures 1.00x of sqrt(E*q/(1+q)) and a flagged harmonic lands
    #: at 0.0 dB of the oracle's band energy (see noise_tab comment)
    INJECT_CAL = 1.0

    def __init__(self, core_rate: int):
        self.core_rate = core_rate
        self.out_rate = core_rate * 2
        self.header: SbrHeader | None = None
        self.ft: FreqTables | None = None
        self.state = [SbrChannelState(), SbrChannelState()]
        T = tables()
        self.K_ana = T["ana32"]                       # (32, 320) complex
        S = T["syn64"]                                # (64, 2, 768)
        # time response of +1 in band k = S[k,0]; of +1j = S[k,1]
        self.syn_re = S[:, 0]
        self.syn_im = S[:, 1]
        # fdk's V noise table (env_calc.cpp FDK_sbrDecoder_sbr_randomPhase,
        # unit magnitude).  Calibration history: least-squares of fdk's
        # decoded noise against ours in fdk's own QMF analysis domain on
        # low-signal cells measured fdk at 0.346 of the old 8.0-scaled
        # table = 2.83x the uncalibrated level = exactly sqrt(8) — the
        # same factor the gained-signal bands were missing in energy —
        # which located the real bug in ENERGY_CAL (8x low), not here
        self.noise_tab = (T["random_phase"][:, 0]
                          + 1j * T["random_phase"][:, 1]) * self.INJECT_CAL

    def set_header(self, h: SbrHeader) -> None:
        self.header = h
        self.ft = derive_tables(self.out_rate, h)

    def parse_payload(self, payload: bytes, nbits: int, stereo: bool,
                      crc: bool):
        b = Bits(payload, 0, nbits)
        if crc:
            b.read(10)
        if b.read(1):                     # bs_header_flag
            self.set_header(parse_sbr_header(b))
        if self.header is None or self.ft is None:
            raise SbrError("SBR data before header")
        if not hasattr(self, "_parse_prev"):
            self._parse_prev = [None, None]
            self._ps_prev = None
        native_r = None
        if not os.environ.get("OHP_SBR_PY"):
            native_r = self._parse_payload_native(payload, b.pos, nbits,
                                                  stereo)
        if native_r is not None:
            return native_r
        chans, coupling = parse_sbr_data(b, self.header, self.ft, stereo,
                                         self._parse_prev,
                                         ps_prev=self._ps_prev)
        if chans[0].ps is not None:
            self._ps_prev = chans[0].ps
        return chans, coupling

    def _parse_payload_native(self, payload: bytes, start_bit: int,
                              nbits: int, stereo: bool):
        """One native call for the bit-serial sbr_data() parse
        (native/sbr_parse.cc, field-exact vs parse_sbr_data); PS
        payloads are handed back to parse_ps_data at the recorded bit
        range.  None -> caller uses the Python parser (state is only
        committed here on success)."""
        try:
            from ... import native
            if not native.have_sbr_parse():
                return None
        except Exception:                             # noqa: BLE001
            return None
        ft = self.ft
        maps = getattr(self, "_native_res_maps", None)
        if maps is None or maps[0] is not ft:
            idx_h2l = (np.searchsorted(ft.f_low, ft.f_high[:ft.n_high],
                                       side="right") - 1).astype(np.int32)
            idx_l2h = (np.searchsorted(ft.f_high, ft.f_low[:ft.n_low],
                                       side="right") - 1).astype(np.int32)
            maps = (ft, idx_h2l, idx_l2h)
            self._native_res_maps = maps
        r = native.sbr_parse_payload(
            payload, start_bit, nbits, stereo=stereo,
            amp_res=self.header.amp_res, n_q=ft.n_q, n_low=ft.n_low,
            n_high=ft.n_high, idx_h2l=maps[1], idx_l2h=maps[2],
            prev_state=self._parse_prev)
        if r is None:
            return None
        chans = [ChannelData(), ChannelData()] if stereo             else [ChannelData()]
        for c, ch in enumerate(chans):
            go = r["grid"][c]
            g = ChannelGrid()
            g.frame_class = int(go[0])
            g.n_env = int(go[1])
            g.pointer = int(go[2])
            g.tran_env = int(go[3])
            g.n_noise = int(go[4])
            nt = int(go[5])
            g.t_env = [int(x) for x in go[6:6 + nt]]
            g.t_noise = [int(x) for x in go[22:22 + g.n_noise + 1]]
            g.freq_res = [int(x) for x in go[25:25 + g.n_env]]
            ch.grid = g
            ch.df_env = [int(x) for x in r["df_env"][c][:g.n_env]]
            ch.df_noise = [int(x) for x in r["df_noise"][c][:g.n_noise]]
            ch.invf = [int(x) for x in r["invf"][c][:ft.n_q]]
            ch.env = [r["env"][c, e,
                              :(ft.n_high if g.freq_res[e] else ft.n_low)]
                      .copy() for e in range(g.n_env)]
            ch.noise = [r["noise"][c, e, :ft.n_q].copy()
                        for e in range(g.n_noise)]
            ch.add_harmonic = r["add_harm"][c][:ft.n_high].copy()
        ps = None
        ps0, ps1 = int(r["ps_bits"][0]), int(r["ps_bits"][1])
        if ps0 >= 0:
            b2 = Bits(payload, ps0, nbits)
            ps = parse_ps_data(b2, ps1, self._ps_prev)
        chans[0].ps = ps
        if ps is not None:
            self._ps_prev = ps
        for i, ch in enumerate(chans):
            self._parse_prev[i] = (ch.env[-1], ch.grid.freq_res[-1],
                                   ch.noise[-1])
        return chans, r["coupling"]

    # -- QMF analysis: one core frame (1024 samples) -> 32 slots x 32 ----
    def analyze(self, ch: int, pcm: np.ndarray) -> np.ndarray:
        st = self.state[ch]
        x = np.concatenate([st.ana_hist, pcm.astype(np.float64)])
        st.ana_hist = x[-320:].copy()
        n_slots = len(pcm) // 32
        win = np.lib.stride_tricks.sliding_window_view(x, 320)
        # slot l consumes 32 new samples; its window ends at new sample
        # 32(l+1), i.e. starts at x offset 32(l+1) - 320 + 320 = 32(l+1)
        starts = 32 * (np.arange(n_slots) + 1)
        X = win[starts] @ self.K_ana.T                # (slots, 32)
        return X

    def dequant(self, hdr, grid, env_rows, noise_rows):
        amp = hdr.amp_res
        if grid.frame_class == FIXFIX and grid.n_env == 1:
            amp = 0
        a = 2.0 if amp == 0 else 1.0
        E = [np.exp2(np.asarray(r, np.float64) / a) * (64.0 * ENERGY_CAL)
             for r in env_rows]
        Q = [np.exp2(6.0 - np.asarray(r, np.float64)) for r in noise_rows]
        return E, Q, a

    @staticmethod
    def unmap_coupled(E0, Q0, E1, Q1, a):
        """Channel-pair unmapping (env_dec.cpp sbr_envelope_unmapping):
        right = 2*L/(1+b), left = b*right with b from the balance
        channel's raw values."""
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

    def process_frame_ps(self, core_pcm: np.ndarray,
                         chans: list) -> np.ndarray:
        """HE-AAC v2: mono core (1, 1024) + PS data -> (2, 2048)
        stereo PCM (SBR reconstruction, then the parametric-stereo
        decorrelator/mixer, then two QMF syntheses)."""
        if not hasattr(self, "ps"):
            self.ps = PsDecoder()
        E, Q, _a = self.dequant(self.header, chans[0].grid,
                                chans[0].env, chans[0].noise)
        Xadj = self._reconstruct(0, core_pcm[0], chans[0], E, Q)
        XL, XR = self.ps.process(Xadj, chans[0].ps)
        return np.stack([self._synthesize(self.state[0], XL),
                         self._synthesize(self.state[1], XR)])

    # -- one frame ---------------------------------------------------------
    def process_frame(self, core_pcm: np.ndarray, chans: list,
                      coupling: bool) -> np.ndarray:
        """core_pcm (C, 1024); returns (C, 2048) float64 at 2x rate."""
        C = core_pcm.shape[0]
        hdr = self.header
        EQ = [self.dequant(hdr, chans[i].grid, chans[i].env,
                           chans[i].noise) for i in range(C)]
        if C == 2 and coupling:
            a = EQ[0][2]
            (EL, QL), (ER, QR) = self.unmap_coupled(
                EQ[0][0], EQ[0][1], chans[1].env, chans[1].noise, a)
            EQ = [(EL, QL, a), (ER, QR, a)]
        out = np.zeros((C, len(core_pcm[0]) * 2), np.float64)
        for i in range(C):
            out[i] = self._process_channel(i, core_pcm[i], chans[i],
                                           EQ[i][0], EQ[i][1])
        return out

    def _process_channel(self, ch, pcm, data, E, Q):
        st = self.state[ch]
        return self._synthesize(st, self._reconstruct(ch, pcm, data,
                                                      E, Q))

    def _reconstruct(self, ch, pcm, data, E, Q):
        """fdk's delayed-output frame scheme (sbr_dec.cpp:338-520): the
        38-slot buffer is [6 carried slots | 32 new analysis slots];
        transposer and envelope adjuster both run over buffer slots
        [2*borders[0], 2*borders[nEnv]) (lpp_tran.cpp:266-267,
        env_calc.cpp:621-622); the frame outputs buffer slots [0, 32)
        and carries the (already HF-patched and adjusted) tail [32, 38)
        into the next frame.  Envelopes with borders past 16 therefore
        land in next frame's output — never truncated — and consecutive
        frames tile the slot timeline exactly, which keeps the noise /
        sine phase counters in lock-step with libSBRdec (the per-sample
        conformance bound depends on it: noise filling only matches the
        oracle sample-exactly when the V-table index walk is identical)."""
        ft, hdr = self.ft, self.header
        st = self.state[ch]
        Xlow32 = self.analyze(ch, pcm)             # (32, 32)
        nsl = Xlow32.shape[0]
        X = np.zeros((nsl, 64), np.complex128)
        X[:, :32] = Xlow32
        Xbuf = np.concatenate([st.x_hist, X], axis=0)   # (6 + nsl, 64)
        nbuf = Xbuf.shape[0]

        g = data.grid
        kx, M = ft.kx, ft.M
        start = max(0, min(2 * g.t_env[0], nbuf))
        stop = max(start, min(2 * g.t_env[-1], nbuf))
        # chirp factors (one per noise band, smoothed across frames;
        # level from current+previous invf mode — see map_invf_bw)
        bw = np.empty(ft.n_q)
        nbs = map_invf_bw(data.invf[:ft.n_q], st.prev_invf[:ft.n_q])
        for i in range(ft.n_q):
            nb = nbs[i]
            prev = st.bw[i]
            v = 0.75 * nb + 0.25 * prev if nb < prev \
                else 0.90625 * nb + 0.09375 * prev
            if v < 0.015625:
                v = 0.0
            bw[i] = min(v, 0.99609375)
            st.bw[i] = bw[i]
        st.prev_invf[:ft.n_q] = data.invf[:ft.n_q]

        # HF generation: per low band, 2nd-order LPC over the contiguous
        # low-band sequence (2-slot prehistory + 38 buffer slots, the
        # autoCorrLength = nCols + overlap window of lpp_tran.cpp:274),
        # then patch slots [start, stop) with chirped inverse filtering
        alphas = {}
        for (t0, s0, width) in ft.patches:
            for j in range(width):
                k = t0 + j
                p = s0 + j
                if not (kx <= k < kx + M) or p < 0 or p >= kx:
                    continue
                if p not in alphas:
                    z = np.concatenate([st.lpp_pre[:, p], Xbuf[:, p]])
                    x0, x1, x2 = z[2:], z[1:-1], z[:-2]
                    phi01 = np.vdot(x1, x0)
                    phi02 = np.vdot(x2, x0)
                    phi11 = np.vdot(x1, x1).real
                    phi12 = np.vdot(x2, x1)
                    phi22 = np.vdot(x2, x2).real
                    d = phi22 * phi11 - abs(phi12) ** 2 / 1.000001
                    a1 = (phi01 * phi12 - phi02 * phi11) / d \
                        if abs(d) > 1e-9 else 0.0
                    a0 = -(phi01 + a1 * np.conj(phi12)) / phi11 \
                        if phi11 > 1e-9 else 0.0
                    if abs(a0) >= 4 or abs(a1) >= 4:
                        a0 = a1 = 0.0
                    alphas[p] = (a0, a1)
                a0, a1 = alphas[p]
                qi = min(max(int(np.searchsorted(
                    ft.f_noise, k, side="right") - 1), 0), ft.n_q - 1)
                bwk = bw[qi]
                z = np.concatenate([st.lpp_pre[:, p], Xbuf[:, p]])
                sl = np.arange(start, stop)
                Xbuf[sl, k] = (z[sl + 2] + bwk * a0 * z[sl + 1]
                               + bwk * bwk * a1 * z[sl])

        if ALPHA_SINK is not None:
            zs = {p: np.concatenate([st.lpp_pre[:, p], Xbuf[:, p]])
                  for p in alphas}
            ALPHA_SINK.append((ch, dict(alphas), zs))
        if PATCH_SINK is not None:
            PATCH_SINK.append((start, stop,
                               Xbuf[start:stop, kx:kx + M].copy()))
        Xadj = self._adjust(st, Xbuf, data, E, Q)
        st.lpp_pre = Xadj[nsl - 2:nsl].copy()       # buffer slots 30, 31
        st.x_hist = Xadj[nsl:nsl + 6].copy()        # adjusted tail 32..38
        return Xadj[:nsl]

    def _adjust(self, st, Xbuf, data, E, Q):
        ft, hdr = self.ft, self.header
        g = data.grid
        kx, M = ft.kx, ft.M
        # sine start envelope per mid bin (env_calc mapSineFlags): a sine
        # flagged last frame continues from envelope 0, a new one starts
        # at the transient envelope
        sine_start = {}
        cur_bins = set()
        for b_ in range(ft.n_high):
            if data.add_harmonic[b_]:
                mid = (int(ft.f_high[b_])
                       + int(ft.f_high[b_ + 1])) // 2 - kx
                if 0 <= mid < M:
                    cur_bins.add(mid)
                    sine_start[mid] = 0 if mid in st.prev_harm_bins \
                        else max(g.tran_env, 0)
        prev_tran = st.prev_tran_env
        st.prev_harm_bins = cur_bins
        # an attack pointing past this frame's envelopes lands in the
        # next frame's first envelope (env_calc.cpp:1108-1113)
        st.prev_tran_env = 0 if g.tran_env == g.n_env else -1
        limgain = {0: 10 ** 0.15, 1: 10 ** 0.3,
                   2: 10 ** 0.45, 3: 1e10}[hdr.limiter_gains]
        Xout = Xbuf
        bins = np.arange(M)
        if ENV_SINK is not None:
            ENV_SINK.append("CALL")
        if GAIN_OVERRIDE is not None:
            _GAIN_CALL[0] += 1
        for e in range(g.n_env):
            # buffer slot range = timeStep * borders (env_calc.cpp:621-
            # 622): borders index the delayed-output timeline directly;
            # borders past 16 adjust the carried tail (never truncated)
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
            for mid, start in sine_start.items():
                if e >= start:
                    sine[mid] = True
            no_noise_env = (e == g.tran_env or e == prev_tran)
            Xe = Xout[sl0:sl1, kx:kx + M]
            Ecurr = (np.abs(Xe) ** 2).mean(axis=0)
            if not hdr.interpol_freq:
                for b_ in range(nb):
                    lo = int(bands[b_]) - kx
                    hi = int(bands[b_ + 1]) - kx
                    if hi > lo:
                        Ecurr[lo:hi] = Ecurr[lo:hi].mean()
            # band has a sine anywhere -> different gain rule in band
            sine_in_band = np.zeros(M, bool)
            for b_ in range(nb):
                lo, hi = int(bands[b_]) - kx, int(bands[b_ + 1]) - kx
                if sine[lo:hi].any():
                    sine_in_band[lo:hi] = True
            qfac = Qmap / (1.0 + Qmap)
            # gain rules per calcSubbandGain (env_calc.cpp:1608-1701):
            # sine-in-band -> R*qfac/Est; plain -> R/((1+Q)*Est); on
            # no-noise (attack) envelopes the (1+Q) divisor drops —
            # gain^2 = R/Est (the noise won't be injected, so the
            # signal alone must carry the full reference energy)
            gain = np.where(
                sine_in_band,
                np.sqrt(Emap * qfac / np.maximum(Ecurr, 1e-12)),
                np.sqrt(Emap / np.maximum(Ecurr, 1e-12)
                        / (1.0 if no_noise_env else 1.0 + Qmap)))
            noise_lvl = np.sqrt(Emap * qfac)
            sine_lvl = np.where(sine, np.sqrt(Emap / (1.0 + Qmap)), 0.0)
            # limiter + boost per limiter band
            for li in range(len(ft.f_lim) - 1):
                lo, hi = int(ft.f_lim[li]), int(ft.f_lim[li + 1])
                if hi <= lo:
                    continue
                gmax = min(limgain * np.sqrt(
                    (Emap[lo:hi].sum() + 1e-12)
                    / (Ecurr[lo:hi].sum() + 1e-12)), 1e10)
                # limited bins scale their noise by the same ratio
                # (env_calc noise limiting)
                ratio = np.minimum(1.0, gmax
                                   / np.maximum(gain[lo:hi], 1e-12))
                noise_lvl[lo:hi] *= ratio
                gain[lo:hi] = np.minimum(gain[lo:hi], gmax)
                target = Emap[lo:hi].sum()
                # boost accumulator (env_calc.cpp:786-805): gained
                # energy always; per SINE BIN either the sine energy or
                # (without sine, non-attack) the noise energy
                noise_acc = 0.0 if no_noise_env else \
                    (noise_lvl[lo:hi] ** 2
                     * (sine_lvl[lo:hi] == 0.0)).sum()
                achieved = (Ecurr[lo:hi] * gain[lo:hi] ** 2).sum() \
                    + noise_acc + (sine_lvl[lo:hi] ** 2).sum()
                boost = min(np.sqrt(target / max(achieved, 1e-12)),
                            1.584893192)
                gain[lo:hi] *= boost
                noise_lvl[lo:hi] *= boost
                sine_lvl[lo:hi] *= boost
            if ENV_SINK is not None:
                ENV_SINK.append((e, gain.copy(), noise_lvl.copy(),
                                 sine_lvl.copy(), Emap.copy(),
                                 Ecurr.copy(), sl0, sl1))
            if GAIN_OVERRIDE is not None:
                ov = GAIN_OVERRIDE.get((_GAIN_CALL[0] - 1, e))
                if ov is not None:
                    gain, noise_lvl, sine_lvl = [np.asarray(v, float)
                                                 for v in ov]
            # time smoothing: the first 4 slots of a non-attack envelope
            # blend the previous envelope's gains/noise levels in
            # (env_calc.cpp:642-647, 999-1003, sbr_smoothFilter)
            smooth_len = 0 if no_noise_env or hdr.smoothing_mode else 4
            if st.filt_gain is None:
                st.filt_gain = gain.copy()
                st.filt_noise = noise_lvl.copy()
            # noise is suppressed only at bins that carry a sinusoid
            # (env_calc adjustEnvelope: pSineLevel[0] != 0)
            for sl in range(sl0, sl1):
                if sl - sl0 < smooth_len:
                    r = _SMOOTH_FILTER[sl - sl0]
                    g_sl = r * st.filt_gain + (1.0 - r) * gain
                    n_sl = r * st.filt_noise + (1.0 - r) * noise_lvl
                else:
                    g_sl, n_sl = gain, noise_lvl
                row = Xout[sl, kx:kx + M] * g_sl
                idx = (st.noise_index + 1 + bins) & 511
                st.noise_index = int(idx[-1])
                nv = self.noise_tab[idx]
                if not no_noise_env:
                    row = row + nv * np.where(sine, 0.0, n_sl)
                if sine.any():
                    ph = st.sine_index & 3
                    parity = np.where(((bins + kx) & 1) > 0, -1.0, 1.0)
                    sine_amp = sine_lvl * self.INJECT_CAL
                    if ph == 0:
                        s = sine_amp + 0j
                    elif ph == 1:
                        s = 1j * sine_amp * parity
                    elif ph == 2:
                        s = -sine_amp + 0j
                    else:
                        s = -1j * sine_amp * parity
                    row = row + s
                Xout[sl, kx:kx + M] = row
                st.sine_index = (st.sine_index + 1) & 3
            st.filt_gain = gain.copy()
            st.filt_noise = noise_lvl.copy()
        return Xout

    def _synthesize(self, st, Xslots: np.ndarray) -> np.ndarray:
        """64-band synthesis via the measured kernel: each slot's complex
        bands contribute a 768-sample response, overlap-added at 64."""
        nsl = Xslots.shape[0]
        contrib = Xslots.real @ self.syn_re + Xslots.imag @ self.syn_im
        out = np.zeros(nsl * 64 + 768, np.float64)
        for l in range(nsl):
            out[l * 64:l * 64 + 768] += contrib[l]
        if st.syn_state is None:
            st.syn_state = np.zeros(768 - 64, np.float64)
        out[:768 - 64] += st.syn_state
        st.syn_state = out[nsl * 64:nsl * 64 + 768 - 64].copy()
        return out[:nsl * 64]


# ---------------------------------------------------------------------------
# Parametric stereo synthesis (HE-AAC v2): decorrelator + rotation
# mixing (float reformulation of libSBRdec psdec.cpp)
# ---------------------------------------------------------------------------

_PS_PEAK_DECAY = 0.765928338364649
_PS_INT_COEFF = 1.0 - 0.75            # INT_FILTER_COEFF
_PS_TRANS_IMPACT = 2.0 / 3.0
_PS_SER_DELAYS = (3, 4, 5)            # aAllpassLinkDelaySer
_PS_FIRST_DELAY_SB = 23


class PsDecoder:
    """Turns the decoded mono (mid) QMF matrix into L/R
    (psdec.cpp deCorrelateSlotBased + initSlotBasedRotation +
    applySlotBasedRotation):
    * per-slot power + peak-decay transient ratio per stereo bin,
    * decorrelation: 2-slot delay, per-band fractional-delay phase,
      three serial allpass links (delays 3/4/5) for the sub-QMF
      channels and QMF bands 3..22, plain 14/1-slot delays above,
    * transient ducking of the decorrelated path,
    * per-envelope linear interpolation of the type-A mixing matrices.
    """

    def __init__(self):
        T = tables()
        self.hybrid = PsHybrid()
        self.phi_sub = (T["ps_aaFractDelayPhaseFactorReSubQmf20"]
                        + 1j * T["ps_aaFractDelayPhaseFactorImSubQmf20"])
        self.phi_qmf = (T["ps_aaFractDelayPhaseFactorReQmf"]
                        + 1j * T["ps_aaFractDelayPhaseFactorImQmf"])
        self.phi_ser_sub = (
            T["ps_aaFractDelayPhaseFactorSerReSubQmf20"]
            + 1j * T["ps_aaFractDelayPhaseFactorSerImSubQmf20"]
        ).reshape(12, 3)
        self.phi_ser_qmf = (
            T["ps_aaFractDelayPhaseFactorSerReQmf"]
            + 1j * T["ps_aaFractDelayPhaseFactorSerImQmf"]
        ).reshape(64, 3)
        self.decay_ser = T["ps_aAllpassLinkDecaySer"]
        self.decay_scale = T["ps_decayScaleFactTable"]
        self.delay_len = T["ps_delayIndexQmf"].astype(int)
        # decorrelator state
        self.peak_decay = np.zeros(20)
        self.prev_peak_diff = np.zeros(20)
        self.prev_nrg = np.zeros(20)
        self.dly2_sub = np.zeros((2, 12), np.complex128)
        self.dly2_qmf = np.zeros((2, _PS_FIRST_DELAY_SB), np.complex128)
        self.dly2_idx = 0
        self.ser_sub = [np.zeros((12, d), np.complex128)
                        for d in _PS_SER_DELAYS]
        self.ser_qmf = [np.zeros((_PS_FIRST_DELAY_SB, d), np.complex128)
                        for d in _PS_SER_DELAYS]
        self.ser_idx = [0, 0, 0]
        self.long_dly = [np.zeros(self.delay_len[sb], np.complex128)
                         for sb in range(_PS_FIRST_DELAY_SB, 64)]
        self.long_idx = np.zeros(64 - _PS_FIRST_DELAY_SB, int)
        # mixing state (true-value scale: identity mono split)
        self.H = np.array([np.ones(22), np.ones(22),
                           np.zeros(22), np.zeros(22)])
        # 6-slot pipeline of interpolated H matrices: this decoder's
        # hybrid path delays the signal by the filter's 6-slot group
        # delay (fdk instead look-aheads in its low-band buffer,
        # psdec_hybrid.cpp:501-504, so its signal is undelayed); the
        # envelope-interpolation timeline must ride the same delay or
        # every H lands 6 slots early on the audio — measured as the
        # whole v2 SIDE channel decorrelating from the oracle (its
        # waveform is h21*d with h21 crossing zero mid-ramp)
        from collections import deque
        self._h_delay = deque([self.H.copy()] * 6, maxlen=7)
        self.prev_iid = None
        self.prev_icc = None
        self.last_ps: PsData = None

    # -- per-frame entry -------------------------------------------------
    def process(self, X: np.ndarray, ps: PsData):
        """X (32, 64) complex mid QMF -> (XL, XR) each (32, 64)."""
        if ps is None:
            if self.last_ps is None:
                return X.copy(), X.copy()
            ps = PsData(header_valid=True,
                        enable_iid=self.last_ps.enable_iid,
                        mode_iid=self.last_ps.mode_iid,
                        enable_icc=self.last_ps.enable_icc,
                        mode_icc=self.last_ps.mode_icc,
                        frame_class=0, n_env=0)
        self.last_ps = ps
        iid_rows, icc_rows, self.prev_iid, self.prev_icc = \
            decode_ps_indices(ps, self.prev_iid, self.prev_icc)
        fine = ps.mode_iid > 2
        # 34-band parameters map to the baseline 20-band layout
        if (ps.mode_iid % 3) == 2:
            iid_rows = [_ps_map34_to_20(_pad34(r)) for r in iid_rows]
        if (ps.mode_icc % 3) == 2:
            icc_rows = [_ps_map34_to_20(_pad34(r)) for r in icc_rows]
        n_env = len(iid_rows)
        borders = self._env_borders(ps, n_env, X.shape[0])
        hyb, rest = self.hybrid.analyze(X)
        mid = np.concatenate([hyb, rest], axis=1)   # (32, 12 + 61)
        L = np.zeros_like(mid)
        R = np.zeros_like(mid)
        for env in range(n_env):
            t0, t1 = borders[env], borders[env + 1]
            if t1 <= t0:
                continue
            h_tgt = self._group_matrices(iid_rows[env], icc_rows[env],
                                         fine)
            dH = (h_tgt - self.H) / (t1 - t0)
            for sl in range(t0, t1):
                self.H = self.H + dH
                self._h_delay.append(self.H.copy())
                d = self._decorrelate_slot(mid[sl])
                self._mix_slot(mid[sl], d, L[sl], R[sl],
                               self._h_delay.popleft())
            self.H = h_tgt
        XL = PsHybrid.synthesize(L[:, :12], L[:, 12:])
        XR = PsHybrid.synthesize(R[:, :12], R[:, 12:])
        return XL, XR

    @staticmethod
    def _env_borders(ps: PsData, n_env: int, nsl: int) -> list:
        if ps.frame_class == 0 or ps.borders is None:
            return [e * nsl // n_env for e in range(n_env)] + [nsl]
        b = [0] + list(ps.borders[:n_env])
        if b[-1] < nsl:
            b = b + [nsl]       # duplicated-parameter env was appended
            b = b[:n_env + 1]
        b[-1] = nsl
        for e in range(1, n_env):
            thr = nsl - (n_env - e)
            if b[e] > thr:
                b[e] = thr
            elif b[e] < b[e - 1] + 1:
                b[e] = b[e - 1] + 1
        return b

    def _group_matrices(self, iid_row, icc_row, fine):
        """(4, 22) per-group mixing targets: bins2groupMap20 expands
        the 20 per-bin type-A matrices to the 22 processing groups."""
        h11, h12, h21, h22 = ps_mixing_matrices(iid_row, icc_row, fine)
        gm = np.asarray(_PS_BINS2GROUP20)
        return np.array([h11[gm], h12[gm], h21[gm], h22[gm]])

    def _decorrelate_slot(self, m: np.ndarray) -> np.ndarray:
        """One slot of mid hybrid+qmf channels (73,) -> decorrelated
        side channels (73,)."""
        d = np.zeros_like(m)
        hyb = m[:12]
        qmf = m[12:]
        # per-bin power at the 20-band resolution (psdec.cpp:643-664)
        p = np.zeros(20)
        ah = np.abs(hyb) ** 2
        p[0] = ah[0] + ah[7]
        p[1] = ah[1] + ah[6]
        p[2] = ah[2]
        p[3] = ah[3]
        p[4] = ah[9]
        p[5] = ah[8]
        p[6] = ah[10]
        p[7] = ah[11]
        aq = np.abs(qmf) ** 2
        for bin_ in range(8, 20):
            lo = _PS_GROUP_BORDERS20[bin_ + 2]
            hi = _PS_GROUP_BORDERS20[bin_ + 3]
            p[bin_] = aq[lo - 3:hi - 3].sum()
        # transient ratio (peak decay + smoothed difference)
        self.peak_decay = np.maximum(self.peak_decay * _PS_PEAK_DECAY, p)
        peak_diff = self.prev_peak_diff + _PS_INT_COEFF * (
            self.peak_decay - p - self.prev_peak_diff)
        self.prev_peak_diff = peak_diff
        nrg = np.maximum(
            0.0, self.prev_nrg + _PS_INT_COEFF * (p - self.prev_nrg))
        self.prev_nrg = nrg
        nrg = nrg * _PS_TRANS_IMPACT
        trans = np.where(peak_diff <= nrg, 1.0,
                         nrg / np.maximum(peak_diff, 1e-30))
        # sub-qmf channels (groups 0..9): allpass chain
        i2 = self.dly2_idx
        for gr in range(10):
            sb = _PS_GROUP_BORDERS20[gr]
            r0 = self.dly2_sub[i2, sb] * self.phi_sub[sb]
            self.dly2_sub[i2, sb] = hyb[sb]
            for mi in range(3):
                si = self.ser_idx[mi]
                tmp = self.ser_sub[mi][sb, si] * self.phi_ser_sub[sb, mi]
                tmp = tmp - self.decay_ser[mi] * r0
                self.ser_sub[mi][sb, si] = \
                    r0 + self.decay_ser[mi] * tmp
                r0 = tmp
            d[sb] = trans[_PS_BINS2GROUP20[gr]] * r0
        # qmf bands 3..22 (groups 10..19): allpass with decay ramp
        for gr in range(10, 20):
            tr = trans[_PS_BINS2GROUP20[gr]]
            for sb in range(_PS_GROUP_BORDERS20[gr],
                            _PS_GROUP_BORDERS20[gr + 1]):
                dsf = self.decay_scale[sb]
                r0 = self.dly2_qmf[i2, sb] * self.phi_qmf[sb]
                self.dly2_qmf[i2, sb] = qmf[sb - 3]
                res = dsf * r0
                for mi in range(3):
                    si = self.ser_idx[mi]
                    tmp = self.ser_qmf[mi][sb, si] \
                        * self.phi_ser_qmf[sb, mi]
                    tmp = tmp - self.decay_ser[mi] * res
                    res = dsf * tmp
                    self.ser_qmf[mi][sb, si] = \
                        r0 + self.decay_ser[mi] * res
                    r0 = tmp
                d[12 + sb - 3] = tr * r0
        # qmf bands 23..63 (groups 20, 21): plain delays
        for gr in (20, 21):
            tr = trans[_PS_BINS2GROUP20[gr]]
            for sb in range(_PS_GROUP_BORDERS20[gr],
                            _PS_GROUP_BORDERS20[gr + 1]):
                k = sb - _PS_FIRST_DELAY_SB
                buf = self.long_dly[k]
                di = self.long_idx[k]
                v = buf[di]
                buf[di] = qmf[sb - 3]
                self.long_idx[k] = (di + 1) % len(buf)
                d[12 + sb - 3] = tr * v
        self.dly2_idx = (i2 + 1) % 2
        for mi in range(3):
            self.ser_idx[mi] = (self.ser_idx[mi] + 1) \
                % _PS_SER_DELAYS[mi]
        return d

    def _mix_slot(self, m, d, outL, outR, H=None):
        h11, h12, h21, h22 = self.H if H is None else H
        for gr in range(10):
            sb = _PS_GROUP_BORDERS20[gr]
            outL[sb] = h11[gr] * m[sb] + h21[gr] * d[sb]
            outR[sb] = h12[gr] * m[sb] + h22[gr] * d[sb]
        for gr in range(10, 22):
            lo = _PS_GROUP_BORDERS20[gr] + 12 - 3
            hi = _PS_GROUP_BORDERS20[gr + 1] + 12 - 3
            outL[lo:hi] = h11[gr] * m[lo:hi] + h21[gr] * d[lo:hi]
            outR[lo:hi] = h12[gr] * m[lo:hi] + h22[gr] * d[lo:hi]
