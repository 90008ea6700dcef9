"""Floor 1 decode + curve synthesis (spec §7.2.3/7.2.4; parity: Tremor
floor1.c).  Integer post decode and Bresenham line render in the dB
domain, then the 256-entry inverse-dB map (tables.npz, extracted from the
reference's fixed-point table as float)."""

from __future__ import annotations

import pathlib

import numpy as np

from .bitreader import EndOfPacket, LsbBitReader, ilog
from .headers import Floor1

_NPZ = np.load(pathlib.Path(__file__).resolve().parent / "tables.npz")
FROMDB = _NPZ["floor1_fromdb"]

_RANGES = (256, 128, 86, 64)


# ---------------------------------------------------------------------------
# floor 0 (legacy LSP floor, spec s6.2; parity: Tremor floor0.c)
# ---------------------------------------------------------------------------

def decode_floor0(br: LsbBitReader, fl, books: list):
    """Spec s6.2.2 packet decode: returns (amplitude, coefficients) or
    None when the channel is unused this frame."""
    try:
        amplitude = br.read(fl.amplitude_bits)
        if amplitude <= 0:
            return None
        booknum = br.read(ilog(len(fl.books)))
        if booknum >= len(fl.books):
            return None                     # spec: undecodable -> unused
        book = books[fl.books[booknum]]
        if book.vectors is None:
            return None
        coeffs: list[float] = []
        last = 0.0
        while len(coeffs) < fl.order:
            vec = book.decode_vq(br)
            coeffs.extend(float(v) + last for v in vec)
            last = coeffs[-1]
        return amplitude, coeffs[:fl.order]
    except EndOfPacket:
        return None


# the reference decoder's bark mapping is authoritative (Tremor
# floor0.c:360 "The below is authoritative in terms of defining scale
# mapping"): a piecewise-linear Hz->bark table in 17.15 fixed point, NOT
# the analytic bark formula — the map indices are wire semantics
_BARKLOOK = (0, 100, 200, 301, 405, 516, 635, 766,
             912, 1077, 1263, 1476, 1720, 2003, 2333, 2721,
             3184, 3742, 4428, 5285, 6376, 7791, 9662, 12181,
             15624, 20397, 27087, 36554)


def _to_bark_i(n: int) -> int:
    for i in range(27):
        if _BARKLOOK[i] <= n < _BARKLOOK[i + 1]:
            gap = _BARKLOOK[i + 1] - _BARKLOOK[i]
            return (i << 15) + (((n - _BARKLOOK[i]) << 15) // gap)
    return 27 << 15


_MAP_CACHE: dict = {}


def _floor0_map(fl, n: int) -> np.ndarray:
    key = (fl.rate, fl.bark_map_size, n)
    hit = _MAP_CACHE.get(key)
    if hit is not None:
        return hit
    ln = fl.bark_map_size
    denom = _to_bark_i(fl.rate // 2)
    m = np.zeros(n, np.int64)
    for j in range(n):
        val = (ln * ((_to_bark_i(fl.rate // 2 * j // n) << 11)
                     // denom)) >> 11
        m[j] = min(val, ln - 1)
    _MAP_CACHE[key] = m
    return m


_COS_I = _NPZ["lsp_cos"] if "lsp_cos" in _NPZ.files else None
_INVSQ_I = _NPZ.get("lsp_invsq") if _COS_I is not None else None
_INVSQ_D = _NPZ.get("lsp_invsq_del") if _COS_I is not None else None
_FROMDB_I = _NPZ.get("lsp_fromdb") if _COS_I is not None else None
_FROMDB2_I = _NPZ.get("lsp_fromdb2") if _COS_I is not None else None
_ADJ_SQRT2 = (8192, 5792)


def _coslook_i(a: int) -> int:
    i = a >> 9
    d = a & 511
    c = _COS_I
    return int(c[i] - ((d * (c[i] - c[i + 1])) >> 9))


def _coslook2_i(a: int) -> int:
    a &= 0x1FFFF
    if a > 0x10000:
        a = 0x20000 - a
    i = a >> 9
    d = a & 511
    c = _COS_I
    return int(((c[i] << 9) - d * (c[i] - c[i + 1])) >> 9)


def _invsqlook_i(a: int, e: int) -> int:
    i = (a & 0x7FFF) >> 9
    d = a & 1023
    val = int(_INVSQ_I[i]) - ((int(_INVSQ_D[i]) * d) >> 10)
    val *= _ADJ_SQRT2[e & 1]
    e = (e >> 1) + 21
    return val >> e if e >= 0 else val << -e


def _fromdblook_i(a: int) -> int:
    i = (-a) >> 9
    if i < 0:
        return 0x7FFFFFFF
    if i >= (35 << 5):
        return 0
    return int(_FROMDB_I[i >> 5]) * int(_FROMDB2_I[i & 31])


def _mloop_shift(v: int) -> int:
    """Normalisation shift so the running products stay in 16 bits
    (the reference's MLOOP_1/2/3 tables compute exactly this)."""
    if v < (1 << 16):
        return 0
    return v.bit_length() - 16


def _lsp_curve_value(ilsp: list[int], wi: int, m: int, ampi: int,
                     ampoffseti: int) -> int:
    """One curve amplitude, exactly as the reference's fixed-point
    vorbis_lsp_to_curve computes it (Tremor floor0.c, non-asm path)."""
    pi = qi = 46341                 # 2^-0.5 in 0.16
    qexp = 0
    j = 1
    if m > 1:
        qi *= abs(ilsp[0] - wi)
        pi *= abs(ilsp[1] - wi)
        j = 3
        while j < m:
            shift = _mloop_shift(pi | qi)
            qi = (qi >> shift) * abs(ilsp[j - 1] - wi)
            pi = (pi >> shift) * abs(ilsp[j] - wi)
            qexp += shift
            j += 2
    shift = _mloop_shift(pi | qi)
    if m & 1:
        qi = (qi >> shift) * abs(ilsp[j - 1] - wi)
        pi = (pi >> shift) << 14
        qexp += shift
        shift = _mloop_shift(pi | qi)
        pi >>= shift
        qi >>= shift
        qexp += shift - 14 * ((m + 1) >> 1)
        pi = (pi * pi) >> 16
        qi = (qi * qi) >> 16
        qexp = qexp * 2 + m
        pi *= (1 << 14) - ((wi * wi) >> 14)
        qi += pi >> 14
    else:
        pi >>= shift
        qi >>= shift
        qexp += shift - 7 * m
        pi = (pi * pi) >> 16
        qi = (qi * qi) >> 16
        qexp = qexp * 2 + m
        pi *= (1 << 14) - wi
        qi *= (1 << 14) + wi
        qi = (qi + pi) >> 14
    if qi & 0xFFFF0000:
        qi >>= 1
        qexp += 1
    else:
        while qi and not (qi & 0x8000):
            qi <<= 1
            qexp -= 1
    return _fromdblook_i(ampi * _invsqlook_i(qi, qexp) - ampoffseti)


def render_curve0(decoded, fl, n: int) -> np.ndarray:
    """Curve synthesis from LSP coefficients (spec s6.2.3), emulating the
    reference decoder's fixed-point arithmetic exactly: quantized cos and
    inverse-sqrt lookups, running-product normalisation shifts, the 1/16
    amplitude truncation and the -140..0 dB fromdB domain."""
    amplitude, coeffs = decoded
    m = fl.order
    mp = _floor0_map(fl, n)
    ab = (1 << fl.amplitude_bits) - 1
    ampi = (amplitude * fl.amplitude_offset << 4) // ab
    ampoffseti = fl.amplitude_offset * 4096
    ilsp = []
    for c in coeffs:
        fixed = int(round(c * (1 << 24)))           # book value in 8.24
        val = (fixed * 0x517CC2) >> 32              # * 1/pi -> .16
        if val < 0 or (val >> 9) >= 128:
            return np.zeros(n)                      # malicious stream
        ilsp.append(_coslook_i(val))
    ln = fl.bark_map_size
    amps = np.zeros(ln, np.float64)
    seen = np.zeros(ln, bool)
    scale = float(1 << 31)          # MULT31 convention: 2^31 == gain 1.0
    out = np.zeros(n, np.float64)
    for i in range(n):
        k = int(mp[i])
        if not seen[k]:
            wi = _coslook2_i(0x10000 * k // ln)
            amps[k] = _lsp_curve_value(ilsp, wi, m, ampi,
                                       ampoffseti) / scale
            seen[k] = True
        out[i] = amps[k]
    return out


def decode_floor1(br: LsbBitReader, fl: Floor1,
                  books: list) -> list | None:
    """Returns (final_y, step2_flags) posts or None when the channel is
    unused this frame (zero bit, or end-of-packet during decode)."""
    try:
        if not br.read(1):
            return None
        rng = _RANGES[fl.multiplier - 1]
        ybits = ilog(rng - 1)
        y = [br.read(ybits), br.read(ybits)]
        for i in range(fl.partitions):
            cls = fl.partition_classes[i]
            cdim = fl.class_dims[cls]
            cbits = fl.class_subclasses[cls]
            csub = (1 << cbits) - 1
            cval = 0
            if cbits:
                cval = books[fl.class_masterbooks[cls]].decode(br)
            for _ in range(cdim):
                book = fl.subclass_books[cls][cval & csub]
                cval >>= cbits
                y.append(books[book].decode(br) if book >= 0 else 0)
    except EndOfPacket:
        return None

    # amplitude value synthesis (spec §7.2.4 step 1)
    npost = len(fl.x_list)
    final = [0] * npost
    step2 = [False] * npost
    final[0], final[1] = y[0], y[1]
    step2[0] = step2[1] = True
    for i in range(2, npost):
        lo, hi = fl.neighbors[i - 2]
        pred = _render_point(fl.x_list[lo], final[lo],
                             fl.x_list[hi], final[hi], fl.x_list[i])
        val = y[i]
        highroom = rng - pred
        lowroom = pred
        room = 2 * min(highroom, lowroom)
        if val:
            step2[lo] = step2[hi] = step2[i] = True
            if val >= room:
                if highroom > lowroom:
                    final[i] = val - lowroom + pred
                else:
                    final[i] = pred - (val - highroom) - 1
            else:
                final[i] = pred - ((val + 1) // 2) if (val & 1) \
                    else pred + val // 2
        else:
            step2[i] = False
            final[i] = pred
        final[i] = max(0, min(rng - 1, final[i]))
    return final, step2


def _render_point(x0: int, y0: int, x1: int, y1: int, x: int) -> int:
    dy = y1 - y0
    adx = x1 - x0
    err = abs(dy) * (x - x0)
    off = err // adx
    return y0 - off if dy < 0 else y0 + off


def render_curve(posts, fl: Floor1, n: int) -> np.ndarray:
    """(final_y, step2) -> amplitude curve of length n (= blocksize/2)."""
    final, step2 = posts
    mult = fl.multiplier
    ydb = np.zeros(n, np.int32)
    order = [i for i in fl.sort_order if step2[i]]
    lx, ly = 0, final[order[0]] * mult if order else 0
    hx = 0
    hy = ly
    for i in order[1:]:
        hx = fl.x_list[i]
        hy = final[i] * mult
        if lx < n:
            # render with the true segment slope; writes clamp to n
            _render_line(lx, ly, hx, hy, ydb)
        lx, ly = hx, hy
    if hx < n:
        ydb[hx:] = ly
    np.clip(ydb, 0, 255, out=ydb)
    return FROMDB[ydb]


def _render_line(x0: int, y0: int, x1: int, y1: int,
                 v: np.ndarray) -> None:
    """Integer Bresenham in the dB domain (spec §9.2.6/7)."""
    dy = y1 - y0
    adx = x1 - x0
    if adx <= 0:
        return
    ady = abs(dy)
    base = int(dy / adx)                 # truncate toward zero
    ady -= abs(base) * adx
    n = len(v)
    if x0 < n:
        v[x0] = y0
    # closed form of the integer error walk: after k steps err has
    # carried floor(k*ady/adx) times, each carry adding sy-base = +/-1
    hi = min(x1, n)
    if hi > x0 + 1:
        k = np.arange(1, hi - x0, dtype=np.int64)
        e = 1 if dy >= 0 else -1
        v[x0 + 1:hi] = y0 + base * k + e * (k * ady // adx)
