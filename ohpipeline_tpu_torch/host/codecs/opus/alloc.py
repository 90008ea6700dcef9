"""CELT bit allocation (RFC 6716 s4.3.3), decoder side.

The allocation is normative wire arithmetic: the decoder must reproduce
the encoder's band-bit split exactly or every later symbol desyncs.
Behavioural parity target: opus-1.5.2 celt/rate.c clt_compute_allocation
as driven by the reference's OpenHome/Media/Codec/Opus.cpp; validated
case-for-case against the compiled oracle (tools/celt_probe.c `alloc`)
in tests/test_opus_alloc.py.

All bit quantities are in 1/8-bit units (BITRES=3).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BITRES = 3
ALLOC_STEPS = 6
FINE_OFFSET = 21
MAX_FINE_BITS = 8
MAX_PSEUDO = 40
LOG_MAX_PSEUDO = 6

LOG2_FRAC = (0, 8, 13, 16, 19, 21, 23, 24, 26, 27, 28, 29, 30, 31, 32,
             32, 33, 34, 34, 35, 36, 36, 37, 37)


def get_pulses(i: int) -> int:
    """Pseudo-pulse index -> pulse count (rate.h get_pulses)."""
    return i if i < 8 else (8 + (i & 7)) << ((i >> 3) - 1)


@dataclass
class Allocation:
    pulses: np.ndarray          # PVQ bits per band (1/8 bits)
    ebits: np.ndarray           # fine energy bits per band per channel
    fine_priority: np.ndarray
    coded_bands: int
    balance: int
    intensity: int
    dual_stereo: int


def bits2pulses(mode, band: int, lm: int, bits: int) -> int:
    """Bit budget -> pseudo-pulse count via the mode's bit cache."""
    cache = mode.cache_bits
    off = mode.cache_index[(lm + 1) * mode.nb_ebands + band]
    lo, hi = 0, int(cache[off])
    bits -= 1
    for _ in range(LOG_MAX_PSEUDO):
        mid = (lo + hi + 1) >> 1
        if int(cache[off + mid]) >= bits:
            hi = mid
        else:
            lo = mid
    low_err = bits - (-1 if lo == 0 else int(cache[off + lo]))
    return lo if low_err <= int(cache[off + hi]) - bits else hi


def pulses2bits(mode, band: int, lm: int, pulses: int) -> int:
    off = mode.cache_index[(lm + 1) * mode.nb_ebands + band]
    return 0 if pulses == 0 else int(mode.cache_bits[off + pulses]) + 1


def init_caps(mode, lm: int, channels: int) -> np.ndarray:
    """Per-band hard bit caps (celt.c init_caps)."""
    nb = mode.nb_ebands
    caps = np.zeros(nb, np.int32)
    for j in range(nb):
        n = (int(mode.ebands[j + 1]) - int(mode.ebands[j])) << lm
        caps[j] = (int(mode.cache_caps[(lm * 2 + channels - 1) * nb + j])
                   + 64) * channels * n >> 2
    return caps


def compute_allocation(mode, start: int, end: int, offsets, cap,
                       alloc_trim: int, total: int, channels: int,
                       lm: int, dec, signal_bandwidth: int = 0) -> Allocation:
    """Decoder-side clt_compute_allocation (rate.c:624)."""
    eb = mode.ebands
    av = mode.alloc_vectors
    nvec, nb = av.shape
    C = channels
    total = max(total, 0)
    skip_start = start
    skip_rsv = (1 << BITRES) if total >= (1 << BITRES) else 0
    total -= skip_rsv
    intensity_rsv = dual_stereo_rsv = 0
    if C == 2:
        intensity_rsv = LOG2_FRAC[end - start]
        if intensity_rsv > total:
            intensity_rsv = 0
        else:
            total -= intensity_rsv
            dual_stereo_rsv = (1 << BITRES) if total >= (1 << BITRES) else 0
            total -= dual_stereo_rsv

    thresh = np.zeros(nb, np.int64)
    trim_offset = np.zeros(nb, np.int64)
    for j in range(start, end):
        n = int(eb[j + 1]) - int(eb[j])
        thresh[j] = max(C << BITRES, (3 * n << lm << BITRES) >> 4)
        trim_offset[j] = (C * n * (alloc_trim - 5 - lm) * (end - j - 1)
                          * (1 << (lm + BITRES))) >> 6
        if n << lm == 1:
            trim_offset[j] -= C << BITRES

    def vec_bits(vec: int, j: int) -> int:
        n = int(eb[j + 1]) - int(eb[j])
        return C * n * int(av[vec, j]) << lm >> 2

    lo, hi = 1, nvec - 1
    while lo <= hi:
        mid = (lo + hi) >> 1
        done = False
        psum = 0
        for j in range(end - 1, start - 1, -1):
            b = vec_bits(mid, j)
            if b > 0:
                b = max(0, b + int(trim_offset[j]))
            b += int(offsets[j])
            if b >= thresh[j] or done:
                done = True
                psum += min(b, int(cap[j]))
            elif b >= C << BITRES:
                psum += C << BITRES
        if psum > total:
            hi = mid - 1
        else:
            lo = mid + 1
    hi = lo
    lo -= 1

    bits1 = np.zeros(nb, np.int64)
    bits2 = np.zeros(nb, np.int64)
    for j in range(start, end):
        b1 = vec_bits(lo, j)
        b2 = int(cap[j]) if hi >= nvec else vec_bits(hi, j)
        if b1 > 0:
            b1 = max(0, b1 + int(trim_offset[j]))
        if b2 > 0:
            b2 = max(0, b2 + int(trim_offset[j]))
        if lo > 0:
            b1 += int(offsets[j])
        b2 += int(offsets[j])
        if offsets[j] > 0:
            skip_start = j
        bits1[j] = b1
        bits2[j] = max(0, b2 - b1)

    return _interp_bits2pulses(mode, start, end, skip_start, bits1, bits2,
                               thresh, cap, total, skip_rsv, intensity_rsv,
                               dual_stereo_rsv, C, lm, dec)


def _interp_bits2pulses(mode, start, end, skip_start, bits1, bits2, thresh,
                        cap, total, skip_rsv, intensity_rsv,
                        dual_stereo_rsv, C, lm, dec) -> Allocation:
    eb = mode.ebands
    nb = mode.nb_ebands
    alloc_floor = C << BITRES
    stereo = 1 if C > 1 else 0
    logM = lm << BITRES
    bits = np.zeros(nb, np.int64)
    ebits = np.zeros(nb, np.int64)
    fine_priority = np.zeros(nb, np.int64)

    lo, hi = 0, 1 << ALLOC_STEPS
    for _ in range(ALLOC_STEPS):
        mid = (lo + hi) >> 1
        psum, done = 0, False
        for j in range(end - 1, start - 1, -1):
            tmp = int(bits1[j]) + (mid * int(bits2[j]) >> ALLOC_STEPS)
            if tmp >= thresh[j] or done:
                done = True
                psum += min(tmp, int(cap[j]))
            elif tmp >= alloc_floor:
                psum += alloc_floor
        if psum > total:
            hi = mid
        else:
            lo = mid
    psum, done = 0, False
    for j in range(end - 1, start - 1, -1):
        tmp = int(bits1[j]) + (lo * int(bits2[j]) >> ALLOC_STEPS)
        if tmp < thresh[j] and not done:
            tmp = alloc_floor if tmp >= alloc_floor else 0
        else:
            done = True
        tmp = min(tmp, int(cap[j]))
        bits[j] = tmp
        psum += tmp

    # skip decisions, from the top band down
    coded_bands = end
    while True:
        j = coded_bands - 1
        if j <= skip_start:
            total += skip_rsv
            break
        left = total - psum
        percoeff = left // (int(eb[coded_bands]) - int(eb[start]))
        left -= (int(eb[coded_bands]) - int(eb[start])) * percoeff
        rem = max(left - (int(eb[j]) - int(eb[start])), 0)
        band_width = int(eb[coded_bands]) - int(eb[j])
        band_bits = int(bits[j]) + percoeff * band_width + rem
        if band_bits >= max(int(thresh[j]), alloc_floor + (1 << BITRES)):
            if dec.dec_bit_logp(1):
                break
            psum += 1 << BITRES
            band_bits -= 1 << BITRES
        psum -= int(bits[j]) + intensity_rsv
        if intensity_rsv > 0:
            intensity_rsv = LOG2_FRAC[j - start]
        psum += intensity_rsv
        if band_bits >= alloc_floor:
            psum += alloc_floor
            bits[j] = alloc_floor
        else:
            bits[j] = 0
        coded_bands -= 1

    intensity = 0
    if intensity_rsv > 0:
        intensity = start + dec.dec_uint(coded_bands + 1 - start)
    if intensity <= start:
        total += dual_stereo_rsv
        dual_stereo_rsv = 0
    dual_stereo = dec.dec_bit_logp(1) if dual_stereo_rsv > 0 else 0

    left = total - psum
    percoeff = left // (int(eb[coded_bands]) - int(eb[start]))
    left -= (int(eb[coded_bands]) - int(eb[start])) * percoeff
    for j in range(start, coded_bands):
        bits[j] += percoeff * (int(eb[j + 1]) - int(eb[j]))
    for j in range(start, coded_bands):
        tmp = min(left, int(eb[j + 1]) - int(eb[j]))
        bits[j] += tmp
        left -= tmp

    balance = 0
    for j in range(start, coded_bands):
        n0 = int(eb[j + 1]) - int(eb[j])
        n = n0 << lm
        bit = int(bits[j]) + balance
        if n > 1:
            excess = max(bit - int(cap[j]), 0)
            bits[j] = bit - excess
            den = C * n + (1 if (C == 2 and n > 2 and not dual_stereo
                                 and j < intensity) else 0)
            nclogn = den * (int(mode.logn[j]) + logM)
            offset = (nclogn >> 1) - den * FINE_OFFSET
            if n == 2:
                offset += den << BITRES >> 2
            if bits[j] + offset < den * 2 << BITRES:
                offset += nclogn >> 2
            elif bits[j] + offset < den * 3 << BITRES:
                offset += nclogn >> 3
            eb_j = max(0, int(bits[j]) + offset + (den << (BITRES - 1)))
            eb_j = (eb_j // den) >> BITRES
            if C * eb_j > (int(bits[j]) >> BITRES):
                eb_j = int(bits[j]) >> stereo >> BITRES
            eb_j = min(eb_j, MAX_FINE_BITS)
            fine_priority[j] = int(eb_j * (den << BITRES)
                                   >= int(bits[j]) + offset)
            ebits[j] = eb_j
            bits[j] -= C * eb_j << BITRES
        else:
            excess = max(0, bit - (C << BITRES))
            bits[j] = bit - excess
            ebits[j] = 0
            fine_priority[j] = 1
        if excess > 0:
            extra_fine = min(excess >> (stereo + BITRES),
                             MAX_FINE_BITS - int(ebits[j]))
            ebits[j] += extra_fine
            extra_bits = extra_fine * C << BITRES
            fine_priority[j] = int(extra_bits >= excess - balance)
            excess -= extra_bits
        balance = excess

    for j in range(coded_bands, end):
        ebits[j] = int(bits[j]) >> stereo >> BITRES
        bits[j] = 0
        fine_priority[j] = int(ebits[j] < 1)

    return Allocation(pulses=bits.astype(np.int32),
                      ebits=ebits.astype(np.int32),
                      fine_priority=fine_priority.astype(np.int32),
                      coded_bands=coded_bands, balance=balance,
                      intensity=intensity, dual_stereo=int(dual_stereo))
