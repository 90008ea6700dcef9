"""PVQ codeword (CWRS) and Laplace decoders for CELT (RFC 6716 s4.3),
written from the spec's enumeration; conformance vs the reference
implementation's encode_pulses / ec_laplace_encode via tools/celt_probe.c
(tests/test_opus_pvq.py).

Codeword order (index ascending) for a dimension-n, K-pulse vector:
y0 = +K, +K-1, ..., +1, then 0, then -K, -K+1, ..., -1, each block sized
V(n-1, K - |y0|), recursively.  V is the PVQ vector count
V(n,k) = V(n-1,k) + V(n,k-1) + V(n-1,k-1).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=None)
def V(n: int, k: int) -> int:
    if k == 0:
        return 1
    if n == 0:
        return 0
    return V(n - 1, k) + V(n, k - 1) + V(n - 1, k - 1)


def cwrs_decode(n: int, k: int, index: int) -> np.ndarray:
    """Index -> pulse vector (the inverse of the reference cwrs
    enumeration, validated empirically index-for-index)."""
    y = np.zeros(n, np.int32)
    i = index
    for j in range(n):
        if k == 0:
            break
        if j == n - 1:
            y[j] = k if i == 0 else -k
            k = 0
            break
        # positive magnitudes, descending
        v = k
        placed = False
        while v >= 1:
            block = V(n - j - 1, k - v)
            if i < block:
                y[j] = v
                k -= v
                placed = True
                break
            i -= block
            v -= 1
        if placed:
            continue
        # zero
        block = V(n - j - 1, k)
        if i < block:
            y[j] = 0
            continue
        i -= block
        # negative magnitudes, descending |v|
        v = k
        while v >= 1:
            block = V(n - j - 1, k - v)
            if i < block:
                y[j] = -v
                k -= v
                placed = True
                break
            i -= block
            v -= 1
        if not placed:
            raise ValueError("PVQ index out of range")
    return y


def decode_pulses(dec, n: int, k: int) -> np.ndarray:
    """decode_pulses (cwrs.c): uniform index + enumeration.

    Band splitting guarantees V(n,k) fits the reference's 32-bit codeword
    (bands.c splits any band whose codeword would overflow)."""
    ft = V(n, k)
    assert ft < (1 << 32), (n, k)
    return cwrs_decode(n, k, dec.dec_uint(ft))


# -- Laplace (coarse energy residual, laplace.c / RFC 6716 s4.3.2.1) ------

_LAPLACE_MINP = 1
_LAPLACE_NMIN = 16


def laplace_decode(dec, fs: int, decay: int) -> int:
    val = 0
    fl = 0
    fm = dec.decode_bin(15)
    if fm >= fs:
        val += 1
        fl = fs
        fs = (((32768 - 32 - fs) * (16384 - decay)) >> 15) + _LAPLACE_MINP
        while fs > _LAPLACE_MINP and fm >= fl + 2 * fs:
            fs *= 2
            fl += fs
            fs = (((fs - 2 * _LAPLACE_MINP) * decay) >> 15) + _LAPLACE_MINP
            val += 1
        if fs <= _LAPLACE_MINP:
            di = (fm - fl) >> 1
            val += di
            fl += 2 * di * _LAPLACE_MINP
        if fm < fl + fs:
            val = -val
        else:
            fl += fs
    dec.update(fl, min(fl + fs, 32768), 32768)
    return val
