"""CELT frame decoder (RFC 6716 section 4.3), written from the spec.

Provenance note: RFC 6716 declares the reference implementation
normative, and a bit-exact decoder is forced into its arithmetic and
recursion order.  In particular the PVQ band-quantisation layer here
(_quant_partition/_quant_band) follows the control flow of the
normative decoder's bands.c quant_partition/quant_band — the split
budgeting, rebalance and fold/fill bookkeeping must match exactly for
bit-exactness, so that layer is structured after the normative
reference rather than independently derived.  The data layout
(numpy band matrices, batched device IMDCT) and everything around it
are original.

Behavioural parity target: opus-1.5.2 celt/celt_decoder.c +_bands.c as
consumed by the reference's OpenHome/Media/Codec/Opus.cpp (float build);
validated frame-for-frame against the compiled reference decoder
(tools/celt_probe.c `celtdec`) in tests/test_opus_celt.py.

Decode layers per frame: silence / post-filter params / transient /
intra flags -> coarse energy (Laplace) -> tf_res -> spread -> dynalloc
boosts -> allocation trim -> bit allocation (alloc.py) -> fine energy ->
PVQ band shapes with splitting/stereo (this file) -> anti-collapse ->
denormalisation -> IMDCT synthesis (matmul; batched on device in the
player's group path) -> post-filter comb -> deemphasis.

All integer decisions are bit-exact; float math follows the reference's
float build within a few float32 ulps (conformance bound: int16 PCM
within +/-2 of the oracle).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

from . import alloc as AL
from . import pvq as PVQ
from .mode import CeltMode, celt_mode
from .range_dec import RangeDecoder

BITRES = 3
MAX_PERIOD = 1024
DECODE_BUFFER_SIZE = 2048
CELT_LPC_ORDER = 24
PLC_PITCH_LAG_MAX = 720
PLC_PITCH_LAG_MIN = 100
COMBFILTER_MINPERIOD = 15
SPREAD_NONE, SPREAD_LIGHT, SPREAD_NORMAL, SPREAD_AGGRESSIVE = 0, 1, 2, 3

TRIM_ICDF = (126, 124, 119, 109, 87, 41, 19, 9, 4, 2, 0)
SPREAD_ICDF = (25, 23, 2, 0)
TAPSET_ICDF = (2, 1, 0)
TF_SELECT_TABLE = (
    (0, -1, 0, -1, 0, -1, 0, -1),
    (0, -1, 0, -2, 1, 0, 1, -1),
    (0, -2, 0, -3, 2, 0, 1, -1),
    (0, -2, 0, -3, 3, 0, 1, -1),
)
E_MEANS = np.array([6.4375, 6.25, 5.75, 5.3125, 5.0625, 4.8125, 4.5,
                    4.375, 4.875, 4.6875, 4.5625, 4.4375, 4.875, 4.625,
                    4.3125, 4.5, 4.375, 4.625, 4.75, 4.4375, 3.75],
                   np.float64)
PRED_COEF = (29440 / 32768., 26112 / 32768., 21248 / 32768., 16384 / 32768.)
BETA_COEF = (30147 / 32768., 22282 / 32768., 12124 / 32768., 6554 / 32768.)
BETA_INTRA = 4915 / 32768.
SMALL_ENERGY_ICDF = (2, 1, 0)
COMB_GAINS = ((0.3066406250, 0.2170410156, 0.1296386719),
              (0.4638671875, 0.2680664062, 0.0),
              (0.7998046875, 0.1000976562, 0.0))

# e_prob_model[LM][intra] -> 42 entries (RFC 6716 coarse-energy model)
E_PROB_MODEL = (
    ((72, 127, 65, 129, 66, 128, 65, 128, 64, 128, 62, 128, 64, 128,
      64, 128, 92, 78, 92, 79, 92, 78, 90, 79, 116, 41, 115, 40,
      114, 40, 132, 26, 132, 26, 145, 17, 161, 12, 176, 10, 177, 11),
     (24, 179, 48, 138, 54, 135, 54, 132, 53, 134, 56, 133, 55, 132,
      55, 132, 61, 114, 70, 96, 74, 88, 75, 88, 87, 74, 89, 66,
      91, 67, 100, 59, 108, 50, 120, 40, 122, 37, 97, 43, 78, 50)),
    ((83, 78, 84, 81, 88, 75, 86, 74, 87, 71, 90, 73, 93, 74,
      93, 74, 109, 40, 114, 36, 117, 34, 117, 34, 143, 17, 145, 18,
      146, 19, 162, 12, 165, 10, 178, 7, 189, 6, 190, 8, 177, 9),
     (23, 178, 54, 115, 63, 102, 66, 98, 69, 99, 74, 89, 71, 91,
      73, 91, 78, 89, 86, 80, 92, 66, 93, 64, 102, 59, 103, 60,
      104, 60, 117, 52, 123, 44, 138, 35, 133, 31, 97, 38, 77, 45)),
    ((61, 90, 93, 60, 105, 42, 107, 41, 110, 45, 116, 38, 113, 38,
      112, 38, 124, 26, 132, 27, 136, 19, 140, 20, 155, 14, 159, 16,
      158, 18, 170, 13, 177, 10, 187, 8, 192, 6, 175, 9, 159, 10),
     (21, 178, 59, 110, 71, 86, 75, 85, 84, 83, 91, 66, 88, 73,
      87, 72, 92, 75, 98, 72, 105, 58, 107, 54, 115, 52, 114, 55,
      112, 56, 129, 51, 132, 40, 150, 33, 140, 29, 98, 35, 77, 42)),
    ((42, 121, 96, 66, 108, 43, 111, 40, 117, 44, 123, 32, 120, 36,
      119, 33, 127, 33, 134, 34, 139, 21, 147, 23, 152, 20, 158, 25,
      154, 26, 166, 21, 173, 16, 184, 13, 184, 10, 150, 13, 139, 15),
     (22, 178, 63, 114, 74, 82, 84, 83, 92, 82, 103, 62, 96, 72,
      96, 67, 101, 73, 107, 72, 113, 55, 118, 52, 125, 52, 118, 52,
      117, 55, 135, 49, 137, 39, 157, 32, 145, 29, 97, 33, 77, 40)),
)


def _cdiv(a: int, b: int) -> int:
    """C-style signed integer division (truncates toward zero)."""
    q = abs(a) // b
    return -q if a < 0 else q


def _lcg(seed: int) -> int:
    return (1664525 * seed + 1013904223) & 0xFFFFFFFF


def ec_ilog(v: int) -> int:
    return v.bit_length()


def bitexact_cos(x: int) -> int:
    tmp = (4096 + x * x) >> 13
    x2 = tmp
    x2 = ((32767 - x2)
          + _frac_mul16(x2, -7651 + _frac_mul16(x2,
                                                8277 + _frac_mul16(-626,
                                                                   x2))))
    return 1 + x2


def _frac_mul16(a: int, b: int) -> int:
    return (16384 + a * b) >> 15


def bitexact_log2tan(isin: int, icos: int) -> int:
    lc = ec_ilog(icos)
    ls = ec_ilog(isin)
    icos <<= 15 - lc
    isin <<= 15 - ls
    return ((ls - lc) * (1 << 11)
            + _frac_mul16(isin, _frac_mul16(isin, -2597) + 7932)
            - _frac_mul16(icos, _frac_mul16(icos, -2597) + 7932))


@lru_cache(maxsize=8)
def _imdct_matrix(nb: int) -> np.ndarray:
    """raw[j] = sum_k X[k] cos(pi/nb (nb/2 + j + .5 + nb/2)(k + .5));
    layout/scale validated against clt_mdct_backward (tools/celt_probe)."""
    j = np.arange(nb)[:, None]
    k = np.arange(nb)[None, :]
    return np.cos(np.pi / nb * (nb / 2 + j + 0.5 + nb / 2) * (k + 0.5))


try:
    from scipy.fft import dst as _scipy_dst
except ImportError:          # pragma: no cover - scipy is in the image
    _scipy_dst = None


@lru_cache(maxsize=8)
def _dst4_sign(nb: int) -> np.ndarray:
    return (-1.0) ** np.arange(nb)


def _imdct(freq: np.ndarray, nb: int) -> np.ndarray:
    """O(n log n) IMDCT: the matrix above equals a sign-twiddled DST-IV
    (cos(a + pi(k+.5)) = -(-1)^k sin(a)), so raw = -DST4(X * (-1)^k)/2.
    Matches the matmul to ~1e-13 relative (well under the int16
    conformance bound)."""
    if _scipy_dst is None:
        return _imdct_matrix(nb) @ freq
    return -0.5 * _scipy_dst(freq * _dst4_sign(nb), type=4)


@dataclass
class CeltDecoderState:
    channels: int
    mode: CeltMode = field(default_factory=celt_mode)

    def __post_init__(self):
        nb = self.mode.nb_ebands
        C = self.channels
        # float32 like the reference: the inter-frame energy prediction
        # feeds back (coef up to 0.9), so wider precision here DIVERGES
        # from the normative decoder instead of improving on it
        self.old_ebands = np.zeros(2 * nb, np.float32)
        self.old_logE = np.full(2 * nb, -28.0, np.float32)
        self.old_logE2 = np.full(2 * nb, -28.0, np.float32)
        self.rng = 0
        self.preemph_mem = np.zeros(C, np.float64)
        # synthesis history: per channel, DECODE_BUFFER_SIZE samples of
        # the post-postfilter signal (the reference's decode_mem; PLC
        # pitch search needs the full 2048, celt_decoder.c:62-65)
        self.hist = [np.zeros(DECODE_BUFFER_SIZE + self.mode.overlap,
                              np.float64)
                     for _ in range(C)]
        # packet-loss concealment state (celt_decoder.c:99-107)
        self.loss_duration = 0          # in (1 << LM) units
        self.skip_plc = False
        self.last_pitch_index = 0
        self.background_logE = np.zeros(2 * nb, np.float64)
        self.plc_lpc = [np.zeros(CELT_LPC_ORDER, np.float64)
                        for _ in range(C)]
        self.prefilter_and_fold = False
        self.plc_tail = [np.zeros(self.mode.overlap, np.float64)
                         for _ in range(C)]
        self.carry = [np.zeros(self.mode.overlap // 2, np.float64)
                      for _ in range(C)]
        self.pf_period = 15
        self.pf_period_old = 15
        self.pf_gain = 0.0
        self.pf_gain_old = 0.0
        self.pf_tapset = 0
        self.pf_tapset_old = 0


class _BandCtx:
    __slots__ = ("i", "intensity", "spread", "tf_change", "dec",
                 "remaining_bits", "seed", "disable_inv", "mode",
                 "theta_round", "avoid_split_noise")


def _compute_qn(n: int, b: int, offset: int, pulse_cap: int,
                stereo: bool) -> int:
    exp2_table8 = (16384, 17866, 19483, 21247, 23170, 25267, 27554, 30048)
    n2 = 2 * n - 1
    if stereo and n == 2:
        n2 -= 1
    qb = _cdiv(b + n2 * offset, n2)
    qb = min(b - pulse_cap - (4 << BITRES), qb)
    qb = min(8 << BITRES, qb)
    if qb < (1 << BITRES >> 1):
        return 1
    qn = exp2_table8[qb & 0x7] >> (14 - (qb >> BITRES))
    return (qn + 1) >> 1 << 1


QTHETA_OFFSET = 4
QTHETA_OFFSET_TWOPHASE = 16


def isqrt32(v: int) -> int:
    import math
    return math.isqrt(v)


def _compute_theta(ctx, X, Y, N, b, B, B0, LM, stereo, fill):
    """Returns (b, fill, inv, imid, iside, delta, itheta, qalloc)."""
    m = ctx.mode
    dec = ctx.dec
    pulse_cap = int(m.logn[ctx.i]) + LM * (1 << BITRES)
    offset = (pulse_cap >> 1) - (QTHETA_OFFSET_TWOPHASE
                                 if stereo and N == 2 else QTHETA_OFFSET)
    qn = _compute_qn(N, b, offset, pulse_cap, stereo)
    if stereo and ctx.i >= ctx.intensity:
        qn = 1
    tell = dec.tell_frac()
    inv = 0
    itheta = 0
    if qn != 1:
        if stereo and N > 2:
            p0 = 3
            x0 = qn // 2
            ft = p0 * (x0 + 1) + x0
            fs = dec.decode(ft)
            if fs < (x0 + 1) * p0:
                x = fs // p0
            else:
                x = x0 + 1 + (fs - (x0 + 1) * p0)
            dec.update(p0 * x if x <= x0 else (x - 1 - x0) + (x0 + 1) * p0,
                       p0 * (x + 1) if x <= x0
                       else (x - x0) + (x0 + 1) * p0, ft)
            itheta = x
        elif B0 > 1 or stereo:
            itheta = dec.dec_uint(qn + 1)
        else:
            ft = ((qn >> 1) + 1) * ((qn >> 1) + 1)
            fm = dec.decode(ft)
            if fm < ((qn >> 1) * ((qn >> 1) + 1) >> 1):
                itheta = (isqrt32(8 * fm + 1) - 1) >> 1
                fs = itheta + 1
                fl = itheta * (itheta + 1) >> 1
            else:
                itheta = (2 * (qn + 1) - isqrt32(8 * (ft - fm - 1) + 1)) >> 1
                fs = qn + 1 - itheta
                fl = ft - ((qn + 1 - itheta) * (qn + 2 - itheta) >> 1)
            dec.update(fl, fl + fs, ft)
        itheta = itheta * 16384 // qn
    elif stereo:
        if b > 2 << BITRES and ctx.remaining_bits > 2 << BITRES:
            inv = dec.dec_bit_logp(2)
        else:
            inv = 0
        if ctx.disable_inv:
            inv = 0
        itheta = 0
    qalloc = dec.tell_frac() - tell
    b -= qalloc
    if itheta == 0:
        imid, iside = 32767, 0
        fill &= (1 << B) - 1
        delta = -16384
    elif itheta == 16384:
        imid, iside = 0, 32767
        fill &= ((1 << B) - 1) << B
        delta = 16384
    else:
        imid = bitexact_cos(itheta)
        iside = bitexact_cos(16384 - itheta)
        delta = _frac_mul16((N - 1) << 7, bitexact_log2tan(iside, imid))
    return b, fill, inv, imid, iside, delta, itheta, qalloc


def _quant_band_n1(ctx, X, Y, lowband_out):
    x = X
    for _ in range(2 if Y is not None else 1):
        sign = 0
        if ctx.remaining_bits >= 1 << BITRES:
            sign = ctx.dec.dec_bits(1)
            ctx.remaining_bits -= 1 << BITRES
        x[0] = -1.0 if sign else 1.0
        x = Y
    if lowband_out is not None:
        lowband_out[0] = X[0]
    return 1


_ORDERY = {2: (1, 0), 4: (3, 0, 2, 1), 8: (7, 0, 4, 3, 6, 1, 5, 2),
           16: (15, 0, 8, 7, 12, 3, 11, 4, 14, 1, 9, 6, 13, 2, 10, 5)}


def _deinterleave_hadamard(X, n0, stride, hadamard):
    tmp = np.empty(n0 * stride, X.dtype)
    if hadamard:
        ordery = _ORDERY[stride]
        for i in range(stride):
            tmp[ordery[i] * n0:(ordery[i] + 1) * n0] = X[i::stride]
    else:
        for i in range(stride):
            tmp[i * n0:(i + 1) * n0] = X[i::stride]
    X[:] = tmp


def _interleave_hadamard(X, n0, stride, hadamard):
    tmp = np.empty(n0 * stride, X.dtype)
    if hadamard:
        ordery = _ORDERY[stride]
        for i in range(stride):
            tmp[i::stride] = X[ordery[i] * n0:(ordery[i] + 1) * n0]
    else:
        for i in range(stride):
            tmp[i::stride] = X[i * n0:(i + 1) * n0]
    X[:] = tmp


def _haar1(X, n0, stride):
    n0 >>= 1
    s = 0.70710678
    for i in range(stride):
        a = X[i + stride * 2 * np.arange(n0)]
        b = X[i + stride * (2 * np.arange(n0) + 1)]
        X[i + stride * 2 * np.arange(n0)] = s * (a + b)
        X[i + stride * (2 * np.arange(n0) + 1)] = s * (a - b)


def _exp_rotation1(X, length, stride, c, s):
    ms = -s
    for i in range(length - stride):
        x1 = X[i]
        x2 = X[i + stride]
        X[i + stride] = c * x2 + s * x1
        X[i] = c * x1 + ms * x2
    for i in range(length - 2 * stride - 1, -1, -1):
        x1 = X[i]
        x2 = X[i + stride]
        X[i + stride] = c * x2 + s * x1
        X[i] = c * x1 + ms * x2


def _exp_rotation(X, length, direction, stride, K, spread):
    factor_tab = (15, 10, 5)
    if 2 * K >= length or spread == SPREAD_NONE:
        return
    factor = factor_tab[spread - 1]
    gain = 1.0 * length / (length + factor * K)
    theta = 0.5 * gain * gain
    c = np.cos(0.5 * np.pi * theta)
    s = np.cos(0.5 * np.pi * (1.0 - theta))
    stride2 = 0
    if length >= 8 * stride:
        stride2 = 1
        while (stride2 * stride2 + stride2) * stride + (stride >> 2) \
                < length:
            stride2 += 1
    length //= stride
    for i in range(stride):
        off = i * length
        if direction < 0:
            if stride2:
                _exp_rotation1(X[off:off + length], length, stride2, s, c)
            _exp_rotation1(X[off:off + length], length, 1, c, s)
        else:
            _exp_rotation1(X[off:off + length], length, 1, c, -s)
            if stride2:
                _exp_rotation1(X[off:off + length], length, stride2, s, -c)


def _extract_collapse_mask(iy, N, B):
    if B <= 1:
        return 1
    n0 = N // B
    mask = 0
    for i in range(B):
        if np.any(iy[i * n0:(i + 1) * n0]):
            mask |= 1 << i
    return mask


def _alg_unquant(ctx, X, N, K, spread, B, gain):
    iy = PVQ.decode_pulses(ctx.dec, N, K)
    ryy = float(np.dot(iy.astype(np.float64), iy))
    g = gain / np.sqrt(ryy)
    X[:] = g * iy
    _exp_rotation(X, N, -1, B, K, spread)
    return _extract_collapse_mask(iy, N, B)


def _quant_partition(ctx, X, N, b, B, lowband, LM, gain, fill):
    m = ctx.mode
    i = ctx.i
    B0 = B
    cache_off = int(m.cache_index[(LM + 1) * m.nb_ebands + i])
    cache = m.cache_bits
    if LM != -1 and N > 2 \
            and b > int(cache[cache_off + int(cache[cache_off])]) + 12:
        N >>= 1
        Y = X[N:]
        LM -= 1
        if B == 1:
            fill = (fill & 1) | (fill << 1)
        B = (B + 1) >> 1
        b, fill, _inv, imid, iside, delta, itheta, qalloc = _compute_theta(
            ctx, X, Y, N, b, B, B0, LM, 0, fill)
        mid = imid / 32768.0
        side = iside / 32768.0
        if B0 > 1 and (itheta & 0x3FFF):
            if itheta > 8192:
                delta -= delta >> (4 - LM)
            else:
                delta = min(0, delta + (N << BITRES >> (5 - LM)))
        mbits = max(0, min(b, _cdiv(b - delta, 2)))
        sbits = b - mbits
        ctx.remaining_bits -= qalloc
        next_lowband2 = lowband[N:] if lowband is not None else None
        rebalance = ctx.remaining_bits
        if mbits >= sbits:
            cm = _quant_partition(ctx, X[:N], N, mbits, B, lowband, LM,
                                  gain * mid, fill)
            rebalance = mbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 0:
                sbits += rebalance - (3 << BITRES)
            cm |= _quant_partition(ctx, Y, N, sbits, B, next_lowband2, LM,
                                   gain * side, fill >> B) << (B0 >> 1)
        else:
            cm = _quant_partition(ctx, Y, N, sbits, B, next_lowband2, LM,
                                  gain * side, fill >> B) << (B0 >> 1)
            rebalance = sbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 16384:
                mbits += rebalance - (3 << BITRES)
            cm |= _quant_partition(ctx, X[:N], N, mbits, B, lowband, LM,
                                   gain * mid, fill)
        return cm
    # no-split leaf
    q = AL.bits2pulses(m, i, LM, b)
    curr_bits = AL.pulses2bits(m, i, LM, q)
    ctx.remaining_bits -= curr_bits
    while ctx.remaining_bits < 0 and q > 0:
        ctx.remaining_bits += curr_bits
        q -= 1
        curr_bits = AL.pulses2bits(m, i, LM, q)
        ctx.remaining_bits -= curr_bits
    if q != 0:
        K = AL.get_pulses(q)
        return _alg_unquant(ctx, X[:N], N, K, ctx.spread, B, gain)
    # no pulses: noise/fold fill
    cm_mask = (1 << B) - 1
    fill &= cm_mask
    if not fill:
        X[:N] = 0
        return 0
    if lowband is None:
        # noise fill: signed 32-bit seed >> 20 (about 12 significant bits)
        for j in range(N):
            ctx.seed = _lcg(ctx.seed)
            s32 = ctx.seed - (1 << 32) if ctx.seed >= (1 << 31) \
                else ctx.seed
            X[j] = float(s32 >> 20)
        cm = cm_mask
    else:
        # folded spectrum ~48 dB below normal folding level
        for j in range(N):
            ctx.seed = _lcg(ctx.seed)
            tmp = 1.0 / 256 if (ctx.seed & 0x8000) else -1.0 / 256
            X[j] = lowband[j] + tmp
        cm = fill
    # renormalise
    e = 1e-15 + float(np.dot(X[:N], X[:N]))
    X[:N] *= gain / np.sqrt(e)
    return cm


def _quant_band(ctx, X, N, b, B, lowband, LM, lowband_out, gain,
                lowband_scratch, fill):
    N0 = N
    N_B = N // B
    B0 = B
    time_divide = 0
    recombine = 0
    long_blocks = B0 == 1
    tf_change = ctx.tf_change
    if N == 1:
        return _quant_band_n1(ctx, X, None, lowband_out)
    if tf_change > 0:
        recombine = tf_change
    if lowband_scratch is not None and lowband is not None and \
            (recombine or ((N_B & 1) == 0 and tf_change < 0) or B0 > 1):
        lowband_scratch[:N] = lowband[:N]
        lowband = lowband_scratch
    bit_interleave = (0, 1, 1, 1, 2, 3, 3, 3, 2, 3, 3, 3, 2, 3, 3, 3)
    for k in range(recombine):
        if lowband is not None:
            _haar1(lowband, N >> k, 1 << k)
        fill = bit_interleave[fill & 0xF] | bit_interleave[fill >> 4] << 2
    B >>= recombine
    N_B <<= recombine
    while (N_B & 1) == 0 and tf_change < 0:
        if lowband is not None:
            _haar1(lowband, N_B, B)
        fill |= fill << B
        B <<= 1
        N_B >>= 1
        time_divide += 1
        tf_change += 1
    B0 = B
    N_B0 = N_B
    if B0 > 1 and lowband is not None:
        _deinterleave_hadamard(lowband[:N], N_B >> recombine,
                               B0 << recombine, long_blocks)
    cm = _quant_partition(ctx, X, N, b, B, lowband, LM, gain, fill)
    # resynthesis reordering
    if B0 > 1:
        _interleave_hadamard(X[:N], N_B >> recombine, B0 << recombine,
                             long_blocks)
    N_B = N_B0
    B = B0
    for _ in range(time_divide):
        B >>= 1
        N_B <<= 1
        cm |= cm >> B
        _haar1(X, N_B, B)
    bit_deinterleave = (0x00, 0x03, 0x0C, 0x0F, 0x30, 0x33, 0x3C, 0x3F,
                        0xC0, 0xC3, 0xCC, 0xCF, 0xF0, 0xF3, 0xFC, 0xFF)
    for k in range(recombine):
        cm = bit_deinterleave[cm]
        _haar1(X, N0 >> k, 1 << k)
    B <<= recombine
    if lowband_out is not None:
        n = np.sqrt(N0)
        lowband_out[:N0] = n * X[:N0]
    return cm & ((1 << B) - 1)


def _quant_band_stereo(ctx, X, Y, N, b, B, lowband, LM, lowband_out,
                       lowband_scratch, fill):
    if N == 1:
        return _quant_band_n1(ctx, X, Y, lowband_out)
    orig_fill = fill
    b, fill, inv, imid, iside, delta, itheta, qalloc = _compute_theta(
        ctx, X, Y, N, b, B, B, LM, 1, fill)
    mid = imid / 32768.0
    side = iside / 32768.0
    if N == 2:
        mbits = b
        sbits = 0
        if itheta != 0 and itheta != 16384:
            sbits = 1 << BITRES
        mbits -= sbits
        c = itheta > 8192
        ctx.remaining_bits -= qalloc + sbits
        x2 = Y if c else X
        y2 = X if c else Y
        sign = 0
        if sbits:
            sign = ctx.dec.dec_bits(1)
        sign = 1 - 2 * sign
        cm = _quant_band(ctx, x2, N, mbits, B, lowband, LM, lowband_out,
                         1.0, lowband_scratch, orig_fill)
        y2[0] = -sign * x2[1]
        y2[1] = sign * x2[0]
        X[0] *= mid
        X[1] *= mid
        Y[0] *= side
        Y[1] *= side
        tmp = X[0]
        X[0] = tmp - Y[0]
        Y[0] = tmp + Y[0]
        tmp = X[1]
        X[1] = tmp - Y[1]
        Y[1] = tmp + Y[1]
    else:
        mbits = max(0, min(b, _cdiv(b - delta, 2)))
        sbits = b - mbits
        ctx.remaining_bits -= qalloc
        rebalance = ctx.remaining_bits
        if mbits >= sbits:
            cm = _quant_band(ctx, X, N, mbits, B, lowband, LM,
                             lowband_out, 1.0, lowband_scratch, fill)
            rebalance = mbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 0:
                sbits += rebalance - (3 << BITRES)
            cm |= _quant_band(ctx, Y, N, sbits, B, None, LM, None, side,
                              None, fill >> B)
        else:
            cm = _quant_band(ctx, Y, N, sbits, B, None, LM, None, side,
                             None, fill >> B)
            rebalance = sbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 16384:
                mbits += rebalance - (3 << BITRES)
            cm |= _quant_band(ctx, X, N, mbits, B, lowband, LM,
                              lowband_out, 1.0, lowband_scratch, fill)
    if N != 2:
        _stereo_merge(X, Y, mid, N)
    if inv:
        Y[:N] = -Y[:N]
    return cm


def _stereo_merge(X, Y, mid, N):
    xp = mid * float(np.dot(Y[:N], X[:N]))
    side = float(np.dot(Y[:N], Y[:N]))
    mid2 = mid
    el = mid2 * mid2 + side - 2 * xp
    er = mid2 * mid2 + side + 2 * xp
    if er < 6e-4 or el < 6e-4:
        Y[:N] = X[:N]
        return
    lgain = 1.0 / np.sqrt(el)
    rgain = 1.0 / np.sqrt(er)
    for j in range(N):
        l = mid * X[j]
        r = Y[j]
        X[j] = lgain * (l - r)
        Y[j] = rgain * (l + r)


def quant_all_bands(dec, mode, start, end, X_, Y_, pulses, short_blocks,
                    spread, dual_stereo, intensity, tf_res, total_bits,
                    balance, LM, coded_bands, seed, disable_inv):
    """bands.c quant_all_bands, decode side.  X_/Y_ are (N,) float64."""
    eb = mode.ebands
    M = 1 << LM
    B = M if short_blocks else 1
    C = 2 if Y_ is not None else 1
    norm_offset = M * int(eb[start])
    norm_len = M * int(eb[mode.nb_ebands - 1]) - norm_offset
    norm = np.zeros(norm_len, np.float64)
    norm2 = np.zeros(norm_len, np.float64)
    lowband_scratch_store = np.zeros(M * (int(eb[mode.nb_ebands])
                                          - int(eb[mode.nb_ebands - 1])),
                                     np.float64)
    collapse_masks = np.zeros(mode.nb_ebands * C, np.int32)
    lowband_offset = 0
    update_lowband = True
    ctx = _BandCtx()
    ctx.mode = mode
    ctx.intensity = intensity
    ctx.spread = spread
    ctx.dec = dec
    ctx.seed = seed
    ctx.disable_inv = disable_inv
    ctx.avoid_split_noise = B > 1
    for i in range(start, end):
        ctx.i = i
        last = i == end - 1
        X = X_[M * int(eb[i]):]
        Y = Y_[M * int(eb[i]):] if Y_ is not None else None
        N = M * int(eb[i + 1]) - M * int(eb[i])
        tell = dec.tell_frac()
        if i != start:
            balance -= tell
        remaining_bits = total_bits - tell - 1
        ctx.remaining_bits = remaining_bits
        if i <= coded_bands - 1:
            curr_balance = _cdiv(balance, min(3, coded_bands - i))
            b = max(0, min(16383, min(remaining_bits + 1,
                                      int(pulses[i]) + curr_balance)))
        else:
            b = 0
        if (M * int(eb[i]) - N >= M * int(eb[start]) or i == start + 1) \
                and (update_lowband or lowband_offset == 0):
            lowband_offset = i
        if i == start + 1:
            # special_hybrid_folding
            n1 = M * (int(eb[start + 1]) - int(eb[start]))
            n2 = M * (int(eb[start + 2]) - int(eb[start + 1]))
            norm[n1:n2] = norm[2 * n1 - n2:n1]
            if dual_stereo:
                norm2[n1:n2] = norm2[2 * n1 - n2:n1]
        tf_change = int(tf_res[i])
        ctx.tf_change = tf_change
        lowband_scratch = lowband_scratch_store
        if i >= mode.eff_ebands:
            X = norm
            if Y_ is not None:
                Y = norm
            lowband_scratch = None
        if last:
            lowband_scratch = None
        if lowband_offset != 0 and (spread != SPREAD_AGGRESSIVE or B > 1
                                    or tf_change < 0):
            effective_lowband = max(0, M * int(eb[lowband_offset])
                                    - norm_offset - N)
            fold_start = lowband_offset
            while True:
                fold_start -= 1
                if M * int(eb[fold_start]) <= effective_lowband \
                        + norm_offset:
                    break
            fold_end = lowband_offset - 1
            while True:
                fold_end += 1
                if not (fold_end < i and M * int(eb[fold_end])
                        < effective_lowband + norm_offset + N):
                    break
            x_cm = y_cm = 0
            fold_i = fold_start
            while True:
                x_cm |= int(collapse_masks[fold_i * C + 0])
                y_cm |= int(collapse_masks[fold_i * C + C - 1])
                fold_i += 1
                if fold_i >= fold_end:
                    break
        else:
            effective_lowband = -1
            x_cm = y_cm = (1 << B) - 1
        if dual_stereo and i == intensity:
            dual_stereo = 0
            norm[:M * int(eb[i]) - norm_offset] = 0.5 * (
                norm[:M * int(eb[i]) - norm_offset]
                + norm2[:M * int(eb[i]) - norm_offset])
        if dual_stereo:
            lb = norm[effective_lowband:] if effective_lowband != -1 \
                else None
            lb2 = norm2[effective_lowband:] if effective_lowband != -1 \
                else None
            lo = None if last else norm[M * int(eb[i]) - norm_offset:]
            lo2 = None if last else norm2[M * int(eb[i]) - norm_offset:]
            x_cm = _quant_band(ctx, X, N, b // 2, B, lb, LM, lo, 1.0,
                               lowband_scratch, x_cm)
            y_cm = _quant_band(ctx, Y, N, b // 2, B, lb2, LM, lo2, 1.0,
                               lowband_scratch, y_cm)
        else:
            lb = norm[effective_lowband:] if effective_lowband != -1 \
                else None
            lo = None if last else norm[M * int(eb[i]) - norm_offset:]
            if Y is not None:
                ctx.theta_round = 0
                x_cm = _quant_band_stereo(ctx, X, Y, N, b, B, lb, LM, lo,
                                          lowband_scratch, x_cm | y_cm)
            else:
                x_cm = _quant_band(ctx, X, N, b, B, lb, LM, lo, 1.0,
                                   lowband_scratch, x_cm | y_cm)
            y_cm = x_cm
        collapse_masks[i * C + 0] = x_cm
        collapse_masks[i * C + C - 1] = y_cm
        balance += int(pulses[i]) + tell
        update_lowband = b > (N << BITRES)
        ctx.avoid_split_noise = False
    return collapse_masks, ctx.seed


def tf_decode(dec, start, end, is_transient, LM, storage_bits):
    tf_res = np.zeros(end, np.int32)
    budget = storage_bits
    tell = dec.tell()
    logp = 2 if is_transient else 4
    tf_select_rsv = 1 if (LM > 0 and tell + logp + 1 <= budget) else 0
    budget -= tf_select_rsv
    tf_changed = curr = 0
    for i in range(start, end):
        if tell + logp <= budget:
            curr ^= dec.dec_bit_logp(logp)
            tell = dec.tell()
            tf_changed |= curr
        tf_res[i] = curr
        logp = 4 if is_transient else 5
    tf_select = 0
    row = TF_SELECT_TABLE[LM]
    if tf_select_rsv and row[4 * is_transient + 0 + tf_changed] != \
            row[4 * is_transient + 2 + tf_changed]:
        tf_select = dec.dec_bit_logp(1)
    for i in range(start, end):
        tf_res[i] = row[4 * is_transient + 2 * tf_select + int(tf_res[i])]
    return tf_res


def _unquant_coarse_energy(mode, start, end, old, intra, dec, C, LM,
                           storage_bits):
    prob = E_PROB_MODEL[LM][1 if intra else 0]
    if intra:
        coef = 0.0
        beta = BETA_INTRA
    else:
        beta = BETA_COEF[LM]
        coef = PRED_COEF[LM]
    budget = storage_bits
    f32 = np.float32
    coef = f32(coef)
    beta = f32(beta)
    prev = [f32(0.0), f32(0.0)]
    nb = mode.nb_ebands
    for i in range(start, end):
        for c in range(C):
            tell = dec.tell()
            if budget - tell >= 15:
                pi = 2 * min(i, 20)
                qi = PVQ.laplace_decode(dec, prob[pi] << 7,
                                        prob[pi + 1] << 6)
            elif budget - tell >= 2:
                qi = dec.dec_icdf(SMALL_ENERGY_ICDF, 2)
                qi = (qi >> 1) ^ -(qi & 1)
            elif budget - tell >= 1:
                qi = -dec.dec_bit_logp(1)
            else:
                qi = -1
            q = f32(qi)
            old[i + c * nb] = max(f32(-9.0), old[i + c * nb])
            tmp = f32(f32(coef * old[i + c * nb]) + prev[c]) + q
            old[i + c * nb] = tmp
            prev[c] = f32(prev[c] + q) - f32(beta * q)


def _unquant_fine_energy(mode, start, end, old, fine_quant, dec, C):
    nb = mode.nb_ebands
    for i in range(start, end):
        if fine_quant[i] <= 0:
            continue
        for c in range(C):
            q2 = dec.dec_bits(int(fine_quant[i]))
            offset = np.float32((q2 + 0.5) * (1 << (14 - int(fine_quant[i])))
                                / 16384.0 - 0.5)
            old[i + c * nb] += offset


def _unquant_energy_finalise(mode, start, end, old, fine_quant,
                             fine_priority, bits_left, dec, C):
    nb = mode.nb_ebands
    for prio in (0, 1):
        i = start
        while i < end and bits_left >= C:
            if fine_quant[i] >= AL.MAX_FINE_BITS \
                    or fine_priority[i] != prio:
                i += 1
                continue
            for c in range(C):
                q2 = dec.dec_bits(1)
                offset = np.float32(
                    (q2 - 0.5) * (1 << (14 - int(fine_quant[i]) - 1))
                    / 16384.0)
                old[i + c * nb] += offset
                bits_left -= 1
            i += 1


def _anti_collapse(mode, X, collapse_masks, LM, C, N, start, end, logE,
                   prev1logE, prev2logE, pulses, seed):
    nb = mode.nb_ebands
    eb = mode.ebands
    for i in range(start, end):
        N0 = int(eb[i + 1]) - int(eb[i])
        depth = ((1 + int(pulses[i])) // N0) >> LM
        thresh = 0.5 * np.exp2(-0.125 * depth)
        sqrt_1 = 1.0 / np.sqrt(N0 << LM)
        for c in range(C):
            prev1 = prev1logE[c * nb + i]
            prev2 = prev2logE[c * nb + i]
            if C == 1:
                prev1 = max(prev1, prev1logE[nb + i])
                prev2 = max(prev2, prev2logE[nb + i])
            ediff = max(0.0, logE[c * nb + i] - min(prev1, prev2))
            r = 2.0 * np.exp2(-ediff)
            if LM == 3:
                r *= 1.41421356
            r = min(thresh, r) * sqrt_1
            Xb = X[c * N + (int(eb[i]) << LM):]
            renorm = False
            for k in range(1 << LM):
                if not (int(collapse_masks[i * C + c]) & (1 << k)):
                    for j in range(N0):
                        seed = _lcg(seed)
                        Xb[(j << LM) + k] = r if (seed & 0x8000) else -r
                    renorm = True
            if renorm:
                nband = N0 << LM
                e = 1e-15 + float(np.dot(Xb[:nband], Xb[:nband]))
                Xb[:nband] *= 1.0 / np.sqrt(e)
    return seed


def _use_native_celt() -> bool:
    import os
    if os.environ.get("OHP_CELT_PY"):
        return False
    from ... import native
    return native.have_celt_core()


def _entropy_decode_py(st: CeltDecoderState, data: bytes,
                       dec: RangeDecoder, LM: int, M: int, N: int,
                       start: int, end: int):
    """Python fallback for the native entropy core: everything from the
    frame header through anti-collapse.  Returns (X, silence,
    is_transient, pf_pitch, pf_gain, pf_tapset, final_rng); mutates
    st.old_ebands exactly like celt_core.cc."""
    mode = st.mode
    C = st.channels
    nb = mode.nb_ebands
    eb = mode.ebands
    total_bits = len(data) * 8
    tell = dec.tell()
    if tell >= total_bits:
        silence = 1
    elif tell == 1:
        silence = dec.dec_bit_logp(15)
    else:
        silence = 0
    if silence:
        tell = total_bits
        dec.nbits_total += tell - dec.tell()
    pf_gain = 0.0
    pf_pitch = 0
    pf_tapset = 0
    if start == 0 and tell + 16 <= total_bits:
        if dec.dec_bit_logp(1):
            octave = dec.dec_uint(6)
            pf_pitch = (16 << octave) + dec.dec_bits(4 + octave) - 1
            qg = dec.dec_bits(3)
            if dec.tell() + 2 <= total_bits:
                pf_tapset = dec.dec_icdf(TAPSET_ICDF, 2)
            pf_gain = 0.09375 * (qg + 1)
        tell = dec.tell()
    if LM > 0 and tell + 3 <= total_bits:
        is_transient = dec.dec_bit_logp(3)
        tell = dec.tell()
    else:
        is_transient = 0
    short_blocks = M if is_transient else 0
    intra_ener = dec.dec_bit_logp(3) if tell + 3 <= total_bits else 0
    if not intra_ener and st.loss_duration != 0:
        # post-loss energy safety clamp (celt_decoder.c:1171-1197)
        safety = 1.5 if LM == 0 else (0.5 if LM == 1 else 0.0)
        missing = min(10, st.loss_duration >> LM)
        for c in range(2):
            for i in range(start, end):
                k = c * nb + i
                if st.old_ebands[k] < max(st.old_logE[k],
                                          st.old_logE2[k]):
                    slope = max(st.old_logE[k] - st.old_ebands[k],
                                0.5 * (st.old_logE2[k]
                                       - st.old_ebands[k]))
                    st.old_ebands[k] = max(
                        -20.0,
                        st.old_ebands[k]
                        - max(0.0, (1 + missing) * slope))
                else:
                    st.old_ebands[k] = min(st.old_ebands[k],
                                           st.old_logE[k],
                                           st.old_logE2[k])
                st.old_ebands[k] -= safety
    _unquant_coarse_energy(mode, start, end, st.old_ebands, intra_ener,
                           dec, C, LM, total_bits)
    tf_res = tf_decode(dec, start, end, is_transient, LM, total_bits)
    tell = dec.tell()
    spread = SPREAD_NORMAL
    if tell + 4 <= total_bits:
        spread = dec.dec_icdf(SPREAD_ICDF, 5)
    cap = AL.init_caps(mode, LM, C)
    offsets = np.zeros(nb, np.int64)
    dynalloc_logp = 6
    total_bits_f = total_bits << BITRES
    tell_f = dec.tell_frac()
    for i in range(start, end):
        width = C * (int(eb[i + 1]) - int(eb[i])) << LM
        quanta = min(width << BITRES, max(6 << BITRES, width))
        dynalloc_loop_logp = dynalloc_logp
        boost = 0
        while tell_f + (dynalloc_loop_logp << BITRES) < total_bits_f \
                and boost < cap[i]:
            flag = dec.dec_bit_logp(dynalloc_loop_logp)
            tell_f = dec.tell_frac()
            if not flag:
                break
            boost += quanta
            total_bits_f -= quanta
            dynalloc_loop_logp = 1
        offsets[i] = boost
        if boost > 0:
            dynalloc_logp = max(2, dynalloc_logp - 1)
    alloc_trim = dec.dec_icdf(TRIM_ICDF, 7) \
        if tell_f + (6 << BITRES) <= total_bits_f else 5
    bits = (len(data) * 8 << BITRES) - dec.tell_frac() - 1
    anti_collapse_rsv = (1 << BITRES) if (is_transient and LM >= 2
                                          and bits >= (LM + 2) << BITRES) \
        else 0
    bits -= anti_collapse_rsv
    a = AL.compute_allocation(mode, start, end, offsets, cap, alloc_trim,
                              bits, C, LM, dec)
    _unquant_fine_energy(mode, start, end, st.old_ebands, a.ebits, dec, C)
    X = np.zeros(C * N, np.float64)
    collapse_masks, st.rng = quant_all_bands(
        dec, mode, start, end, X[:N], X[N:] if C == 2 else None, a.pulses,
        short_blocks, spread, a.dual_stereo, a.intensity, tf_res,
        len(data) * (8 << BITRES) - anti_collapse_rsv, a.balance, LM,
        a.coded_bands, st.rng, 0)
    anti_collapse_on = 0
    if anti_collapse_rsv > 0:
        anti_collapse_on = dec.dec_bits(1)
    _unquant_energy_finalise(mode, start, end, st.old_ebands, a.ebits,
                             a.fine_priority,
                             len(data) * 8 - dec.tell(), dec, C)
    if anti_collapse_on:
        st.rng = _anti_collapse(mode, X, collapse_masks, LM, C, N, start,
                                end, st.old_ebands, st.old_logE,
                                st.old_logE2, a.pulses, st.rng)
    if silence:
        st.old_ebands[:] = -28.0
    return (X, silence, is_transient, pf_pitch, pf_gain, pf_tapset,
            dec.rng & 0xFFFFFFFF)


def decode_frame(st: CeltDecoderState, data: bytes, frame_size: int,
                 dec: RangeDecoder | None = None,
                 start_band: int = 0, end_band: int = 21,
                 synthesis: bool = True):
    """Decode one CELT frame -> (channels, frame_size) float in [-1, 1].

    The entropy layer (range decode -> energies -> allocation -> PVQ ->
    anti-collapse) runs in native/celt_core.cc when available; the
    Python path below it is the behaviour oracle (OHP_CELT_PY=1).
    Synthesis (denormalise, IMDCT, post-filter, deemphasis) is the
    numpy path either way."""
    mode = st.mode
    C = st.channels
    nb = mode.nb_ebands
    eb = mode.ebands
    overlap = mode.overlap
    LM = 0
    while mode.short_mdct_size << LM != frame_size:
        LM += 1
        if LM > mode.max_lm:
            raise ValueError("bad frame size")
    M = 1 << LM
    N = M * mode.short_mdct_size
    start, end = start_band, end_band
    eff_end = min(end, mode.eff_ebands)
    if st.loss_duration == 0:
        st.skip_plc = False              # celt_decoder.c:1106
    res = None
    if _use_native_celt() and (dec is None or dec.storage == len(data)):
        from ... import native
        rd_state = None if dec is None else {
            "offs": dec.offs, "end_offs": dec.end_offs,
            "end_window": dec.end_window, "nend_bits": dec.nend_bits,
            "nbits_total": dec.nbits_total, "rng": dec.rng,
            "rem": dec.rem, "val": dec.val, "error": dec.error,
        }
        old_backup = st.old_ebands.copy()
        nres = native.celt_entropy_decode(
            data, rd_state, C, LM, start, end, st.loss_duration, mode,
            st.old_ebands, st.old_logE, st.old_logE2, st.rng)
        if nres is None:
            st.old_ebands[:] = old_backup
        else:
            (X, silence, is_transient, pf_pitch, pf_gain, pf_tapset,
             _ac_on, _seed, rd_out) = nres
            final_rng = rd_out["rng"] & 0xFFFFFFFF
            if dec is not None:
                # keep the shared (hybrid) Python decoder coherent
                dec.offs = rd_out["offs"]
                dec.end_offs = rd_out["end_offs"]
                dec.end_window = rd_out["end_window"]
                dec.nend_bits = rd_out["nend_bits"]
                dec.nbits_total = rd_out["nbits_total"]
                dec.rng = rd_out["rng"]
                dec.rem = rd_out["rem"]
                dec.val = rd_out["val"]
                dec.error = rd_out["error"]
            res = (X, silence, is_transient, pf_pitch, pf_gain,
                   pf_tapset, final_rng)
    if res is None:
        if dec is None:
            dec = RangeDecoder(data)
        res = _entropy_decode_py(st, data, dec, LM, M, N, start, end)
    (X, silence, is_transient, pf_pitch, pf_gain, pf_tapset,
     final_rng) = res
    capture = None
    if not synthesis:
        # entropy-only mode (the device group-synthesis path,
        # celt_jax.py): capture everything the synthesis stage needs
        # and perform ONLY the state bookkeeping below — the synthesis
        # state (TDAC carry, comb history, deemphasis memory) lives on
        # the device.  Callers guarantee no PLC interplay
        # (prefilter_and_fold / loss_duration handling stays host-only).
        assert not st.prefilter_and_fold
        gmat = np.zeros((C, nb), np.float32)
        if not silence:
            for c in range(C):
                for i in range(start, eff_end):
                    gmat[c, i] = np.exp2(
                        min(32.0, float(st.old_ebands[c * nb + i])
                            + float(E_MEANS[i])))
        st.pf_period = max(st.pf_period, COMBFILTER_MINPERIOD)
        st.pf_period_old = max(st.pf_period_old, COMBFILTER_MINPERIOD)
        capture = {
            "X": np.asarray(X, np.float64).reshape(C, N).copy(),
            "gains": gmat,
            "is_transient": bool(is_transient),
            "silence": bool(silence),
            "pf": ((st.pf_period_old, st.pf_gain_old, st.pf_tapset_old),
                   (st.pf_period, st.pf_gain, st.pf_tapset),
                   (max(pf_pitch, COMBFILTER_MINPERIOD), pf_gain,
                    pf_tapset)),
        }
    # ---- synthesis -------------------------------------------------------
    if synthesis and st.prefilter_and_fold:
        # blend the concealed signal's tail into this frame's MDCT
        # overlap (celt_decoder.c:1296)
        _fold_plc_tail(st, N)
    out = np.zeros((C, N), np.float64)
    if is_transient:
        B = M
        NB = mode.short_mdct_size
    else:
        B = 1
        NB = N
    win = mode.window
    ov = overlap
    for c in range(C if synthesis else 0):
        # denormalise
        freq = np.zeros(N, np.float64)
        bound = M * int(eb[eff_end])
        if silence:
            bound = 0
        for i in range(start, eff_end if not silence else start):
            j0 = M * int(eb[i])
            j1 = M * int(eb[i + 1])
            lg = st.old_ebands[c * nb + i] + E_MEANS[i]
            g = np.exp2(min(32.0, lg))
            freq[j0:j1] = X[c * N + j0:c * N + j1] * g
        freq[bound:] = 0
        # per-block IMDCT + folded TDAC (layout validated vs probe imdct)
        buf = np.zeros(N + ov, np.float64)
        buf[:ov // 2] = st.carry[c]
        for b in range(B):
            raw = _imdct(freq[b::B] if B > 1 else freq, NB)
            base = b * NB
            # fft region [base+ov/2, base+ov/2+NB)
            prev = buf[base:base + ov // 2].copy()
            buf[base + ov // 2:base + ov // 2 + NB] = raw
            ii = np.arange(ov // 2)
            x1 = raw[ov // 2 - 1 - ii]
            buf[base + ii] = win[ov - 1 - ii] * prev - win[ii] * x1
            buf[base + ov - 1 - ii] = win[ii] * prev + win[ov - 1 - ii] * x1
        st.carry[c] = buf[N:N + ov // 2].copy()
        out[c] = buf[:N]
    # ---- post-filter (comb) ----------------------------------------------
    st.pf_period = max(st.pf_period, COMBFILTER_MINPERIOD)
    st.pf_period_old = max(st.pf_period_old, COMBFILTER_MINPERIOD)
    for c in range(C if synthesis else 0):
        hist = st.hist[c]
        # the reference filters in place over the synthesis buffer, so a
        # comb read at lag T sees already-filtered samples.  History
        # covers MAX_PERIOD + 2: the widest tap is T + 2 and T itself
        # can reach MAX_PERIOD (a bare MAX_PERIOD slice would wrap
        # x[-2] to the buffer end / read OOB in the native filter).
        HP = MAX_PERIOD + 2
        y = np.concatenate([hist[-HP:], out[c]])
        _comb_filter(y, HP, st.pf_period_old, st.pf_period,
                     mode.short_mdct_size, st.pf_gain_old, st.pf_gain,
                     st.pf_tapset_old, st.pf_tapset, win, ov)
        if LM != 0:
            _comb_filter(y, HP + mode.short_mdct_size,
                         st.pf_period, max(pf_pitch,
                                           COMBFILTER_MINPERIOD),
                         N - mode.short_mdct_size,
                         st.pf_gain, pf_gain, st.pf_tapset, pf_tapset,
                         win, ov)
        out[c] = y[HP:]
        st.hist[c] = np.concatenate([hist, out[c]])[-len(hist):]
    st.pf_period_old = st.pf_period
    st.pf_gain_old = st.pf_gain
    st.pf_tapset_old = st.pf_tapset
    st.pf_period = pf_pitch
    st.pf_gain = pf_gain
    st.pf_tapset = pf_tapset
    if LM != 0:
        st.pf_period_old = st.pf_period
        st.pf_gain_old = st.pf_gain
        st.pf_tapset_old = st.pf_tapset
    # ---- energy history ---------------------------------------------------
    if C == 1:
        st.old_ebands[nb:] = st.old_ebands[:nb]
    if not is_transient:
        st.old_logE2[:] = st.old_logE
        st.old_logE[:] = st.old_ebands
    else:
        st.old_logE[:] = np.minimum(st.old_logE, st.old_ebands)
    for c2 in range(2):
        st.old_ebands[c2 * nb:c2 * nb + start] = 0
        st.old_logE[c2 * nb:c2 * nb + start] = -28.0
        st.old_logE2[c2 * nb:c2 * nb + start] = -28.0
        st.old_ebands[c2 * nb + end:(c2 + 1) * nb] = 0
        st.old_logE[c2 * nb + end:(c2 + 1) * nb] = -28.0
        st.old_logE2[c2 * nb + end:(c2 + 1) * nb] = -28.0
    # background noise-floor tracking for the noise-based PLC
    # (celt_decoder.c:1338-1343): at most 2.4 dB/s increase, all missing
    # packets' budget granted to the recovery packet
    max_bg_inc = min(160, st.loss_duration + M) * 0.001
    np.minimum(st.background_logE + max_bg_inc, st.old_ebands,
               out=st.background_logE)
    st.loss_duration = 0
    st.prefilter_and_fold = False
    # ---- deemphasis --------------------------------------------------------
    # the next frame's noise seed is the range coder's final range state
    # (celt_decoder.c: st->rng = dec->rng)
    st.rng = final_rng
    if not synthesis:
        return capture
    coef0 = mode.preemph[0]
    pcm = np.zeros((C, N), np.float64)
    use_native = _use_native_celt()
    if use_native:
        from ... import native
    for c in range(C):
        m = st.preemph_mem[c]
        x = out[c]
        if use_native:
            pcm[c], m = native.celt_deemphasis(x, coef0, m)
        else:
            for j in range(N):
                tmp = x[j] + m
                m = coef0 * tmp
                pcm[c, j] = tmp
        st.preemph_mem[c] = m
    return pcm / 32768.0


def _comb_filter(x, off, T0, T1, N, g0, g1, tapset0, tapset1, window,
                 overlap):
    """celt.c comb_filter, in place over x[off:off+N].

    Reads at lag T must see already-filtered samples (the reference
    filters in place), so the tail is processed in chunks shorter than
    the lag."""
    if g0 == 0 and g1 == 0:
        return
    if _use_native_celt():
        from ... import native
        native.celt_comb_filter(x, int(off), int(T0), int(T1), int(N),
                                float(g0), float(g1), int(tapset0),
                                int(tapset1), window, int(overlap))
        return
    T0 = max(T0, COMBFILTER_MINPERIOD)
    T1 = max(T1, COMBFILTER_MINPERIOD)
    g00 = g0 * COMB_GAINS[tapset0][0]
    g01 = g0 * COMB_GAINS[tapset0][1]
    g02 = g0 * COMB_GAINS[tapset0][2]
    g10 = g1 * COMB_GAINS[tapset1][0]
    g11 = g1 * COMB_GAINS[tapset1][1]
    g12 = g1 * COMB_GAINS[tapset1][2]
    ov = overlap
    if g0 == g1 and T0 == T1 and tapset0 == tapset1:
        ov = 0
    ov = min(ov, N)
    x1 = x[off - T1 + 1]
    x2 = x[off - T1]
    x3 = x[off - T1 - 1]
    x4 = x[off - T1 - 2]
    for i in range(ov):
        x0 = x[off + i - T1 + 2]
        f = window[i] * window[i]
        x[off + i] = (x[off + i]
                      + (1 - f) * g00 * x[off + i - T0]
                      + (1 - f) * g01 * (x[off + i - T0 + 1]
                                         + x[off + i - T0 - 1])
                      + (1 - f) * g02 * (x[off + i - T0 + 2]
                                         + x[off + i - T0 - 2])
                      + f * g10 * x2
                      + f * g11 * (x1 + x3)
                      + f * g12 * (x0 + x4))
        x4, x3, x2, x1 = x3, x2, x1, x0
    if g1 == 0:
        return
    # constant-filter tail, chunked so lagged reads see filtered samples
    i0 = off + ov
    endi = off + N
    step = max(1, T1 - 2)
    while i0 < endi:
        i1 = min(i0 + step, endi)
        x[i0:i1] = (x[i0:i1]
                    + g10 * x[i0 - T1:i1 - T1]
                    + g11 * (x[i0 - T1 + 1:i1 - T1 + 1]
                             + x[i0 - T1 - 1:i1 - T1 - 1])
                    + g12 * (x[i0 - T1 + 2:i1 - T1 + 2]
                             + x[i0 - T1 - 2:i1 - T1 - 2]))
        i0 = i1


# ---------------------------------------------------------------------------
# Packet-loss concealment (celt/celt_decoder.c celt_decode_lost + the
# pitch machinery from celt/pitch.c and celt/celt_lpc.c, float build)
# ---------------------------------------------------------------------------


def _celt_autocorr(x: np.ndarray, lag: int, window=None,
                   overlap: int = 0) -> np.ndarray:
    """celt_lpc.c _celt_autocorr (float): windowed ends, plain sums."""
    xx = x.astype(np.float64).copy()
    if overlap:
        xx[:overlap] *= window[:overlap]
        xx[-overlap:] *= window[:overlap][::-1]
    n = len(xx)
    return np.array([np.dot(xx[:n - k], xx[k:]) for k in range(lag + 1)])


def _celt_lpc(ac: np.ndarray, p: int) -> np.ndarray:
    """celt_lpc.c _celt_lpc: Levinson-Durbin, float."""
    lpc = np.zeros(p)
    error = ac[0]
    if error != 0.0:
        for i in range(p):
            rr = 0.0
            for j in range(i):
                rr += lpc[j] * ac[i - j]
            rr += ac[i + 1]
            r = -rr / error
            lpc[i] = r
            for j in range((i + 1) >> 1):
                tmp1, tmp2 = lpc[j], lpc[i - 1 - j]
                lpc[j] = tmp1 + r * tmp2
                lpc[i - 1 - j] = tmp2 + r * tmp1
            error = error - r * r * error
            if error < 0.001 * ac[0]:
                break
    return lpc


def _celt_fir(x: np.ndarray, num: np.ndarray) -> np.ndarray:
    """celt_lpc.c celt_fir: y[i] = x[i] + sum num[j]*x[i-j-1] with the
    CELT_LPC_ORDER history taken from the samples preceding x (caller
    prepends them)."""
    ord_ = len(num)
    n = len(x) - ord_
    y = np.zeros(n)
    for i in range(n):
        s = x[ord_ + i]
        for j in range(ord_):
            s += num[j] * x[ord_ + i - j - 1]
        y[i] = s
    return y


def _celt_iir(x: np.ndarray, den: np.ndarray,
              mem: np.ndarray) -> np.ndarray:
    """celt_lpc.c celt_iir: y[i] = x[i] - sum den[j]*y[i-j-1]."""
    ord_ = len(den)
    hist = list(mem[:ord_])          # hist[0] = y[i-1]
    y = np.zeros(len(x))
    for i in range(len(x)):
        s = x[i]
        for j in range(ord_):
            s -= den[j] * hist[j]
        hist = [s] + hist[:-1]
        y[i] = s
    return y


def _pitch_downsample(chans: list, length: int) -> np.ndarray:
    """pitch.c pitch_downsample: 2x decimation + 4th-order whitening
    with an added zero (float arithmetic)."""
    half = length >> 1
    x_lp = np.zeros(half)
    for x in chans:
        x = x[-length:]
        x_lp[1:] += (0.25 * x[1:2 * half - 1:2] + 0.25 * x[3:2 * half:2]
                     + 0.5 * x[2:2 * half:2])[:half - 1]
        x_lp[0] += 0.25 * x[1] + 0.5 * x[0]
    ac = _celt_autocorr(x_lp, 4)
    ac[0] *= 1.0001
    for i in range(1, 5):
        ac[i] -= ac[i] * (0.008 * i) * (0.008 * i)
    lpc = _celt_lpc(ac, 4)
    tmp = 1.0
    for i in range(4):
        tmp *= 0.9
        lpc[i] *= tmp
    c1 = 0.8
    lpc2 = np.array([lpc[0] + 0.8, lpc[1] + c1 * lpc[0],
                     lpc[2] + c1 * lpc[1], lpc[3] + c1 * lpc[2],
                     c1 * lpc[3]])
    # celt_fir5 in place with zero initial history
    out = x_lp.copy()
    mem = np.zeros(5)
    for i in range(half):
        s = x_lp[i] + np.dot(lpc2, mem)
        mem[1:] = mem[:-1]
        mem[0] = x_lp[i]
        out[i] = s
    return out


def _find_best_pitch(xcorr: np.ndarray, y: np.ndarray,
                     length: int) -> list:
    """pitch.c find_best_pitch (float)."""
    Syy = 1.0
    best_num = [-1.0, -1.0]
    best_den = [0.0, 0.0]
    best_pitch = [0, 1]
    Syy += np.dot(y[:length], y[:length])
    for i in range(len(xcorr)):
        if xcorr[i] > 0:
            xcorr16 = xcorr[i] * 1e-12      # avoid overflow paranoia
            num = xcorr16 * xcorr16
            if num * best_den[1] > best_num[1] * Syy:
                if num * best_den[0] > best_num[0] * Syy:
                    best_num[1] = best_num[0]
                    best_den[1] = best_den[0]
                    best_pitch[1] = best_pitch[0]
                    best_num[0] = num
                    best_den[0] = Syy
                    best_pitch[0] = i
                else:
                    best_num[1] = num
                    best_den[1] = Syy
                    best_pitch[1] = i
        Syy += y[i + length] * y[i + length] - y[i] * y[i]
        Syy = max(1.0, Syy)
    return best_pitch


def _pitch_search(x_lp: np.ndarray, y: np.ndarray, length: int,
                  max_pitch: int) -> int:
    """pitch.c pitch_search: coarse 4x + fine 2x + pseudo-interp."""
    lag = length + max_pitch
    x_lp4 = x_lp[: length >> 1:2]
    y_lp4 = y[: lag >> 1:2]
    # coarse search at 4x decimation
    n4 = length >> 2
    xcorr4 = np.array([np.dot(x_lp4[:n4], y_lp4[i:i + n4])
                       for i in range(max_pitch >> 2)])
    best = _find_best_pitch(xcorr4, y_lp4, n4)
    # fine search at 2x
    n2 = length >> 1
    xcorr = np.zeros(max_pitch >> 1)
    for i in range(max_pitch >> 1):
        if abs(i - 2 * best[0]) > 2 and abs(i - 2 * best[1]) > 2:
            continue
        xcorr[i] = max(-1.0, np.dot(x_lp[:n2], y[i:i + n2]))
    best = _find_best_pitch(xcorr, y, n2)
    # pseudo-interpolation
    offset = 0
    if 0 < best[0] < (max_pitch >> 1) - 1:
        a, b, c = xcorr[best[0] - 1], xcorr[best[0]], xcorr[best[0] + 1]
        if (c - a) > 0.7 * (b - a):
            offset = 1
        elif (a - c) > 0.7 * (b - c):
            offset = -1
    return 2 * best[0] - offset


def _plc_pitch_search(st: CeltDecoderState) -> int:
    # hist is pure past output; its tail is the decode_mem window
    chans = [st.hist[c][-DECODE_BUFFER_SIZE:]
             for c in range(st.channels)]
    lp = _pitch_downsample(chans, DECODE_BUFFER_SIZE)
    pitch = _pitch_search(lp[PLC_PITCH_LAG_MAX >> 1:], lp,
                          DECODE_BUFFER_SIZE - PLC_PITCH_LAG_MAX,
                          PLC_PITCH_LAG_MAX - PLC_PITCH_LAG_MIN)
    return PLC_PITCH_LAG_MAX - pitch


def decode_lost(st: CeltDecoderState, frame_size: int) -> np.ndarray:
    """Conceal one lost CELT frame (celt_decode_lost): noise-based
    comfort fill after long losses / at startup, pitch-based
    waveform extrapolation in the excitation domain otherwise.
    Returns (C, frame_size) float PCM in [-1, 1]."""
    mode = st.mode
    C = st.channels
    nb = mode.nb_ebands
    ov = mode.overlap
    win = mode.window
    N = frame_size
    LM = 0
    while mode.short_mdct_size << LM != N:
        LM += 1
    eb = mode.ebands
    noise_based = st.loss_duration >= 40 or st.skip_plc
    out = np.zeros((C, N), np.float64)
    if noise_based:
        # fold the pending extrapolation tail if one exists, so the
        # synthesis below TDAC-blends with the concealed signal
        if st.prefilter_and_fold:
            _fold_plc_tail(st, N)
        decay = 1.5 if st.loss_duration == 0 else 0.5
        end = 21
        eff_end = max(0, min(end, mode.eff_ebands))
        for c in range(C):
            for i in range(end):
                st.old_ebands[c * nb + i] = max(
                    st.background_logE[c * nb + i],
                    st.old_ebands[c * nb + i] - decay)
        seed = st.rng
        X = np.zeros(C * N, np.float64)
        for c in range(C):
            for i in range(eff_end):
                boffs = N * c + (int(eb[i]) << LM)
                blen = (int(eb[i + 1]) - int(eb[i])) << LM
                vals = np.zeros(blen)
                for j in range(blen):
                    seed = (seed * 1664525 + 1013904223) & 0xFFFFFFFF
                    vals[j] = float(np.int32(seed) >> 20)
                nrm = np.sqrt((vals * vals).sum())
                if nrm > 1e-15:
                    vals *= 1.0 / nrm
                X[boffs:boffs + blen] = vals
        st.rng = seed
        # synthesis (celt_synthesis, shortBlocks=0): denormalise + IMDCT
        for c in range(C):
            freq = np.zeros(N)
            for i in range(eff_end):
                j0, j1 = int(eb[i]) << LM, int(eb[i + 1]) << LM
                lg = st.old_ebands[c * nb + i] + E_MEANS[i]
                freq[j0:j1] = X[c * N + j0:c * N + j1] \
                    * np.exp2(min(32.0, lg))
            buf = np.zeros(N + ov)
            buf[:ov // 2] = st.carry[c]
            raw = _imdct(freq, N)
            prev = buf[:ov // 2].copy()
            buf[ov // 2:ov // 2 + N] = raw
            ii = np.arange(ov // 2)
            x1 = raw[ov // 2 - 1 - ii]
            buf[ii] = win[ov - 1 - ii] * prev - win[ii] * x1
            buf[ov - 1 - ii] = win[ii] * prev + win[ov - 1 - ii] * x1
            st.carry[c] = buf[N:N + ov // 2].copy()
            out[c] = buf[:N]
            st.hist[c] = np.concatenate([st.hist[c], out[c]]) \
                [-len(st.hist[c]):]
        st.prefilter_and_fold = False
        st.skip_plc = True
    else:
        if st.loss_duration == 0:
            st.last_pitch_index = pitch_index = _plc_pitch_search(st)
            fade = 1.0
        else:
            pitch_index = st.last_pitch_index
            fade = 0.8
        exc_length = min(2 * pitch_index, MAX_PERIOD)
        for c in range(C):
            buf = st.hist[c][-DECODE_BUFFER_SIZE:].copy()  # decode_mem
            DBS = len(buf)
            exc_full = buf[DBS - MAX_PERIOD - CELT_LPC_ORDER:]
            if st.loss_duration == 0:
                ac = _celt_autocorr(exc_full[CELT_LPC_ORDER:],
                                    CELT_LPC_ORDER, win, ov)
                ac[0] *= 1.0001
                for i in range(1, CELT_LPC_ORDER + 1):
                    ac[i] -= ac[i] * (0.008 * i) * (0.008 * i)
                st.plc_lpc[c] = _celt_lpc(ac, CELT_LPC_ORDER)
            lpc = st.plc_lpc[c]
            # excitation for exc_length samples before the loss
            exc = exc_full.copy()
            fir_in = exc_full[MAX_PERIOD - exc_length:]
            exc[CELT_LPC_ORDER + MAX_PERIOD - exc_length:] = _celt_fir(
                fir_in, lpc)
            exc = exc[CELT_LPC_ORDER:]          # drop history samples
            # decaying-signal detection
            decay_length = exc_length >> 1
            E1 = 1.0 + (exc[MAX_PERIOD - decay_length:] ** 2).sum()
            E2 = 1.0 + (exc[MAX_PERIOD - 2 * decay_length:
                            MAX_PERIOD - decay_length] ** 2).sum()
            E1 = min(E1, E2)
            decay = np.sqrt(E1 / E2)
            # extrapolate excitation with the pitch period
            extrapolation_offset = MAX_PERIOD - pitch_index
            extrapolation_len = N + ov
            attenuation = fade * decay
            ext = np.zeros(extrapolation_len)
            S1 = 0.0
            j = 0
            for i in range(extrapolation_len):
                if j >= pitch_index:
                    j -= pitch_index
                    attenuation *= decay
                ext[i] = attenuation * exc[extrapolation_offset + j]
                # the reference indexes after shifting decode_mem left
                # by N; on the unshifted history that is DBS-MAX_PERIOD
                tmp = buf[DBS - MAX_PERIOD + extrapolation_offset + j]
                S1 += tmp * tmp      # float build: SHR32 is a no-op
                j += 1
            # back to signal domain through the synthesis filter; the
            # IIR memory is the newest decoded samples
            mem = buf[DBS - 1 - np.arange(CELT_LPC_ORDER)]
            sig = _celt_iir(ext, lpc, mem)
            S2 = (sig * sig).sum()
            if not (S1 > 0.2 * S2):
                sig[:] = 0.0
            elif S1 < S2:
                ratio = np.sqrt((S1 + 1) / (S2 + 1))
                g = 1.0 - win[:ov] * (1.0 - ratio)
                sig[:ov] *= g
                sig[ov:] *= ratio
            out[c] = sig[:N]
            st.plc_tail[c] = sig[N:N + ov].copy()
            st.hist[c] = np.concatenate([st.hist[c],
                                         out[c]])[-len(st.hist[c]):]
        st.prefilter_and_fold = True
    st.loss_duration = min(10000, st.loss_duration + (1 << LM))
    # deemphasis (same as the normal output path)
    coef0 = mode.preemph[0]
    pcm = np.zeros((C, N))
    for c in range(C):
        m = st.preemph_mem[c]
        x = out[c]
        for jj in range(N):
            tmp = x[jj] + m
            m = coef0 * tmp
            pcm[c, jj] = tmp
        st.preemph_mem[c] = m
    return pcm / 32768.0


def _fold_plc_tail(st: CeltDecoderState, N: int) -> None:
    """prefilter_and_fold (celt_decoder.c:515-551): pre-filter the
    extrapolated overlap tail with the negated post-filter and simulate
    TDAC so it blends with the next MDCT frame; replaces the carry."""
    mode = st.mode
    ov = mode.overlap
    win = mode.window
    HP = MAX_PERIOD + 2               # taps reach T + 2, T <= MAX_PERIOD
    T1 = max(st.pf_period, COMBFILTER_MINPERIOD)
    g = -st.pf_gain
    t0, t1, t2 = COMB_GAINS[st.pf_tapset]
    for c in range(st.channels):
        tail = st.plc_tail[c]
        y = np.concatenate([st.hist[c][-HP:], tail])
        # the reference folds with window=NULL/overlap=0: no crossfade,
        # only the new (negated) post-filter params apply — and the
        # comb runs OUT-of-place (comb_filter(etmp, decode_mem+..)),
        # so every lag tap reads the UNfiltered input, unlike the
        # in-place feedback comb of the normal decode path
        # (celt_decoder.c:532-540 over celt.c comb_filter_const_c)
        idx = HP + np.arange(ov)
        if g != 0.0:
            etmp = (y[idx]
                    + g * t0 * y[idx - T1]
                    + g * t1 * (y[idx - T1 + 1] + y[idx - T1 - 1])
                    + g * t2 * (y[idx - T1 + 2] + y[idx - T1 - 2]))
        else:
            etmp = y[idx]
        ii = np.arange(ov // 2)
        st.carry[c] = (win[ii] * etmp[ov - 1 - ii]
                       + win[ov - 1 - ii] * etmp[ii])
