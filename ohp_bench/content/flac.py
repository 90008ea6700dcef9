"""CD-quality FLAC content from a seed: the synthetic track and its encoder.

Frozen copies, made at commit 15c54f8 of this repository, of:

- ``make_track`` from ``ohpipeline_tpu_torch/bench.py`` (unchanged);
- ``encode_flac`` and its helpers from
  ``ohpipeline_tpu_torch/host/codecs/flac/encoder.py``, with the frame
  tables and constants it imports from ``host/codecs/flac/frames.py`` and
  ``crc8`` / ``crc16`` from ``host/codecs/flac/bitreader.py``.

Edits, all for speed; the bytes written are the same (the benchmark's tests
hold them to digests of the port's encoder at 15c54f8):

- the residuals are written as arrays of (value, width) fields, packed into
  bytes once per track (``_pack``), not bit by bit through ``BitWriter``;
- a partition's Rice parameter is chosen from sums of ``z >> k`` for every
  ``k`` at once (``_rice_params``), with the same candidates, costs and
  tie rule as ``_best_rice_param``;
- every frame's CRC-16 is computed in one pass over all the frames of the
  track (``_crc16_frames``);
- ``encode_flac`` also returns, with ``stats=True``, the count of samples
  in subframes with a predictor and of their prediction taps, from which
  the benchmark's roofline of the LPC kernel counts its work.

The benchmark's content must not move when the port does, so nothing here
imports the port.
"""

from __future__ import annotations

import hashlib

import numpy as np

RATE = 44100

SYNC = 0b11111111111110
BLOCKSIZE_TABLE = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                   8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                   13: 8192, 14: 16384, 15: 32768}
RATE_TABLE = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
              7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000}
SAMPLE_SIZE_TABLE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}
ASSIGN_LEFT_SIDE = 8
ASSIGN_RIGHT_SIDE = 9
ASSIGN_MID_SIDE = 10

_BS_CODE = {v: k for k, v in BLOCKSIZE_TABLE.items()}
_RATE_CODE = {v: k for k, v in RATE_TABLE.items()}
_SS_CODE = {v: k for k, v in SAMPLE_SIZE_TABLE.items()}
#: Rice parameters the encoder may choose (``_best_rice_param``'s range).
_MAX_PARAM = 14


def make_track(seconds: float, rate: int = 44100, seed: int = 7):
    """Tones, noise and transients, per-seed frequencies and envelopes,
    16-bit stereo: (2, n) int32."""
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    f1 = 200 + 1800 * rng.random()
    f2 = 100 + 500 * rng.random()
    base = (0.6 * np.sin(2 * np.pi * f1 * t)
            + 0.25 * np.sin(2 * np.pi * f2 * t + rng.random() * 6)
            + 0.02 * rng.standard_normal(n))
    env = 0.55 + 0.45 * np.sin(2 * np.pi * (0.1 + 0.3 * rng.random()) * t)
    base *= env
    for s in rng.integers(0, max(n - 2000, 1), size=int(seconds * 2)):
        base[s:s + 800] += 0.5 * np.sign(
            np.sin(2 * np.pi * 37 * t[:800])) * np.exp(-t[:800] * 400)
    x = np.stack([base, np.roll(base, int(rng.integers(5, 50)))])
    return np.clip(np.rint(x * 20000), -32768, 32767).astype(np.int32)


# ---------------------------------------------------------------------------
# bit fields
# ---------------------------------------------------------------------------

class _Fields:
    """An MSB-first bit stream as fields: a field of width ``w`` holds the
    value ``v`` (< 2 ** nb, nb <= 32) in its last ``nb`` bits and zeros
    before them, so a Rice code of any quotient is one field."""

    def __init__(self):
        self.chunks: list = []
        self._v: list = []
        self._nb: list = []
        self.bits = 0

    def write(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        while nbits > 32:                      # only zeros lead a field
            nbits -= 32
            self._put(value >> nbits, 32, 32)
            value &= (1 << nbits) - 1
        self._put(value & ((1 << nbits) - 1), nbits, nbits)

    def write_signed(self, value: int, nbits: int) -> None:
        self.write(value & ((1 << nbits) - 1), nbits)

    def write_unary(self, q: int) -> None:
        self._put(1, 1, q + 1)

    def _put(self, v: int, nb: int, w: int) -> None:
        self._v.append(v)
        self._nb.append((nb, w))
        self.bits += w

    def write_many(self, v: np.ndarray, nb: np.ndarray, w: np.ndarray):
        self._flush()
        self.chunks.append((v.astype(np.uint64), nb.astype(np.int64),
                            w.astype(np.int64)))
        self.bits += int(w.sum())

    def write_utf8_coded(self, value: int) -> None:
        if value < 0x80:
            self.write(value, 8)
            return
        n = 1
        while True:
            bits = 6 - n if n < 6 else 0
            total = bits + 6 * n
            if value < (1 << total):
                break
            n += 1
        lead = (0xFF << (7 - n)) & 0xFF
        shift = 6 * n
        self.write(lead | ((value >> shift) & ((1 << (6 - n)) - 1)), 8)
        for i in range(n - 1, -1, -1):
            self.write(0x80 | ((value >> (6 * i)) & 0x3F), 8)

    def align_byte(self) -> None:
        if self.bits % 8:
            self.write(0, 8 - self.bits % 8)

    def _flush(self) -> None:
        if self._v:
            nbw = np.asarray(self._nb, np.int64)
            self.chunks.append((np.asarray(self._v, np.uint64), nbw[:, 0],
                                nbw[:, 1]))
            self._v, self._nb = [], []

    def getvalue(self) -> bytes:
        self._flush()
        assert self.bits % 8 == 0, "unaligned"
        if not self.chunks:
            return b""
        v, nb, w = (np.concatenate(a) for a in zip(*self.chunks))
        return _pack(v, nb, w, self.bits)


def _pack(v: np.ndarray, nb: np.ndarray, w: np.ndarray, bits: int) -> bytes:
    """The fields laid end to end, as bytes.  Fields do not overlap, so
    summing each one's share of its 32-bit words is OR-ing them."""
    end = np.cumsum(w)
    hi = (end - 1) // 32
    s = (32 * (hi + 1) - end).astype(np.uint64)
    lo_part = (v << s) & np.uint64(0xFFFFFFFF)
    hi_part = v >> (np.uint64(32) - s)
    nw = -(-bits // 32)
    words = np.bincount(hi, weights=lo_part.astype(np.float64),
                        minlength=nw)
    words += np.bincount(np.maximum(hi - 1, 0),
                         weights=np.where(hi > 0, hi_part, 0)
                         .astype(np.float64), minlength=nw)
    return words.astype(np.uint32).astype(">u4").tobytes()[:bits // 8]


def _zigzag(res: np.ndarray) -> np.ndarray:
    r = res.astype(np.int64)
    return np.where(r >= 0, r << 1, ((-r) << 1) - 1)


def _rice_params(z: np.ndarray, starts: np.ndarray) -> tuple:
    """Per partition (``starts`` into ``z``): the Rice parameter that
    ``_best_rice_param`` picks and its cost in bits, as lists."""
    ends = np.append(starts[1:], len(z))
    n = ends - starts
    sums = np.add.reduceat(z[None, :] >> np.arange(_MAX_PARAM)[:, None],
                           starts, axis=1)
    params, costs = [], []
    for j in range(len(starts)):
        nj = int(n[j])
        if nj == 0:
            params.append(0)
            costs.append(0)
            continue
        s0 = int(sums[0, j])
        mean = max(int(s0 / nj), 1)
        guess = max(mean.bit_length() - 1, 0)
        best, best_cost = 0, None
        for p in range(max(0, guess - 2), min(_MAX_PARAM, guess + 3)):
            c = int(sums[p, j]) + nj * (p + 1)
            if best_cost is None or c < best_cost:
                best, best_cost = p, c
        params.append(best)
        costs.append(best_cost)
    return params, costs


def _rice_bits(res: np.ndarray) -> int:
    """``_rice_cost(res, _best_rice_param(res))``."""
    if len(res) == 0:
        return 0
    return _rice_params(_zigzag(res), np.zeros(1, np.int64))[1][0]


def _write_residuals(bw: _Fields, res: np.ndarray, blocksize: int,
                     order: int, porder: int) -> None:
    npart = 1 << porder
    bw.write(0, 2)            # rice method 0 (4-bit params)
    bw.write(porder, 4)
    sizes = [(blocksize >> porder) - (order if p == 0 else 0)
             for p in range(npart)]
    starts = np.cumsum([0] + sizes[:-1])
    z = _zigzag(res)
    params, _ = _rice_params(z, starts)
    maxabs = np.maximum.reduceat(np.abs(res.astype(np.int64)), starts)
    for p in range(npart):
        a, n, param = int(starts[p]), sizes[p], params[p]
        part = res[a:a + n].astype(np.int64)
        mx = int(maxabs[p]) if n else 0
        if mx and (mx >> param) > 1 << 16:
            raw = max(int(part.min()).bit_length(),
                      int(part.max()).bit_length()) + 1
            bw.write(15, 4)
            bw.write(raw, 5)
            width = np.full(n, raw)
            bw.write_many(part & ((1 << raw) - 1), width, width)
        else:
            bw.write(param, 4)
            zp = z[a:a + n]
            v = (1 << param) | (zp & ((1 << param) - 1))
            bw.write_many(v, np.full(n, param + 1), (zp >> param) + 1 + param)


def _pick_porder(blocksize: int, order: int, max_porder: int = 4) -> int:
    po = 0
    while (po < max_porder and blocksize % (1 << (po + 1)) == 0
           and (blocksize >> (po + 1)) > max(order, 16)):
        po += 1
    return po


def _quantise_lpc(autoc: np.ndarray, order: int,
                  precision: int = 14) -> tuple[np.ndarray, int] | None:
    """Levinson-Durbin -> quantised integer coefficients + shift."""
    err = autoc[0]
    if err <= 0:
        return None
    lpc = np.zeros(order)
    for i in range(order):
        acc = autoc[i + 1] - np.dot(lpc[:i], autoc[i:0:-1][:i])
        k = acc / err
        lpc[:i] = lpc[:i] - k * lpc[i - 1::-1][:i]
        lpc[i] = k
        err *= 1 - k * k
        if err <= 0:
            return None
    cmax = np.abs(lpc).max()
    if cmax <= 0:
        return None
    log2cmax = int(np.floor(np.log2(cmax)))
    shift = precision - 1 - log2cmax - 1
    shift = max(1, min(15, shift))
    q = np.rint(lpc * (1 << shift)).astype(np.int64)
    lim = (1 << (precision - 1)) - 1
    q = np.clip(q, -lim - 1, lim)
    return q.astype(np.int32), shift


def _lpc_residual(x: np.ndarray, coeffs: np.ndarray, shift: int,
                  order: int) -> np.ndarray:
    xl = x.astype(np.int64)
    n = len(x)
    pred = np.zeros(n - order, np.int64)
    for i, c in enumerate(coeffs[:order].astype(np.int64)):
        pred += c * xl[order - 1 - i:n - 1 - i]
    return (xl[order:] - (pred >> shift)).astype(np.int64)


def _encode_subframe(bw: _Fields, x: np.ndarray, bps: int,
                     use_lpc: bool, stats: dict) -> None:
    blocksize = len(x)
    # wasted bits
    wasted = 0
    if np.any(x):
        ors = int(np.bitwise_or.reduce(x))
        wasted = (ors & -ors).bit_length() - 1
        if wasted > 0:
            x = x >> wasted
            bps -= wasted
    else:
        wasted = 0

    def write_header(stype: int):
        bw.write(0, 1)
        bw.write(stype, 6)
        if wasted:
            bw.write(1, 1)
            bw.write_unary(wasted - 1)
        else:
            bw.write(0, 1)

    if np.all(x == x[0]):                       # CONSTANT
        write_header(0)
        bw.write_signed(int(x[0]), bps)
        return

    xl = x.astype(np.int64)
    # fixed predictors 0..4: pick min sum-of-abs-residual
    cands = []
    diff = xl
    for order in range(5):
        if order > 0:
            diff = np.diff(diff)
        if len(diff) == 0:
            break
        cands.append((int(np.abs(diff[order - order:]).sum()), order))
    best_fixed = min(cands)[1] if cands else 0
    fres = xl
    for _ in range(best_fixed):
        fres = np.diff(fres)
    fixed_bits = _rice_bits(fres) + best_fixed * bps

    choice = ("fixed", best_fixed, None, 0, fres)
    if use_lpc and blocksize >= 64:
        order = min(8, blocksize // 2 - 1)
        w = np.hanning(blocksize)
        xw = xl * w
        autoc = np.array([np.dot(xw[: blocksize - l], xw[l:])
                          for l in range(order + 1)])
        ql = _quantise_lpc(autoc, order)
        if ql is not None:
            coeffs, shift = ql
            lres = _lpc_residual(x, coeffs, shift, order)
            lpc_bits = (_rice_bits(lres) + order * bps + order * 14 + 9)
            if lpc_bits < fixed_bits:
                choice = ("lpc", order, coeffs, shift, lres)

    kind, order, coeffs, shift, res = choice
    if int(np.abs(res).max(initial=0)) >= (1 << 31):
        kind = "verbatim"
    if kind == "verbatim":
        write_header(1)
        for v in x:
            bw.write_signed(int(v), bps)
        return
    porder = _pick_porder(blocksize, order)
    if order:
        stats["pred_samples"] += blocksize
        stats["pred_taps"] += (blocksize - order) * order
    if kind == "fixed":
        write_header(8 + order)
        for v in x[:order]:
            bw.write_signed(int(v), bps)
        _write_residuals(bw, res, blocksize, order, porder)
    else:
        write_header(32 + (order - 1))
        for v in x[:order]:
            bw.write_signed(int(v), bps)
        bw.write(14 - 1, 4)          # precision-1
        bw.write_signed(shift, 5)
        for c in coeffs[:order]:
            bw.write_signed(int(c), 14)
        _write_residuals(bw, res, blocksize, order, porder)


def crc8(data: bytes, poly: int = 0x07) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ poly) & 0xFF if crc & 0x80 \
                else (crc << 1) & 0xFF
    return crc


def _crc16_table(poly: int = 0x8005) -> np.ndarray:
    table = []
    for i in range(256):
        crc = i << 8
        for _ in range(8):
            crc = ((crc << 1) ^ poly) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
        table.append(crc)
    return np.asarray(table, np.uint32)


_CRC16 = _crc16_table()


def _crc16_frames(buf: np.ndarray, starts: np.ndarray,
                  ends: np.ndarray) -> np.ndarray:
    """The CRC-16 (poly 0x8005, initial 0) of every ``buf[start:end]``,
    all frames at once: a CRC with initial value 0 does not change over
    leading zero bytes, so each frame is read right-aligned in a zero-padded
    row and the columns are walked once."""
    L = int((ends - starts).max())
    idx = ends[:, None] - L + np.arange(L)[None, :]
    rows = np.where(idx >= starts[:, None], buf[np.maximum(idx, 0)], 0) \
        .astype(np.uint32)
    crc = np.zeros(len(starts), np.uint32)
    for col in rows.T:
        crc = ((crc << 8) & 0xFFFF) ^ _CRC16[((crc >> 8) ^ col) & 0xFF]
    return crc


def encode_flac(samples: np.ndarray, sample_rate: int, bits: int,
                blocksize: int = 4096, stereo_modes: bool = True,
                use_lpc: bool = True, stats: bool = False):
    """(channels, n) int32 native range -> complete FLAC stream; with
    ``stats`` also {"pred_samples", "pred_taps"}: the samples of the
    subframes with a predictor (LPC, or fixed of order 1 or more), and the
    multiply-adds the prediction takes (each sample after the warm-up times
    the order)."""
    channels, n = samples.shape
    out = bytearray(b"fLaC")
    counts = {"pred_samples": 0, "pred_taps": 0}

    # MD5 over interleaved little-endian samples at bps (libFLAC semantics)
    md5 = hashlib.md5()
    inter = np.ascontiguousarray(samples.T).astype(np.int64)
    bwidth = (bits + 7) // 8
    flat = inter.reshape(-1)
    buf = np.zeros((len(flat), bwidth), np.uint8)
    for i in range(bwidth):
        buf[:, i] = (flat >> (8 * i)) & 0xFF
    md5.update(buf.tobytes())

    si = _Fields()
    si.write(blocksize, 16)
    si.write(blocksize, 16)
    si.write(0, 24)
    si.write(0, 24)
    si.write(sample_rate, 20)
    si.write(channels - 1, 3)
    si.write(bits - 1, 5)
    si.write(n, 36)
    body = si.getvalue() + md5.digest()
    out += bytes([0x80]) + len(body).to_bytes(3, "big") + body

    bw = _Fields()
    frame_bounds = []
    frame_no = 0
    for start in range(0, n, blocksize):
        blk = samples[:, start:start + blocksize].astype(np.int64)
        bs = blk.shape[1]
        assign = channels - 1
        chans = [blk[c] for c in range(channels)]
        if channels == 2 and stereo_modes:
            l, r = blk[0], blk[1]
            side = l - r
            mid = (l + r) >> 1
            costs = {
                channels - 1: abs(l).sum() + abs(r).sum(),
                ASSIGN_LEFT_SIDE: abs(l).sum() + abs(side).sum(),
                ASSIGN_RIGHT_SIDE: abs(side).sum() + abs(r).sum(),
                ASSIGN_MID_SIDE: abs(mid).sum() + abs(side).sum(),
            }
            assign = min(costs, key=costs.get)
            if assign == ASSIGN_LEFT_SIDE:
                chans = [l, side]
            elif assign == ASSIGN_RIGHT_SIDE:
                chans = [side, r]
            elif assign == ASSIGN_MID_SIDE:
                chans = [mid, side]

        hw = _Fields()
        hw.write(SYNC, 14)
        hw.write(0, 1)
        hw.write(0, 1)               # fixed blocksize stream
        bs_code = _BS_CODE.get(bs)
        hw.write(bs_code if bs_code else (6 if bs <= 256 else 7), 4)
        sr_code = _RATE_CODE.get(sample_rate, 0)
        hw.write(sr_code, 4)
        hw.write(assign, 4)
        hw.write(_SS_CODE.get(bits, 0), 3)
        hw.write(0, 1)
        hw.write_utf8_coded(frame_no)
        if bs_code is None:
            hw.write(bs - 1, 8 if bs <= 256 else 16)
        hdr = hw.getvalue()
        frame_start = bw.bits // 8
        for byte in hdr + bytes([crc8(hdr)]):
            bw.write(byte, 8)

        for ci, ch in enumerate(chans):
            bps = bits
            if (assign == ASSIGN_LEFT_SIDE and ci == 1) \
                    or (assign == ASSIGN_RIGHT_SIDE and ci == 0) \
                    or (assign == ASSIGN_MID_SIDE and ci == 1):
                bps += 1
            _encode_subframe(bw, ch.astype(np.int64), bps, use_lpc, counts)
        bw.align_byte()
        frame_bounds.append((frame_start, bw.bits // 8))
        bw.write(0, 16)                        # the CRC-16, filled below
        frame_no += 1
    frames = np.frombuffer(bw.getvalue(), np.uint8).copy()
    if frame_bounds:
        starts, ends = np.asarray(frame_bounds, np.int64).T
        crc = _crc16_frames(frames, starts, ends)
        frames[ends] = crc >> 8
        frames[ends + 1] = crc & 0xFF
    out += frames.tobytes()
    return (bytes(out), counts) if stats else bytes(out)


# ---------------------------------------------------------------------------
# the benchmark's content
# ---------------------------------------------------------------------------

def _encode_job(job: tuple) -> tuple:
    seed, seconds, rate, bits, blocksize = job
    pcm = make_track(seconds, rate, seed)
    data, stats = encode_flac(pcm, rate, bits, blocksize, stats=True)
    return data, pcm, stats


def make(cfg: dict, cell: dict, seed: int) -> dict:
    """The cell's ``streams`` distinct tracks of ``stream_seconds`` each,
    their track seeds drawn from ``seed``, encoded in a pool of spawned
    workers: {"streams": FLAC bytes, "pcm": each track's (2, n) int32
    samples, "stats": each track's encoder counts}."""
    import multiprocessing
    import os

    n = int(cell["streams"])
    seeds = np.random.default_rng(seed).integers(0, 2 ** 63, n)
    jobs = [(int(s), float(cell["stream_seconds"]), cfg["sample_rate"],
             cfg["bits_per_sample"], cfg["blocksize"]) for s in seeds]
    workers = max(1, min(n, os.cpu_count() or 1))
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers) as pool:
        done = pool.map(_encode_job, jobs)
        pool.close()
        pool.join()
    return {"streams": [d for d, _, _ in done], "pcm": [p for _, p, _ in done],
            "stats": [s for _, _, s in done], "suffix": ".flac"}
