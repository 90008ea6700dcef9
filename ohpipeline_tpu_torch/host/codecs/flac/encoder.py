"""A correct, compact FLAC encoder.

Primary role: generating real FLAC bitstreams for the conformance suite
(the reference's TestCodec streams pre-encoded tone files; we synthesise
ours on the fly), exercising every subframe type, stereo mode and Rice
partition shape the decoder must handle.  Secondarily it gives the
framework an encode capability the reference lacks.

Spec-complete for: constant/verbatim/fixed subframes, LPC subframes (via
quantised Levinson-Durbin), left/side / right/side / mid/side decorrelation,
Rice partitioning (order 0..6), wasted bits, STREAMINFO MD5.
"""

from __future__ import annotations

import hashlib
import struct

import numpy as np

from .bitreader import BitWriter, crc8, crc16
from .frames import (ASSIGN_LEFT_SIDE, ASSIGN_MID_SIDE, ASSIGN_RIGHT_SIDE,
                     BLOCKSIZE_TABLE, FIXED_COEFFS, RATE_TABLE,
                     SAMPLE_SIZE_TABLE, SYNC)

_BS_CODE = {v: k for k, v in BLOCKSIZE_TABLE.items()}
_RATE_CODE = {v: k for k, v in RATE_TABLE.items()}
_SS_CODE = {v: k for k, v in SAMPLE_SIZE_TABLE.items()}


def _rice_cost(res: np.ndarray, param: int) -> int:
    z = np.where(res >= 0, res.astype(np.int64) << 1,
                 ((-res.astype(np.int64)) << 1) - 1)
    return int(np.sum(z >> param)) + len(res) * (param + 1)


def _best_rice_param(res: np.ndarray) -> int:
    if len(res) == 0:
        return 0
    z = np.where(res >= 0, res.astype(np.int64) << 1,
                 ((-res.astype(np.int64)) << 1) - 1)
    mean = max(int(z.mean()), 1)
    guess = max(mean.bit_length() - 1, 0)
    best, best_cost = 0, None
    for p in range(max(0, guess - 2), min(14, guess + 3)):
        c = _rice_cost(res, p)
        if best_cost is None or c < best_cost:
            best, best_cost = p, c
    return best


def _write_residuals(bw: BitWriter, res: np.ndarray, blocksize: int,
                     order: int, porder: int) -> None:
    npart = 1 << porder
    bw.write(0, 2)            # rice method 0 (4-bit params)
    bw.write(porder, 4)
    idx = 0
    for p in range(npart):
        n = (blocksize >> porder) - (order if p == 0 else 0)
        part = res[idx:idx + n]
        param = _best_rice_param(part)
        # escape to raw if any residual won't fit sanely
        maxabs = int(np.abs(part.astype(np.int64)).max()) if n else 0
        if maxabs and (maxabs >> param) > 1 << 16:
            raw = max(int(part.min()).bit_length(),
                      int(part.max()).bit_length()) + 1
            bw.write(15, 4)
            bw.write(raw, 5)
            for v in part:
                bw.write_signed(int(v), raw)
        else:
            bw.write(param, 4)
            for v in part:
                bw.write_rice(int(v), param)
        idx += n


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


def _encode_subframe(bw: BitWriter, x: np.ndarray, bps: int,
                     use_lpc: bool = True) -> None:
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
    fixed_bits = _rice_cost(fres[max(0, 0):], _best_rice_param(fres)) \
        + best_fixed * bps

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
            lpc_bits = (_rice_cost(lres, _best_rice_param(lres))
                        + order * bps + order * 14 + 9)
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


def encode_flac(samples: np.ndarray, sample_rate: int, bits: int,
                blocksize: int = 4096, stereo_modes: bool = True,
                use_lpc: bool = True) -> bytes:
    """(channels, n) int32 native range -> complete FLAC stream."""
    channels, n = samples.shape
    out = bytearray(b"fLaC")

    # MD5 over interleaved little-endian samples at bps (libFLAC semantics)
    md5 = hashlib.md5()
    inter = np.ascontiguousarray(samples.T).astype(np.int64)
    bwidth = (bits + 7) // 8
    flat = inter.reshape(-1)
    buf = np.zeros((len(flat), bwidth), np.uint8)
    for i in range(bwidth):
        buf[:, i] = (flat >> (8 * i)) & 0xFF
    md5.update(buf.tobytes())

    si = BitWriter()
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

        bw = BitWriter()
        bw.write(SYNC, 14)
        bw.write(0, 1)
        bw.write(0, 1)               # fixed blocksize stream
        bs_code = _BS_CODE.get(bs)
        bw.write(bs_code if bs_code else (6 if bs <= 256 else 7), 4)
        sr_code = _RATE_CODE.get(sample_rate, 0)
        bw.write(sr_code, 4)
        bw.write(assign, 4)
        bw.write(_SS_CODE.get(bits, 0), 3)
        bw.write(0, 1)
        bw.write_utf8_coded(frame_no)
        if bs_code is None:
            bw.write(bs - 1, 8 if bs <= 256 else 16)
        hdr = bytes(bw._out)
        assert bw._nbits == 0
        bw.write(crc8(hdr), 8)

        for ci, ch in enumerate(chans):
            bps = bits
            if (assign == ASSIGN_LEFT_SIDE and ci == 1) \
                    or (assign == ASSIGN_RIGHT_SIDE and ci == 0) \
                    or (assign == ASSIGN_MID_SIDE and ci == 1):
                bps += 1
            _encode_subframe(bw, ch.astype(np.int64), bps, use_lpc=use_lpc)
        bw.align_byte()
        frame = bw.getvalue()
        out += frame + struct.pack(">H", crc16(frame))
        frame_no += 1
    return bytes(out)
