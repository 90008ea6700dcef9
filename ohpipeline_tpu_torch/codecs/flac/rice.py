"""FLAC rice decode on the device, from the rice wire.

Port of ``ohpipeline_tpu.codecs.flac.rice_jax``.  The host parser
(``native.flac_parse_group_rice``) walks the codewords once to find frame
boundaries and emits *units*: up to 64 consecutive residuals sharing one
rice parameter, each with a start bit cursor into a slab of the stream's own
bytes.  The device decodes every unit in parallel, 64 sequential steps each
(``csrc/rice.cu`` on the card, :func:`scan_units_torch` on the CPU).  Aligned
full units fill a dense (rows x stride/64) grid that reshapes straight into
the residual plane; partial units ride an overflow list applied with one
integer scatter-add (order-independent, hence exact), and constant subframes
are broadcast from (row, value, length) triples.
"""

from __future__ import annotations

import torch

from ... import _kernels
from ...ops.lpc import wrap32

UNIT = 64          # samples per decode unit (matches flac_unpack.cc)
_M32 = 0xFFFFFFFF


def scan_units_torch(words, cur, kk, mode, counts):
    """Plain PyTorch version of the unit decode: a 64-step loop vectorised
    over units, in int64 with explicit 32-bit masks where the reference
    works in uint32.

    words: (W,) int32 big-endian slab words (u32 bit patterns); cur, kk,
    mode, counts: (U,) int32 bit cursor, rice parameter or raw width,
    0 = rice / 1 = verbatim, valid samples.  Returns (U, 64) int32,
    zeros past counts.
    """
    nw = words.shape[0]
    w = words.to(torch.int64) & _M32
    cur = cur.to(torch.int64)
    kk = kk.to(torch.int64)
    counts = counts.to(torch.int64)
    is_raw = mode == 1
    vals = torch.zeros((cur.shape[0], UNIT), dtype=torch.int32,
                       device=words.device)
    for i in range(UNIT):
        wi = cur >> 5
        w0 = w[wi.clamp(0, nw - 1)]
        w1 = w[(wi + 1).clamp(0, nw - 1)]
        phase = cur & 31
        wnd = torch.where(phase > 0,
                          ((w0 << phase) | (w1 >> (32 - phase))) & _M32, w0)
        # unary quotient from the float32 exponent of the top 16 bits
        top16 = wnd >> 16
        e = (top16.clamp(min=1).to(torch.float32).view(torch.int32)
             .to(torch.int64) >> 23) - 127
        unary = torch.where(top16 > 0, 15 - e, 16)
        low = torch.where(kk > 0,
                          ((wnd << (unary + 1)) & _M32) >> (32 - kk), 0)
        zz = wrap32((unary << kk) | low)
        rice_val = (zz >> 1) ^ -(zz & 1)
        raw_val = torch.where(kk > 0,
                              wrap32(wnd) >> (32 - kk).clamp(0, 31), 0)
        val = torch.where(is_raw, raw_val, rice_val)
        adv = torch.where(is_raw, kk, unary + 1 + kk)
        live = i < counts
        vals[:, i] = torch.where(live, val, 0).to(torch.int32)
        cur = torch.where(live, cur + adv, cur)
    return vals


def scan_units(words, cur, kk, mode, counts):
    """Unit decode: the CUDA kernel (``csrc/rice.cu``) for tensors on the
    card, the plain version for tensors on the CPU."""
    if words.device.type == "cpu":
        return scan_units_torch(words, cur, kk, mode, counts)
    return _kernels.rice(words, cur, kk, mode, counts)


def unit_lanes(bits_u8, gcur, gk, ocur, okk, omode, ocnt):
    """The unit decode's inputs from the wire planes: (W,) int32 slab words
    and (U,) int32 cursor, parameter, mode and count per unit, grid units
    first (row-major), then overflow units."""
    b = bits_u8.reshape(-1, 4).to(torch.int64)
    words = wrap32((b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8)
                   | b[:, 3]).to(torch.int32)
    gk_f = gk.reshape(-1)
    cur = torch.cat([gcur.reshape(-1), ocur])
    kk = torch.cat([gk_f.clamp(min=0), okk.clamp(min=0)])
    counts = torch.cat([torch.where(gk_f < 0, 0, UNIT).to(torch.int32), ocnt])
    mode = torch.cat([torch.zeros_like(gk_f), omode])
    return words, cur, kk, mode, counts


def decode_units(bits_u8, gcur, gk, ocur, okk, omode, ocnt, orow, opos,
                 cfrow, cfval, cfn):
    """Residual plane (B, stride) int32 from the rice wire.

    bits_u8: (NB,) uint8 slab of stream bytes, NB % 4 == 0.  gcur/gk:
    (B, stride // 64) int32 aligned-unit grid (gk = -1 empty).  o*: (O,)
    int32 overflow units with global rows and positions.  cf*: (F,) int32
    constant-subframe fills (row = -1 padding).  Same arguments as
    ``rice_jax.decode_units``.
    """
    B, S = gcur.shape
    stride = S * UNIT
    vals = scan_units(*unit_lanes(bits_u8, gcur, gk, ocur, okk, omode, ocnt))
    res = vals[:B * S].reshape(-1)
    # overflow scatter-add: the grid slots under overflow runs are empty
    # (zeros), and masked lanes add 0 at index 0
    ofv = vals[B * S:]
    lane = torch.arange(UNIT, device=res.device)[None, :]
    valid = (orow >= 0)[:, None] & (lane < ocnt[:, None])
    idx = (orow.clamp(0, B - 1)[:, None] * stride
           + (opos[:, None] + lane).clamp(0, stride - 1))
    idx = torch.where(valid, idx, 0)
    add = torch.where(valid, ofv, 0)
    res = res.index_add(0, idx.reshape(-1), add.reshape(-1)).reshape(B, stride)
    # constant-subframe fills
    cvalid = cfrow >= 0
    crow = torch.where(cvalid, cfrow, 0)
    pos = torch.arange(stride, device=res.device)[None, :]
    fill = torch.where(cvalid[:, None] & (pos < cfn[:, None]),
                       cfval[:, None], 0)
    return res.index_add(0, crow, fill)
