"""AAC-LC synthesis: host spectral prep (numpy) and the device program on
tensors.

Port of ``ohpipeline_tpu.codecs.aac.synthesis``.  That module imports JAX at
its top, so its host half is carried over here as the same numpy code:
the windows and IMDCT operators, ``window_bank``, ``operator_bank``,
``sf_expand_matrix``, the per-config layouts and ``prepare_group`` (which
prepares the exception rows both packages ship as a float32 side plane), the
per-frame prep of the object path (``dequantize``, ``apply_spectral_tools``,
``apply_tns``), and the float64 references ``apply_tns_zz_reference`` /
``decode_chunk_zz_reference`` that gate the device program.

The device half is ``decode_chunk_zz`` (the zigzag-nibble wire: elementwise
front end, TNS, magnitude-split IMDCT matmuls, windows and a shifted-slice
overlap-add), ``filterbank_fast``, ``dequant_filterbank`` and ``filterbank``
(the object path's operator-bank products, with the overlap scan as a
shifted slice).  The one
sequential program among them, the TNS all-pole scan along frequency, runs
as the hand-written kernel ``csrc/tns.cu`` on CUDA tensors and as its plain
version :func:`tns_scan_torch` on CPU tensors.  Matrix products stay
``torch.matmul`` in full float32, as the reference runs
``Precision.HIGHEST``: :func:`decode_chunk_zz`, :func:`filterbank_fast` and
:func:`filterbank` first call ``_kernels.require_full_fp32``, which raises
``KernelError`` when TF32 is on for float32 matmuls on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ... import _kernels
from ..._host import aac_bitstream as BS
from ..._host import aac_native
from ..._host import aac_tables as T

EIGHT_SHORT = BS.EIGHT_SHORT
#: Filter slots per pooled TNS row (8 windows x 3 filters) and taps per slot.
TNS_SLOTS, TNS_ORDER = 24, 12

# ---------------------------------------------------------------------------
# windows & IMDCT operators (host-precomputed constants)
# ---------------------------------------------------------------------------


def _sine_window(n: int) -> np.ndarray:
    return np.sin(np.pi / n * (np.arange(n) + 0.5))


def _kbd_window(n: int, alpha: float) -> np.ndarray:
    # Kaiser-Bessel derived (ISO 14496-3 4.6.11.3.2)
    half = n // 2
    t = np.arange(half + 1)
    kaiser = np.i0(np.pi * alpha * np.sqrt(1.0 - (2.0 * t / half - 1.0) ** 2))
    cum = np.cumsum(kaiser)
    w = np.sqrt(cum[:half] / cum[half])
    return np.concatenate([w, w[::-1]])


@functools.lru_cache(maxsize=None)
def _windows():
    return dict(
        long_sine=_sine_window(2048), long_kbd=_kbd_window(2048, 4.0),
        short_sine=_sine_window(256), short_kbd=_kbd_window(256, 6.0))


@functools.lru_cache(maxsize=None)
def _imdct_matrix(n_out: int) -> np.ndarray:
    """(n_out/2, n_out) operator: x = M.T @ X."""
    N = n_out
    k = np.arange(N // 2)
    n = np.arange(N)
    M = (2.0 / N) * np.cos(2.0 * np.pi / N * (n[None, :] + 0.5 + N / 4)
                           * (k[:, None] + 0.5))
    return M.astype(np.float32)       # (N/2, N)


def _long_halves(shape: int) -> tuple[np.ndarray, np.ndarray]:
    w = _windows()["long_kbd" if shape else "long_sine"]
    return w[:1024], w[1024:]


def _short_halves(shape: int) -> tuple[np.ndarray, np.ndarray]:
    w = _windows()["short_kbd" if shape else "short_sine"]
    return w[:128], w[128:]


@functools.lru_cache(maxsize=None)
def window_bank():
    """(16, 2048) full-frame windows per opidx (mode*4 + ls*2 + rs) for the
    non-short modes, plus (4, 8, 256) per-window short windows per (ls, rs)
    keyed by opidx & 3."""
    W = np.zeros((16, 2048), np.float32)
    SW = np.zeros((4, 8, 256), np.float32)
    for mode in (BS.ONLY_LONG, BS.LONG_START, BS.LONG_STOP):
        for ls in (0, 1):
            for rs in (0, 1):
                wl_l, _ = _long_halves(ls)
                if mode == BS.ONLY_LONG:
                    win = np.concatenate([wl_l, _long_halves(rs)[1]])
                elif mode == BS.LONG_START:
                    _, swr = _short_halves(rs)
                    win = np.concatenate([wl_l, np.ones(448), swr,
                                          np.zeros(448)])
                else:
                    swl, _ = _short_halves(ls)
                    win = np.concatenate([np.zeros(448), swl, np.ones(448),
                                          _long_halves(rs)[1]])
                W[mode * 4 + ls * 2 + rs] = win
    for ls in (0, 1):
        for rs in (0, 1):
            wl, wr = _short_halves(rs)
            wl_first, _ = _short_halves(ls)
            for w in range(8):
                SW[ls * 2 + rs, w] = np.concatenate(
                    [wl_first if w == 0 else wl, wr])
    return W, SW


@functools.lru_cache(maxsize=None)
def _frame_operators():
    """Per (window_mode, left_shape, right_shape): two (1024, 1024) f32
    linear operators A, Bop with

        time_first_half  = spec @ A      (added to the carried overlap)
        next_overlap     = spec @ Bop

    folding the IMDCT, the windows and the short windows' internal overlap
    into two dense products, uniform across all window sequences."""
    M_long = _imdct_matrix(2048)      # (1024, 2048)
    M_short = _imdct_matrix(256)      # (128, 256)
    ops = {}
    for mode in (BS.ONLY_LONG, BS.LONG_START, EIGHT_SHORT, BS.LONG_STOP):
        for ls in (0, 1):
            for rs in (0, 1):
                full = np.zeros((1024, 2048), np.float32)
                if mode == EIGHT_SHORT:
                    wl, wr = _short_halves(rs)
                    wl_first, _ = _short_halves(ls)
                    for w in range(8):
                        off = 448 + w * 128
                        win = np.concatenate(
                            [wl_first if w == 0 else wl, wr])
                        contrib = (M_short * win[None, :]).astype(np.float32)
                        full[w * 128:(w + 1) * 128, off:off + 256] += contrib
                else:
                    wl_l, _ = _long_halves(ls)
                    if mode == BS.ONLY_LONG:
                        win = np.concatenate([wl_l, _long_halves(rs)[1]])
                    elif mode == BS.LONG_START:
                        _, swr = _short_halves(rs)
                        right = np.concatenate(
                            [np.ones(448), swr, np.zeros(448)])
                        win = np.concatenate([wl_l, right])
                    else:  # LONG_STOP
                        swl, _ = _short_halves(ls)
                        left = np.concatenate(
                            [np.zeros(448), swl, np.ones(448)])
                        win = np.concatenate([left, _long_halves(rs)[1]])
                    full = (M_long * win[None, :]).astype(np.float32)
                ops[(mode, ls, rs)] = (
                    np.ascontiguousarray(full[:, :1024]),
                    np.ascontiguousarray(full[:, 1024:]))
    return ops


def operator_bank() -> tuple[np.ndarray, np.ndarray]:
    """Stacked (16, 1024, 1024) A and B operator banks indexed by
    mode*4 + left_shape*2 + right_shape."""
    ops = _frame_operators()
    A = np.stack([ops[(m, lft, r)][0] for m in range(4) for lft in (0, 1)
                  for r in (0, 1)])
    B = np.stack([ops[(m, lft, r)][1] for m in range(4) for lft in (0, 1)
                  for r in (0, 1)])
    return A, B


_OPERATOR_BANKS: dict = {}


def operator_bank_constants(*, device) -> tuple:
    """:func:`operator_bank` as float32 tensors on ``device`` (64 MB each),
    uploaded once per device: the last two arguments of
    :func:`filterbank`."""
    key = str(torch.device(device))
    if key not in _OPERATOR_BANKS:
        _OPERATOR_BANKS[key] = tuple(torch.from_numpy(a).to(device)
                                     for a in operator_bank())
    return _OPERATOR_BANKS[key]


def sf_expand_matrix(rate_index: int) -> np.ndarray:
    """(64, 1024) one-hot expansion: long-window band k -> its coefficient
    span (per the rate's long sfb offsets).  Coefficients beyond the last
    band map to no row (expanded byte 0)."""
    offsets = T.sfb_offsets(rate_index, False)
    E = np.zeros((64, 1024), np.float32)
    for k in range(min(64, len(offsets) - 1)):
        E[k, int(offsets[k]):int(offsets[k + 1])] = 1.0
    return E


def filterbank_constants(*, device) -> tuple:
    """(M_long, M_short, W, SW) as float32 tensors on ``device``: the
    constant arguments of :func:`filterbank_fast` after ``overlap``."""
    W, SW = window_bank()
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (_imdct_matrix(2048), _imdct_matrix(256), W, SW))


def device_constants(rate_index: int, *, device) -> tuple:
    """(M_long, M_short, W, SW, E_sf) as float32 tensors on ``device``: the
    constant arguments of :func:`decode_chunk_zz` after ``overlap``."""
    return (*filterbank_constants(device=device),
            torch.from_numpy(sf_expand_matrix(rate_index)).to(device))


# ---------------------------------------------------------------------------
# device program
# ---------------------------------------------------------------------------

def _fast_cbrt(x):
    """Cube root of non-negative float32 as the JAX package computes it:
    exponent bit-trick seed + 3 Newton steps, bit for bit the same
    operations (x == 0 yields a finite value that q * cbrt(|q|) masks)."""
    i = torch.clamp_min(x, 1e-30).view(torch.int32)
    y = (torch.div(i, 3, rounding_mode="floor") + 0x2A514067) \
        .view(torch.float32)
    for _ in range(3):
        y = (2.0 * y + x / (y * y)) * (1.0 / 3.0)
    return y


_EXP2_QUARTER_FRAC = (1.0, 1.189207115002721, 1.4142135623730951,
                      1.681792830507429)


def _exp2_quarter(k):
    """2**(k/4) for int32 k in [-126*4, 127*4): the exponent field for the
    integer part times the float32 fraction for k & 3, as the JAX package
    builds it."""
    base = (((k >> 2) + 127) << 23).view(torch.float32)
    frac = torch.tensor(_EXP2_QUARTER_FRAC, dtype=torch.float32,
                        device=k.device)
    return base * frac[(k & 3).long()]


def _scatter_rows(dst, rows, src):
    """dst with row rows[j] replaced by src[j] for rows[j] >= 0 (-1 marks
    padding).  Padding lands on an extra row that is dropped, so no mask
    is read back to the host."""
    ext = torch.cat([dst, dst.new_zeros((1,) + tuple(dst.shape[1:]))])
    ext[torch.where(rows >= 0, rows.long(), dst.shape[0])] = src.to(dst.dtype)
    return ext[:-1]


def tns_scan_torch(spec, tfi, tco, tdir, trow):
    """Plain version of the TNS kernel: filters the rows ``trow`` of ``spec``
    (TB, 1024) float32 in place and returns ``spec``.

    Pooled row j (tfi (P, 1024) uint8 filter slot + 1 per bin, 0 = none;
    tco (P, 24, 12) float32 direct-form coefficients; tdir (P, 24) uint8
    direction per slot) filters spec row trow[j]; rows outside [0, TB) are
    padding and skipped.  A bin is active in pass d when its slot runs in
    direction d; the 12-tap history resets where an active bin's slot
    differs from the previous bin's (-1 before the first), takes every
    bin's output, and y = x - dot(coefficients, history) on active bins.
    Pass 0 runs up the bins, pass 1 down.  A loop over bins, vectorised
    over rows.
    """
    TB = spec.shape[0]
    keep = (trow >= 0) & (trow < TB)
    rows = trow[keep].long()
    P = rows.shape[0]
    if P == 0:
        return spec
    x = spec[rows]
    fid = tfi[keep].long()
    valid = (fid > 0) & (fid <= TNS_SLOTS)
    slot = (fid - 1).clamp(0, TNS_SLOTS - 1)
    dirs = torch.gather(tdir[keep].long(), 1, slot)
    coef = tco[keep][torch.arange(P, device=x.device)[:, None], slot]
    for direction, bins in ((0, range(1024)), (1, range(1023, -1, -1))):
        active = valid & (dirs == direction)
        hist = x.new_zeros((P, TNS_ORDER))
        prev = torch.full((P,), -1, dtype=fid.dtype, device=x.device)
        for i in bins:
            f, a = fid[:, i], active[:, i]
            hist = torch.where((a & (f != prev))[:, None], 0.0, hist)
            y = x[:, i] - torch.where(a, (coef[:, i] * hist).sum(1), 0.0)
            hist = torch.cat([y[:, None], hist[:, :-1]], dim=1)
            x[:, i] = y
            prev = f
    spec[rows] = x
    return spec


def tns_scan(spec, tfi, tco, tdir, trow):
    """TNS filtering of ``spec``'s pooled rows, in place (see
    :func:`tns_scan_torch`): the ``csrc/tns.cu`` kernel for CUDA tensors,
    the plain version for CPU tensors."""
    if spec.device.type == "cuda":
        _kernels.tns(spec, tfi, tco, tdir, trow)
        return spec
    if spec.device.type == "cpu":
        return tns_scan_torch(spec, tfi, tco, tdir, trow)
    raise ValueError(f"tns_scan: no kernel for device {spec.device}")


def apply_tns_zz(spec, tfi, tco, tdir, trow):
    """TNS synthesis filtering for the zigzag wire (planes from
    ``native.aac_prepare_rows_zz``'s TnsPool): returns a copy of spec
    (TB, 1024) with the pooled rows filtered by an upward then a downward
    all-pole scan (regions are disjoint, so the passes commute)."""
    return tns_scan(spec.clone(), tfi, tco, tdir, trow)


def _imdct_windowed(spec, op, M_long, M_short, W, SW, split: bool):
    """(TB, 1024) spectra -> (TB, 2048) windowed IMDCT frames; op (TB,)
    int window-operator indices.  With ``split`` the few huge bins
    (|x| > 16384) are summed in their own matmul pass, so each pass
    rounds at the scale of its own terms (the JAX package's magnitude
    split: one float32 accumulation over tonal ~1e7 bins costs ~30 LSB)."""
    TB = spec.shape[0]
    if split:
        s_big = torch.where(spec.abs() > 16384.0, spec, 0.0)
        parts = (spec - s_big, s_big)
    else:
        parts = (spec,)
    x_long = torch.matmul(parts[0], M_long)
    xs = torch.matmul(parts[0].reshape(TB, 8, 128), M_short)
    for s in parts[1:]:
        x_long = x_long + torch.matmul(s, M_long)
        xs = xs + torch.matmul(s.reshape(TB, 8, 128), M_short)
    x_long = x_long * W[op]
    xs = xs * SW[op & 3]                                  # (TB, 8, 256)
    x_short = spec.new_zeros((TB, 2048))
    for w in range(8):
        x_short[:, 448 + w * 128:448 + w * 128 + 256] += xs[:, w]
    is_short = (op >> 2) == EIGHT_SHORT
    return torch.where(is_short[:, None], x_short, x_long)


def _overlap_add(x, overlap):
    """x (T, B, 2048) frames in time order -> (pcm (T, B, 1024), new
    overlap): frame t's first half plus frame t-1's second half, as one
    shifted slice."""
    prev = torch.cat([overlap[None], x[:-1, :, 1024:]], dim=0)
    return x[:, :, :1024] + prev, x[-1, :, 1024:]


def decode_chunk_zz(q4, sfb, ssf, ssr, msb, opx, esc_row, esc_pos, esc_val,
                    side_q, side_row, overlap,
                    M_long, M_short, W, SW, E_sf,
                    tfi=None, tco=None, tdir=None, trow=None):
    """Whole-chunk AAC-LC decode for the zigzag-nibble wire
    (``native.aac_prepare_rows_zz``), with the JAX function's arguments and
    results.

    q4 (T, B, 512) uint8 zigzag nibbles; sfb (T, B, 64) uint8 per-band
    scalefactor bytes of long rows, expanded per coefficient by the one-hot
    E_sf (64, 1024) (an exact product); ssf (S2, 1024) uint8 + ssr (S2,)
    pooled per-coefficient bytes of short-window rows; msb (T, B//2, 128)
    uint8 M/S bitmask (LSB-first); opx (T, B) window-operator index;
    escapes (|q| > 7, raw values) flat over T*B rows as (esc_row, esc_pos,
    esc_val), or with ``esc_pos=None`` packed as row*1024+pos in esc_row;
    side_q (S, 1024) host-prepared exception spectra and side_row (S,) the
    flat row each replaces (-1 pad); overlap (B, 1024) float32 carried
    across chunks; optional TnsPool planes (tfi, tco, tdir, trow).  The
    elementwise front end reproduces the JAX package's float32 operations
    bit for bit.  Returns (pcm (T, B, 1024) float32, new_overlap).
    """
    _kernels.require_full_fp32(sfb.device)
    Tn, B, _ = sfb.shape
    TB = Tn * B
    dev = sfb.device
    b = q4.reshape(TB, 512).to(torch.int32)
    zz = torch.stack([b & 15, b >> 4], dim=-1).reshape(TB, 1024)
    q = ((zz >> 1) ^ -(zz & 1)).to(torch.float32)
    flat = torch.cat([q.reshape(-1), q.new_zeros(1)])
    esc_row = esc_row.to(torch.int64)
    if esc_pos is None:
        eidx = torch.where(esc_row >= 0, esc_row, TB * 1024)
    else:
        eidx = torch.where(esc_row >= 0, esc_row * 1024 + esc_pos.long(),
                           TB * 1024)
    flat[eidx] = esc_val.to(torch.float32)
    q = flat[:TB * 1024].reshape(TB, 1024)
    dq = q * _fast_cbrt(q.abs())                       # sign(q)|q|^{4/3}
    k = torch.matmul(sfb.reshape(TB, 64).to(torch.float32), E_sf) \
        .to(torch.int32)
    k = _scatter_rows(k, ssr, ssf)
    spec = dq * _exp2_quarter(k - 100)
    # M/S per pair (per-coefficient bitmask, LSB-first)
    shifts = torch.arange(8, dtype=torch.int32, device=dev)
    ms = ((msb.reshape(Tn, B // 2, 128, 1).to(torch.int32) >> shifts) & 1) \
        .reshape(Tn, B // 2, 1024) > 0
    sp = spec.reshape(Tn, B // 2, 2, 1024)
    mid, side = sp[:, :, 0], sp[:, :, 1]
    spec = torch.stack([torch.where(ms, mid + side, mid),
                        torch.where(ms, mid - side, side)],
                       dim=2).reshape(TB, 1024)
    spec = _scatter_rows(spec, side_row, side_q)
    # TNS after stereo and side substitution, before the filterbank (fdk
    # channel.cpp order); spec is this call's own tensor, filtered in place
    if tfi is not None:
        tns_scan(spec, tfi, tco, tdir, trow)
    op = opx.reshape(TB).long()
    x = _imdct_windowed(spec, op, M_long, M_short, W, SW, split=True)
    return _overlap_add(x.reshape(Tn, B, 2048), overlap)


#: Plane names of the serving wire, in ``decode_chunk_zz``'s argument order
#: before ``esc_pos`` (passed as None: ``epak`` packs row*1024+pos) and after
#: it, up to the overlap; the TnsPool planes follow the constants.
ZZ_PLANES = ("q4", "sfb", "ssf", "ssr", "msb", "opx", "epak")
ZZ_PLANES_AFTER_ESC = ("eva2", "side", "srow")
TNS_PLANES = ("tfi", "tco", "tdir", "trow")


def decode_planes(t: dict, overlap, consts):
    """One device pass over a serving group's planes, as tensors keyed by
    the names above: returns ``decode_chunk_zz``'s (pcm (G, S*C, 1024)
    float32, overlap)."""
    return decode_chunk_zz(
        *(t[k] for k in ZZ_PLANES), None,
        *(t[k] for k in ZZ_PLANES_AFTER_ESC), overlap, *consts,
        *(t[k] for k in TNS_PLANES))


def filterbank_fast(spec_t, opidx_t, overlap, M_long, M_short, W, SW):
    """spec_t (T, B, 1024) float32 spectra, opidx_t (T, B) operator
    indices, overlap (B, 1024): IMDCT matmuls, windows and the overlap-add
    (the JAX package's lax.scan carry, here a shifted slice).  Returns
    (pcm (T, B, 1024), new_overlap)."""
    _kernels.require_full_fp32(spec_t.device)
    Tn, B, _ = spec_t.shape
    x = _imdct_windowed(spec_t.reshape(Tn * B, 1024),
                        opidx_t.reshape(-1).long(), M_long, M_short, W, SW,
                        split=False)
    return _overlap_add(x.reshape(Tn, B, 2048), overlap)


def filterbank(spec_t, opidx_t, overlap, A_bank, B_bank):
    """Filterbank of the per-frame object path through the operator banks
    (:func:`operator_bank_constants`): spec_t (T, B, 1024) float32 spectra,
    opidx_t (T, B) operator indices in [0, 16), overlap (B, 1024).  Each
    row's first half is ``spec @ A[op]`` plus the carried overlap and its
    second half ``spec @ B[op]`` is carried on: one product per operator
    the group uses, then the overlap-add as a shifted slice (the JAX
    package's lax.scan carry).  Returns (pcm (T, B, 1024), new_overlap)."""
    _kernels.require_full_fp32(spec_t.device)
    Tn, B, _ = spec_t.shape
    flat = spec_t.reshape(Tn * B, 1024)
    ops = opidx_t.reshape(-1)
    first = torch.empty_like(flat)
    second = torch.empty_like(flat)
    for op in torch.unique(ops).tolist():
        rows = (ops == op).nonzero()[:, 0]
        first[rows] = torch.matmul(flat[rows], A_bank[op])
        second[rows] = torch.matmul(flat[rows], B_bank[op])
    first = first.reshape(Tn, B, 1024)
    second = second.reshape(Tn, B, 1024)
    prev = torch.cat([overlap[None], second[:-1]], dim=0)
    return first + prev, second[-1]


def dequant_filterbank(quant, sf, coded, cfg_idx, perm_tab, band_tab,
                       ms_flag, side_spec, side_row, opidx_t, overlap,
                       M_long, M_short, W, SW):
    """Device dequantization, scalefactor gains, M/S and the filterbank of
    one group from int quantized coefficients in transmission order.

    quant (T, B, 1024) int; sf (T, B, 128) scalefactors per band slot;
    coded (T, B, 128) 1 where the slot carries spectral data; cfg_idx
    (T, B) layout config per row; perm_tab / band_tab (NCFG, 1024) dst ->
    transmission position / band slot (127 = silent); ms_flag (T, B//2,
    128) M/S per band of each pair; side_spec (S, 1024) + side_row (S,)
    host-prepared rows (-1 pad).  Returns (pcm (T, B, 1024), new_overlap).
    """
    Tn, B, _ = quant.shape
    TB = Tn * B
    q = quant.to(torch.float32).reshape(TB, 1024)
    dq = torch.sign(q) * q.abs() ** (4.0 / 3.0)
    cfg = cfg_idx.reshape(-1).long()
    perm = perm_tab[cfg].long()
    band = band_tab[cfg].long()
    spec_tx = torch.gather(dq, 1, perm)
    gains = torch.exp2(0.25 * (sf.reshape(TB, 128).to(torch.float32)
                               - 100.0))
    gains = gains * coded.reshape(TB, 128).to(torch.float32)
    # slot 127 backs band_tab's "silent" marker for unused dst positions
    gains[:, 127] = 0.0
    spec = spec_tx * torch.gather(gains, 1, band)
    sp = spec.reshape(Tn, B // 2, 2, 1024)
    band_l = band.reshape(Tn, B // 2, 2, 1024)[:, :, 0]
    ms = torch.gather(ms_flag.to(torch.float32), 2, band_l) > 0
    mid, side = sp[:, :, 0], sp[:, :, 1]
    spec = torch.stack([torch.where(ms, mid + side, mid),
                        torch.where(ms, mid - side, side)],
                       dim=2).reshape(TB, 1024)
    spec = _scatter_rows(spec, side_row, side_spec)
    return filterbank_fast(spec.reshape(Tn, B, 1024), opidx_t, overlap,
                           M_long, M_short, W, SW)


# ---------------------------------------------------------------------------
# float64 references (numpy): the precision gate of the device program
# ---------------------------------------------------------------------------

def apply_tns_zz_reference(spec, tfi, tco, tdir, trow):
    """float64 numpy twin of apply_tns_zz (precision gate); filters spec in
    place and returns it."""
    for j in range(tfi.shape[0]):
        r = int(trow[j])
        if r < 0:
            continue
        x = spec[r]
        fid = tfi[j].astype(np.int32)
        for direction in (0, 1):
            idx_order = range(1024) if direction == 0 \
                else range(1023, -1, -1)
            hist = np.zeros(12)
            prev = -1                      # previous bin's fid, raw
            for i in idx_order:
                f = int(fid[i])
                act = f > 0 and int(tdir[j, f - 1]) == direction
                if act and f != prev:
                    hist[:] = 0.0
                y = x[i] - (tco[j, f - 1].astype(np.float64) @ hist
                            if act else 0.0)
                hist[1:] = hist[:-1]
                hist[0] = y
                x[i] = y
                prev = f
    return spec


def decode_chunk_zz_reference(q4, sfb, ssf, ssr, msb, opx,
                              esc_row, esc_pos, esc_val,
                              side_q, side_row, overlap, E_sf,
                              tfi=None, tco=None, tdir=None, trow=None):
    """float64 numpy reference of decode_chunk_zz — the precision gate the
    device program is held to (the device's float32 IMDCT accumulation is
    the only deviation)."""
    Tn, B, _ = sfb.shape
    TB = Tn * B
    bb = q4.reshape(TB, 512).astype(np.int32)
    zz = np.stack([bb & 15, bb >> 4], axis=-1).reshape(TB, 1024)
    q = ((zz >> 1) ^ -(zz & 1)).astype(np.float64)
    flat = q.reshape(-1)
    m = esc_row >= 0
    if esc_pos is None:
        flat[esc_row[m]] = esc_val[m]
    else:
        flat[esc_row[m] * 1024 + esc_pos[m]] = esc_val[m]
    q = flat.reshape(TB, 1024)
    k = (sfb.reshape(TB, 64).astype(np.float64)
         @ E_sf.astype(np.float64)).astype(np.int64)
    sel2 = ssr >= 0
    k[ssr[sel2]] = ssf[sel2]
    spec = (np.sign(q) * np.abs(q) ** (4.0 / 3.0)
            * np.exp2(0.25 * (k.astype(np.float64) - 100.0)))
    bits = ((msb.reshape(Tn, B // 2, 128, 1).astype(np.int32)
             >> np.arange(8)) & 1).reshape(Tn, B // 2, 1024)
    sp = spec.reshape(Tn, B // 2, 2, 1024)
    mid, side = sp[:, :, 0], sp[:, :, 1]
    left = np.where(bits > 0, mid + side, mid)
    right = np.where(bits > 0, mid - side, side)
    spec = np.stack([left, right], axis=2).reshape(TB, 1024)
    sel = side_row >= 0
    spec[side_row[sel]] = side_q[sel]
    if tfi is not None:
        spec = apply_tns_zz_reference(spec, tfi, tco, tdir, trow)
    W, SW = window_bank()
    ML = _imdct_matrix(2048).astype(np.float64)
    MS = _imdct_matrix(256).astype(np.float64)
    op = opx.reshape(TB).astype(int)
    x_long = spec @ ML * W[op]
    xs = np.einsum("twk,kn->twn", spec.reshape(TB, 8, 128), MS) * SW[op & 3]
    x_short = np.zeros((TB, 2048))
    for w in range(8):
        x_short[:, 448 + w * 128:448 + w * 128 + 256] += xs[:, w]
    x = np.where(((op >> 2) == EIGHT_SHORT)[:, None], x_short, x_long) \
        .reshape(Tn, B, 2048)
    prev = np.concatenate([overlap[None].astype(np.float64),
                           x[:-1, :, 1024:]], axis=0)
    return x[:, :, :1024] + prev, x[-1, :, 1024:]


# ---------------------------------------------------------------------------
# vectorized group prep (host, fed by the native unpacker)
# ---------------------------------------------------------------------------

_POW43 = np.arange(8192, dtype=np.float64) ** (4.0 / 3.0)

_CONFIG_CACHE: dict = {}


def _layout(rate_index: int, seq: int, grouping: int, max_sfb: int):
    """Cached per-ICS-config index maps.

    Returns (perm_src, perm_dst, band_of_dst): transmission positions ->
    spectral positions plus the (g*15+k) band slot feeding each dest
    coefficient.
    """
    key = (rate_index, seq, grouping, max_sfb)
    hit = _CONFIG_CACHE.get(key)
    if hit is not None:
        return hit
    short = seq == EIGHT_SHORT
    ics = BS.IcsInfo(seq, 0, max_sfb, grouping)
    offsets = T.sfb_offsets(rate_index, short)
    src, dst, band = [], [], []
    if not short:
        for k in range(max_sfb):
            a, b = int(offsets[k]), int(offsets[k + 1])
            src.extend(range(a, b))
            dst.extend(range(a, b))
            band.extend([k] * (b - a))
    else:
        pos = 0
        win_base = 0
        for g, wins in enumerate(ics.window_groups()):
            for k in range(max_sfb):
                width = int(offsets[k + 1] - offsets[k])
                for w in range(wins):
                    a = (win_base + w) * 128 + int(offsets[k])
                    src.extend(range(pos, pos + width))
                    dst.extend(range(a, a + width))
                    band.extend([g * 15 + k] * width)
                    pos += width
            win_base += wins
            pos = win_base * 128
    out = (np.asarray(src, np.int32), np.asarray(dst, np.int32),
           np.asarray(band, np.int32))
    _CONFIG_CACHE[key] = out
    return out


def prepare_group(batch: dict, nframes: int, channels: int,
                  prev_shape: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Dense-array spectral prep: dequant + scalefactors + PNS + M/S +
    intensity + TNS, vectorized across the whole group.

    Returns (specs (F, C, 1024) f32, opidx (F, C) i32); prev_shape (C,)
    is updated in place.
    """
    ri = batch["rate_index"]
    F, C = nframes, channels
    R = F * C
    ics = batch["ics"][:R]
    cb = batch["cb"][:R]
    sf = batch["sf"][:R]
    q = batch["quant"][:R].astype(np.int64)
    dq = np.sign(q) * np.where(
        np.abs(q) < 8192, _POW43[np.minimum(np.abs(q), 8191)],
        np.abs(q).astype(np.float64) ** (4.0 / 3.0))
    gains = np.exp2(0.25 * (sf.astype(np.float64) - T.SF_OFFSET))
    coded = (cb >= 1) & (cb <= 11)
    specs = np.zeros((R, 1024))
    # group rows by layout config for batched fancy-indexing
    keys = [(ri, int(ics[r][0]) if int(ics[r][0]) == EIGHT_SHORT else 0,
             int(ics[r][3]) if int(ics[r][0]) == EIGHT_SHORT else 0,
             int(ics[r][2])) for r in range(R)]
    by_cfg: dict = {}
    for r, k in enumerate(keys):
        by_cfg.setdefault(k, []).append(r)
    for (ri_, seq, grouping, max_sfb), rows in by_cfg.items():
        if max_sfb == 0:
            continue
        src, dst, band = _layout(ri_, seq, grouping, max_sfb)
        rows = np.asarray(rows)
        vals = dq[rows][:, src] * gains[rows][:, band]
        vals *= coded[rows][:, band]
        specs[rows[:, None], dst[None, :]] = vals
    # PNS
    noise_rows = np.where((cb == T.NOISE_CB).any(axis=1))[0]
    for r in noise_rows:
        seq = int(ics[r][0])
        src, dst, band = _layout(
            ri, seq if seq == EIGHT_SHORT else 0,
            int(ics[r][3]) if seq == EIGHT_SHORT else 0, int(ics[r][2]))
        sel = cb[r][band] == T.NOISE_CB
        if not sel.any():
            continue
        d = dst[sel]
        n = _pns_noise(int(r), int(d[0]), len(d))
        # normalise per band to energy 2^(sf/4)
        bids = band[sel]
        for b in np.unique(bids):
            m = bids == b
            seg = n[m]
            e = 2.0 ** (0.25 * sf[r][b])
            n[m] = seg * (e / np.sqrt(np.mean(seg * seg) + 1e-30))
        specs[r][d] = n
    # M/S + intensity (pairs)
    if C == 2:
        ms = batch["msmask"][:F]
        for f in range(F):
            rl, rr = f * 2, f * 2 + 1
            flag = ms[f][0]
            has_is = np.isin(cb[rr], (T.INTENSITY_CB, T.INTENSITY_CB2)).any()
            if (flag in (0, 0xFF)) and not has_is:
                continue
            seq = int(ics[rl][0])
            src, dst, band = _layout(
                ri, seq if seq == EIGHT_SHORT else 0,
                int(ics[rl][3]) if seq == EIGHT_SHORT else 0,
                int(ics[rl][2]))
            mask_band = np.zeros(120, bool)
            if flag == 2:
                mask_band[:] = True
            elif flag == 1:
                mask_band[:120] = ms[f][1:121] != 0
            cbr = cb[rr]
            is_band = np.isin(cbr, (T.INTENSITY_CB, T.INTENSITY_CB2))
            ms_sel = mask_band[band] & ~is_band[band] \
                & (cbr[band] != T.NOISE_CB)
            if flag in (1, 2) and ms_sel.any():
                d = dst[ms_sel]
                mid = specs[rl][d].copy()
                side = specs[rr][d].copy()
                specs[rl][d] = mid + side
                specs[rr][d] = mid - side
            if is_band.any():
                isel = is_band[band]
                d = dst[isel]
                bsel = band[isel]
                sign = np.where(cbr[bsel] == T.INTENSITY_CB, 1.0, -1.0)
                sign *= np.where(mask_band[bsel], -1.0, 1.0)
                scale = sign * 0.5 ** (0.25 * sf[rr][bsel])
                specs[rr][d] = specs[rl][d] * scale
    # TNS (native batch filter; python per-row fallback)
    if batch["tnsn"][:R].any():
        native = aac_native()
        if native.have_aac_unpack():
            native.aac_tns_group(specs, batch, R)
        else:
            for r in np.where(batch["tnsn"][:R].any(axis=1))[0]:
                _apply_tns_arrays(specs[r], batch, r, ri, ics[r])
    # opidx + prev_shape tracking
    opidx = np.zeros((F, C), np.int32)
    for f in range(F):
        for c in range(C):
            r = f * C + c
            opidx[f, c] = (int(ics[r][0]) * 4 + int(prev_shape[c]) * 2
                           + int(ics[r][1]))
            prev_shape[c] = int(ics[r][1])
    return (specs.reshape(F, C, 1024).astype(np.float32), opidx)


def _apply_tns_arrays(spec: np.ndarray, batch: dict, r: int, rate_index: int,
                      ics_row) -> None:
    short = int(ics_row[0]) == EIGHT_SHORT
    offsets = T.sfb_offsets(rate_index, short)
    nbands = len(offsets) - 1
    nwin = 8 if short else 1
    for w in range(nwin):
        n_filt = int(batch["tnsn"][r][w])
        base = w * 128 if short else 0
        bottom = nbands
        for fi in range(n_filt):
            length, order, direction = (
                int(x) for x in batch["tnsp"][r][w * 3 + fi])
            top = bottom
            bottom = max(top - length, 0)
            if order == 0:
                continue
            start = int(offsets[min(bottom, nbands)])
            end = min(int(offsets[min(top, nbands)]), 128 if short else 1024)
            if end <= start:
                continue
            lpc = _lattice_to_lpc(batch["tnsc"][r][w * 3 + fi][:order]
                                  .astype(np.float64)).tolist()
            seg = spec[base + start:base + end].copy()
            if direction:
                seg = seg[::-1].copy()
            vals = seg.tolist()
            state = [0.0] * len(lpc)
            for i, v in enumerate(vals):
                y = v - sum(a * s for a, s in zip(lpc, state))
                state = [y] + state[:-1]
                vals[i] = y
            out = np.asarray(vals)
            if direction:
                out = out[::-1]
            spec[base + start:base + end] = out


def _pns_noise(row: int, pos: int, n: int) -> np.ndarray:
    """Deterministic PNS noise seeded per (row, band position), with the JAX
    package's seed, so both packages prepare the same side rows.  (The seed
    ignores the frame, so a stationary PNS band repeats its noise every
    frame; that defect of the reference is kept, and PNS content is gated
    by energy.)"""
    return np.random.default_rng(
        (0x9A5 << 32) ^ (row * 2048 + pos)).standard_normal(n)


# ---------------------------------------------------------------------------
# per-frame host prep of the object path (decode_frames, the numpy SBR
# chain): numpy, as the JAX package's
# ---------------------------------------------------------------------------

def dequantize(ch: "BS.ChannelData", rate_index: int) -> np.ndarray:
    """Quantized ints -> scaled spectrum, deinterleaved to window order
    (8x128 flattened for short frames)."""
    ics = ch.ics
    offsets = T.sfb_offsets(rate_index, ics.short)
    q = ch.quant.astype(np.int64)
    mag = np.where(np.abs(q) < 8192, _POW43[np.minimum(np.abs(q), 8191)],
                   np.abs(q).astype(np.float64) ** (4.0 / 3.0))
    spec_tx = np.sign(q) * mag
    out = np.zeros(1024)
    groups = ics.window_groups()
    if not ics.short:
        for k in range(ics.max_sfb):
            c = ch.band_cb[0, k]
            if c == 0 or c == 12 or c >= T.NOISE_CB:
                continue
            a, b = int(offsets[k]), int(offsets[k + 1])
            gain = 2.0 ** (0.25 * (ch.scalefactors[0, k] - T.SF_OFFSET))
            out[a:b] = spec_tx[a:b] * gain
        return out
    # short: transmission order [group][sfb][win][bins] -> [win][bins]
    pos = 0
    win_base = 0
    for g, wins in enumerate(groups):
        for k in range(ics.max_sfb):
            width = int(offsets[k + 1] - offsets[k])
            c = ch.band_cb[g, k]
            gain = 2.0 ** (0.25 * (ch.scalefactors[g, k] - T.SF_OFFSET))
            for w in range(wins):
                if not (c == 0 or c == 12 or c >= T.NOISE_CB):
                    a = (win_base + w) * 128 + int(offsets[k])
                    out[a:a + width] = spec_tx[pos:pos + width] * gain
                pos += width
        win_base += wins
        pos = win_base * 128         # groups start at full window strides
    return out


def apply_spectral_tools(frame: "BS.FrameData",
                         specs: list[np.ndarray]) -> None:
    """In-place M/S, intensity, PNS over the dequantized spectra.

    Order per ISO 14496-3 4.6.7-4.6.9: PNS -> M/S -> intensity.
    """
    rate_index = frame.rate_index
    # PNS per channel
    for ch, spec in zip(frame.channels, specs):
        _apply_pns(ch, spec, rate_index)
    if len(frame.channels) != 2:
        return
    l_ch, r_ch = frame.channels
    l, r = specs
    ics = l_ch.ics
    offsets = T.sfb_offsets(rate_index, ics.short)
    groups = ics.window_groups()
    mask = frame.ms_mask
    win_base = 0
    for g, wins in enumerate(groups):
        for k in range(ics.max_sfb):
            a0, b0 = int(offsets[k]), int(offsets[k + 1])
            cb_r = r_ch.band_cb[g, k] if r_ch.band_cb is not None else 0
            for w in range(wins):
                base = (win_base + w) * 128 if ics.short else 0
                a, b = base + a0, base + b0
                if cb_r in (T.INTENSITY_CB, T.INTENSITY_CB2):
                    sign = 1.0 if cb_r == T.INTENSITY_CB else -1.0
                    if mask is not None and mask[g, k]:
                        sign = -sign
                    scale = sign * 0.5 ** (0.25 * r_ch.scalefactors[g, k])
                    r[a:b] = l[a:b] * scale
                elif mask is not None and mask[g, k] \
                        and cb_r not in (T.NOISE_CB,):
                    mid = l[a:b].copy()
                    side = r[a:b].copy()
                    l[a:b] = mid + side
                    r[a:b] = mid - side
        win_base += wins


def _apply_pns(ch: "BS.ChannelData", spec: np.ndarray,
               rate_index: int) -> None:
    ics = ch.ics
    if ch.band_cb is None or not (ch.band_cb == T.NOISE_CB).any():
        return
    offsets = T.sfb_offsets(rate_index, ics.short)
    groups = ics.window_groups()
    win_base = 0
    for g, wins in enumerate(groups):
        for k in range(ics.max_sfb):
            if ch.band_cb[g, k] != T.NOISE_CB:
                continue
            a0, b0 = int(offsets[k]), int(offsets[k + 1])
            energy = 2.0 ** (0.25 * ch.scalefactors[g, k])
            for w in range(wins):
                base = (win_base + w) * 128 if ics.short else 0
                n = _pns_noise(win_base + w, base + a0, b0 - a0)
                n *= energy / np.sqrt(np.mean(n * n) + 1e-30)
                spec[base + a0:base + b0] = n
        win_base += wins


def apply_tns(ch: "BS.ChannelData", spec: np.ndarray,
              rate_index: int) -> None:
    """TNS synthesis filtering (ISO 14496-3 4.6.9): all-pole filter across
    spectral bins per window."""
    if ch.tns is None:
        return
    ics = ch.ics
    offsets = T.sfb_offsets(rate_index, ics.short)
    nbands = len(offsets) - 1
    # TNS max band limits (ISO Table 4.139-ish); clamp to max_sfb range
    for w, filters in enumerate(ch.tns.filters):
        base = w * 128 if ics.short else 0
        bottom = nbands
        for (length, order, direction, coeffs) in filters:
            top = bottom
            bottom = max(top - length, 0)
            if order == 0:
                continue
            start = int(offsets[min(bottom, nbands)])
            end = int(offsets[min(top, nbands)])
            end = min(end, 128 if ics.short else 1024)
            if end <= start:
                continue
            a = np.asarray(coeffs)
            seg = spec[base + start:base + end]
            if direction:
                seg = seg[::-1]
            # lattice-to-direct form conversion
            lpc = _lattice_to_lpc(a)
            state = np.zeros(len(lpc))
            for i in range(len(seg)):
                y = seg[i] - np.dot(lpc, state)
                state = np.roll(state, 1)
                state[0] = y
                seg[i] = y
            if direction:
                spec[base + start:base + end] = seg[::-1]
            else:
                spec[base + start:base + end] = seg


def _lattice_to_lpc(refl: np.ndarray) -> np.ndarray:
    a = np.zeros(0)
    for k in refl:
        a = np.concatenate([a + k * a[::-1], [k]]) if len(a) else np.array([k])
    return a
