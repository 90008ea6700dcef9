"""SILK LP-layer bitstream parser (RFC 6716 section 4.2).

Decodes every symbol of a SILK-only frame through the (conformance-
tested) range decoder: header flags, frame type, quantization gains,
NLSF stage-1/stage-2 indices, pitch lags + contour, LTP filter indices
and scaling, LCG seed, and the shell-coded excitation (pulse counts,
shell splits, LSBs, signs).  The symbol schedule mirrors the normative
decoder (opus-1.5.2 silk/decode_indices.c, decode_pulses.c,
shell_coder.c, code_signs.c); tables come from silk_tables.npz
(tools/extract_silk_tables.py).

This file carries the complete SILK decoder: the entropy layer above,
parameter dequantisation (NLSF -> LPC, gains, LTP), and the synthesis
stack (LTP + LPC filters, stereo mid/side unmixing, resampling to the
API rate) — codecs.opus.CodecOpus plays SILK and hybrid frames through
it.  On the default native path both layers run in C++ (the whole
packet parse in native/silk_parse.cc, fused per-frame dequant +
fixed-point synthesis in native/silk_synth.cc + silk_core.cc); the
Python code here is the behaviour oracle, forced with OHP_SILK_PY=1
(parse) / OHP_SILK_FLOAT=1 (float synthesis).  Reference product
path: OpenHome/Media/Codec/Opus.cpp over thirdparty/opus-1.5.2
(silk/decode_core.c et al.).

The port's copy of the JAX package's ``codecs/opus/silk.py``, with one
change: its ten imports of the native helpers take the port's own
(``from ... import native``), whose loader raises where a helper does not
build instead of reading as absent.
"""

from __future__ import annotations

import pathlib
from dataclasses import dataclass, field

import numpy as np

from .range_dec import RangeDecoder

_TABLES = None

MAX_PULSES = 16
SHELL_FRAME = 16


def tables() -> dict:
    global _TABLES
    if _TABLES is None:
        p = pathlib.Path(__file__).with_name("silk_tables.npz")
        _TABLES = {k: v.astype(np.int64) for k, v in np.load(p).items()}
    return _TABLES


def _icdf(t) -> list:
    """Plain-int iCDF list (the range decoder multiplies entries by the
    32-bit range; numpy uint8 scalars would overflow)."""
    return [int(v) for v in t]


@dataclass
class SilkBandwidthParams:
    fs_khz: int
    lpc_order: int
    low_bits_table: str


BW = {
    "nb": SilkBandwidthParams(8, 10, "uniform4_iCDF"),
    "mb": SilkBandwidthParams(12, 10, "uniform6_iCDF"),
    "wb": SilkBandwidthParams(16, 16, "uniform8_iCDF"),
}


@dataclass
class SilkFrameIndices:
    signal_type: int = 0               # 0 inactive, 1 unvoiced, 2 voiced
    quant_offset: int = 0
    gain_indices: list = field(default_factory=list)
    nlsf_stage1: int = 0
    nlsf_residuals: list = field(default_factory=list)
    nlsf_interp_q2: int = 4
    lag_index: int = 0
    contour_index: int = 0
    per_index: int = 0
    ltp_indices: list = field(default_factory=list)
    ltp_scale_index: int = 0
    seed: int = 0
    pulses: np.ndarray = None          # (frame_length,) signed excitation
    cond_coding: bool = False          # CODE_CONDITIONALLY frame


def _nlsf_unpack(bw: str, stage1: int, order: int):
    """silk_NLSF_unpack: entropy-table offsets + predictors for the
    stage-2 residual of codebook vector `stage1`."""
    T = tables()
    sel = T["NLSF_CB2_SELECT_WB" if bw == "wb" else "NLSF_CB2_SELECT_NB_MB"]
    ec_ix = np.zeros(order, np.int64)
    entries = sel[stage1 * order // 2:(stage1 + 1) * order // 2]
    for i in range(0, order, 2):
        entry = int(entries[i // 2])
        ec_ix[i] = ((entry >> 1) & 7) * 9
        ec_ix[i + 1] = ((entry >> 5) & 7) * 9
    return ec_ix


def decode_frame_indices(dec: RangeDecoder, bw: str, vad: bool,
                         n_subfr: int = 4,
                         cond_coding: bool = False,
                         prev: dict | None = None,
                         ltp_scale_decoded: bool | None = None
                         ) -> SilkFrameIndices:
    """decode_indices.c for one 20 ms frame.  `cond_coding` selects
    CODE_CONDITIONALLY (delta gains + delta pitch vs `prev`, no LTP
    scale index); `prev` threads ec_prevSignalType/ec_prevLagIndex
    across the frames of a packet.  `ltp_scale_decoded=False` with
    cond_coding=False models CODE_INDEPENDENTLY_NO_LTP_SCALING."""
    T = tables()
    p = BW[bw]
    ix = SilkFrameIndices(cond_coding=cond_coding)
    if ltp_scale_decoded is None:
        ltp_scale_decoded = not cond_coding
    if vad:
        v = dec.dec_icdf(_icdf(T["type_offset_VAD_iCDF"]), 8) + 2
    else:
        v = dec.dec_icdf(_icdf(T["type_offset_no_VAD_iCDF"]), 8)
    ix.signal_type = v >> 1
    ix.quant_offset = v & 1
    # gains: first subframe MSB (per signal type) + 3 LSBs, then deltas
    if cond_coding:
        ix.gain_indices.append(dec.dec_icdf(_icdf(T["delta_gain_iCDF"]), 8))
    else:
        msb = dec.dec_icdf(
            _icdf(T["gain_iCDF"][ix.signal_type * 8:
                                 (ix.signal_type + 1) * 8]), 8)
        lsb = dec.dec_icdf(_icdf(T["uniform8_iCDF"]), 8)
        ix.gain_indices.append((msb << 3) + lsb)
    for _ in range(1, n_subfr):
        ix.gain_indices.append(dec.dec_icdf(_icdf(T["delta_gain_iCDF"]), 8))
    # NLSF stage 1 + stage 2 residuals
    cb1 = T["NLSF_CB1_iCDF_WB" if bw == "wb" else "NLSF_CB1_iCDF_NB_MB"]
    nvec = 32
    ix.nlsf_stage1 = dec.dec_icdf(
        _icdf(cb1[(ix.signal_type >> 1) * nvec:
                  (ix.signal_type >> 1) * nvec + nvec]), 8)
    ec_ix = _nlsf_unpack(bw, ix.nlsf_stage1, p.lpc_order)
    cb2 = T["NLSF_CB2_iCDF_WB" if bw == "wb" else "NLSF_CB2_iCDF_NB_MB"]
    for i in range(p.lpc_order):
        v = dec.dec_icdf(_icdf(cb2[ec_ix[i]:ec_ix[i] + 9]), 8)
        if v == 0:
            v -= dec.dec_icdf(_icdf(T["NLSF_EXT_iCDF"]), 8)
        elif v == 8:
            v += dec.dec_icdf(_icdf(T["NLSF_EXT_iCDF"]), 8)
        ix.nlsf_residuals.append(v - 4)
    if n_subfr == 4:
        ix.nlsf_interp_q2 = dec.dec_icdf(
            _icdf(T["NLSF_interpolation_factor_iCDF"]), 8)
    if ix.signal_type == 2:            # voiced
        decode_absolute = True
        if cond_coding and prev is not None and prev.get("sig") == 2:
            delta = dec.dec_icdf(_icdf(T["pitch_delta_iCDF"]), 8)
            if delta > 0:
                ix.lag_index = prev["lag"] + (delta - 9)
                decode_absolute = False
        if decode_absolute:
            high = dec.dec_icdf(_icdf(T["pitch_lag_iCDF"]), 8)
            low = dec.dec_icdf(_icdf(T[p.low_bits_table]), 8)
            ix.lag_index = high * (p.fs_khz // 2) + low
        if prev is not None:
            prev["lag"] = ix.lag_index
        if n_subfr == 4:
            contour = T["pitch_contour_NB_iCDF" if bw == "nb"
                        else "pitch_contour_iCDF"]
        else:
            contour = T["pitch_contour_10_ms_NB_iCDF" if bw == "nb"
                        else "pitch_contour_10_ms_iCDF"]
        ix.contour_index = dec.dec_icdf(_icdf(contour), 8)
        ix.per_index = dec.dec_icdf(_icdf(T["LTP_per_index_iCDF"]), 8)
        ltp_cb = T[f"LTP_gain_iCDF_{ix.per_index}"]
        for _ in range(n_subfr):
            ix.ltp_indices.append(dec.dec_icdf(_icdf(ltp_cb), 8))
        if ltp_scale_decoded:
            ix.ltp_scale_index = dec.dec_icdf(_icdf(T["LTPscale_iCDF"]), 8)
    if prev is not None:
        prev["sig"] = ix.signal_type
    ix.seed = dec.dec_icdf(_icdf(T["uniform4_iCDF"]), 8)
    return ix


def _shell_decode(dec: RangeDecoder, total: int) -> np.ndarray:
    """shell_coder.c silk_shell_decoder: split 16 -> ... -> 1."""
    T = tables()
    offs = T["shell_code_table_offsets"]
    shells = [T[f"shell_code_table{i}"] for i in range(4)]

    def split(p: int, level: int) -> tuple[int, int]:
        if p <= 0:
            return 0, 0
        tab = shells[level]
        o = int(offs[p])
        child1 = dec.dec_icdf(_icdf(tab[o:o + p + 1 + 1]), 8)
        return child1, p - child1

    out = np.zeros(SHELL_FRAME, np.int64)

    def recurse(p: int, level: int, base: int) -> None:
        if level < 0:
            out[base] = p
            return
        c1, c2 = split(p, level)
        half = 1 << level
        recurse(c1, level - 1, base)
        recurse(c2, level - 1, base + half)

    recurse(total, 3, 0)
    return out


def decode_excitation(dec: RangeDecoder, signal_type: int,
                      quant_offset: int, frame_length: int) -> np.ndarray:
    """decode_pulses.c + code_signs.c: signed excitation pulses."""
    T = tables()
    rate_level = dec.dec_icdf(
        _icdf(T["rate_levels_iCDF"][(signal_type >> 1) * 9:
                                    (signal_type >> 1) * 9 + 9]), 8)
    niter = frame_length // SHELL_FRAME
    if niter * SHELL_FRAME < frame_length:
        # 10 ms @ 12 kHz (MB): 120 samples round UP to 8 shell blocks;
        # the tail block's extra samples are decoded and discarded
        # (decode_pulses.c:57-61, code_signs.c:91)
        niter += 1
    ppb = T["pulses_per_block_iCDF"].reshape(10, 18)
    sum_pulses = []
    n_lshifts = []
    for _ in range(niter):
        shifts = 0
        s = dec.dec_icdf(_icdf(ppb[rate_level]), 8)
        while s == MAX_PULSES + 1:
            shifts += 1
            row = ppb[9] if shifts != 10 else ppb[9][1:]
            s = dec.dec_icdf(_icdf(row), 8)
        sum_pulses.append(s)
        n_lshifts.append(shifts)
    pulses = np.zeros(niter * SHELL_FRAME, np.int64)
    for i, s in enumerate(sum_pulses):
        if s > 0:
            pulses[i * SHELL_FRAME:(i + 1) * SHELL_FRAME] = \
                _shell_decode(dec, s)
    for i, shifts in enumerate(n_lshifts):
        if shifts > 0:
            blk = pulses[i * SHELL_FRAME:(i + 1) * SHELL_FRAME]
            for k in range(SHELL_FRAME):
                q = int(blk[k])
                for _ in range(shifts):
                    q = (q << 1) + dec.dec_icdf(_icdf(T["lsb_iCDF"]), 8)
                blk[k] = q
            sum_pulses[i] |= shifts << 5
    # signs
    sign_base = 7 * (quant_offset + (signal_type << 1))
    sign_tab = T["sign_iCDF"]
    for i, s in enumerate(sum_pulses):
        if s <= 0:
            continue
        icdf0 = int(sign_tab[sign_base + min(s & 0x1F, 6)])
        icdf = [icdf0, 0]
        blk = pulses[i * SHELL_FRAME:(i + 1) * SHELL_FRAME]
        for k in range(SHELL_FRAME):
            if blk[k] > 0:
                if dec.dec_icdf(icdf, 8) == 0:
                    blk[k] = -blk[k]
    return pulses[:frame_length]


@dataclass
class SilkFrame:
    vad: bool
    indices: SilkFrameIndices


def _decode_lbrr_flags(dec: RangeDecoder, n_frames: int) -> list:
    """Per-frame LBRR flags after the channel's LBRR bit
    (dec_API.c:238-250)."""
    if not dec.dec_bit_logp(1):
        return [0] * n_frames
    if n_frames == 1:
        return [1]
    sym = dec.dec_icdf(
        _icdf(tables()[f"LBRR_flags_{n_frames}_iCDF"]), 8) + 1
    return [(sym >> i) & 1 for i in range(n_frames)]


# --------------------------------------------------------------------------
# native parse fast path (native/silk_parse.cc runs the whole packet's
# symbol schedule in C++; the Python functions below are the behaviour
# oracle, forced with OHP_SILK_PY=1)

_BW_IDX = {"nb": 0, "mb": 1, "wb": 2}
_PARSE_BLOB = None

#: table order must match the Tab enum in native/silk_parse.cc
_BLOB_NAMES = (
    "type_offset_VAD_iCDF", "type_offset_no_VAD_iCDF", "gain_iCDF",
    "uniform8_iCDF", "delta_gain_iCDF", "NLSF_CB1_iCDF_NB_MB",
    "NLSF_CB1_iCDF_WB", "NLSF_CB2_SELECT_NB_MB", "NLSF_CB2_SELECT_WB",
    "NLSF_CB2_iCDF_NB_MB", "NLSF_CB2_iCDF_WB", "NLSF_EXT_iCDF",
    "NLSF_interpolation_factor_iCDF", "pitch_delta_iCDF",
    "pitch_lag_iCDF", "uniform4_iCDF", "uniform6_iCDF",
    "pitch_contour_NB_iCDF", "pitch_contour_iCDF",
    "pitch_contour_10_ms_NB_iCDF", "pitch_contour_10_ms_iCDF",
    "LTP_per_index_iCDF", "LTP_gain_iCDF_0", "LTP_gain_iCDF_1",
    "LTP_gain_iCDF_2", "LTPscale_iCDF", "rate_levels_iCDF",
    "pulses_per_block_iCDF", "shell_code_table0", "shell_code_table1",
    "shell_code_table2", "shell_code_table3", "shell_code_table_offsets",
    "lsb_iCDF", "sign_iCDF", "LBRR_flags_2_iCDF", "LBRR_flags_3_iCDF",
    "stereo_pred_joint_iCDF", "uniform3_iCDF", "uniform5_iCDF",
    "stereo_only_code_mid_iCDF")


def _parse_blob():
    """(uint8 table blob, int32 offsets, int32 stereo pred quant) for
    native.silk_parse_packet, built once from silk_tables.npz."""
    global _PARSE_BLOB
    if _PARSE_BLOB is None:
        T = tables()
        arrs = [T[n].astype(np.uint8) for n in _BLOB_NAMES]
        offs = np.cumsum([0] + [len(a) for a in arrs])[:-1]
        _PARSE_BLOB = (
            np.ascontiguousarray(np.concatenate(arrs)),
            np.ascontiguousarray(offs, dtype=np.int32),
            np.ascontiguousarray(T["stereo_pred_quant_Q13"], np.int32))
    return _PARSE_BLOB


def _use_native_parse() -> bool:
    import os
    if os.environ.get("OHP_SILK_PY"):
        return False
    from ... import native
    return native.have_silk_core()


def _st64_from_dec(dec: RangeDecoder | None) -> np.ndarray:
    st = np.zeros(10, np.int64)
    if dec is not None:
        st[0] = 1
        st[1] = dec.offs
        st[2] = dec.end_offs
        st[3] = dec.end_window
        st[4] = dec.nend_bits
        st[5] = dec.nbits_total
        st[6] = dec.rng
        st[7] = dec.rem
        st[8] = dec.val
        st[9] = dec.error
    return st


def _dec_from_st64(dec: RangeDecoder, st: np.ndarray) -> None:
    dec.offs = int(st[1])
    dec.end_offs = int(st[2])
    dec.end_window = int(st[3])
    dec.nend_bits = int(st[4])
    dec.nbits_total = int(st[5])
    dec.rng = int(st[6])
    dec.rem = int(st[7])
    dec.val = int(st[8])
    dec.error = int(st[9])


#: dequant-table blob for native.silk_synth_frame_fix (order must match
#: the DqTab enum in native/silk_synth.cc)
_DQ_NAMES = (
    "NLSF_CB2_SELECT_NB_MB", "NLSF_CB2_SELECT_WB",
    "NLSF_PRED_NB_MB_Q8", "NLSF_PRED_WB_Q8",
    "NLSF_CB1_NB_MB_Q8", "NLSF_CB1_WB_Q8",
    "NLSF_CB1_Wght_Q9", "NLSF_CB1_WB_Wght_Q9",
    "NLSF_DELTA_MIN_NB_MB_Q15", "NLSF_DELTA_MIN_WB_Q15",
    "CB_lags_stage2", "CB_lags_stage3",
    "CB_lags_stage2_10_ms", "CB_lags_stage3_10_ms",
    "LTP_gain_vq_0", "LTP_gain_vq_1", "LTP_gain_vq_2",
    "LTPScales_table_Q14")
_DQ_BLOB = None
_COS16 = None


def _dq_blob():
    global _DQ_BLOB
    if _DQ_BLOB is None:
        T = tables()
        arrs = [np.ascontiguousarray(T[n], dtype=np.int32)
                for n in _DQ_NAMES]
        offs = np.cumsum([0] + [len(a) for a in arrs])[:-1]
        _DQ_BLOB = (np.ascontiguousarray(np.concatenate(arrs), np.int32),
                    np.ascontiguousarray(offs, dtype=np.int32))
    return _DQ_BLOB


def _cos16() -> np.ndarray:
    global _COS16
    if _COS16 is None:
        _COS16 = tables()["LSFCosTab_FIX_Q12"].astype(np.int16)
    return _COS16


def _ix_from_row(row: np.ndarray, pulses: np.ndarray, n_subfr: int,
                 order: int) -> SilkFrameIndices:
    """One 40-int32 native frame row -> SilkFrameIndices (layout
    documented in native/silk_parse.cc).  The raw row rides along as
    ``ix.row`` so synthesis can take the fused native path
    (silk_synth.cc) without re-marshalling."""
    voiced = int(row[2]) == 2
    ix = SilkFrameIndices(
        signal_type=int(row[2]), quant_offset=int(row[3]),
        gain_indices=[int(v) for v in row[4:4 + n_subfr]],
        nlsf_stage1=int(row[8]),
        nlsf_residuals=[int(v) for v in row[9:9 + order]],
        nlsf_interp_q2=int(row[25]), lag_index=int(row[26]),
        contour_index=int(row[27]), per_index=int(row[28]),
        ltp_indices=[int(v) for v in row[29:29 + n_subfr]]
        if voiced else [],
        ltp_scale_index=int(row[33]), seed=int(row[34]),
        cond_coding=bool(row[35]))
    ix.pulses = pulses
    ix.row = np.ascontiguousarray(row)
    return ix


def parse_silk_packet(data: bytes, bw: str, stereo: bool = False,
                      duration_ms: int = 20,
                      dec: RangeDecoder | None = None,
                      lbrr_out: list | None = None) -> list[SilkFrame]:
    """Parse a mono SILK-only packet's LP layer: 20/40/60 ms packets
    (1-3 regular frames with conditional coding between them,
    dec_API.c:322-341).  LBRR (in-band FEC) frames are decoded too
    (dec_API.c:253-279): pass ``lbrr_out`` (a list) to receive one
    entry per frame slot — a SilkFrame when that slot carries LBRR
    data, else None — for FLAG_DECODE_LBRR recovery; without it they
    are discarded.  Returns the regular frames; raises on malformed
    data."""
    if stereo:
        raise NotImplementedError("use parse_silk_packet_stereo")
    if duration_ms not in (10, 20, 40, 60):
        raise NotImplementedError("only 10-60 ms SILK packets")
    if _use_native_parse() and (dec is None or (dec.buf is data
                                                and dec.storage
                                                == len(data))):
        # a shared decoder must be reading THIS buffer for its state
        # offsets to transplant (same guard as celt.py's native handoff)
        from ... import native
        n_frames = max(1, duration_ms // 20)
        n_subfr = 2 if duration_ms == 10 else 4
        p = BW[bw]
        frame_length = (duration_ms // n_frames) * p.fs_khz
        blob, offs, pred_q = _parse_blob()
        st64 = _st64_from_dec(dec)
        res = native.silk_parse_packet(
            data, st64, _BW_IDX[bw], False, n_frames, n_subfr,
            frame_length, blob, offs, pred_q)
        if res is not None:
            ixs, pulses, lbrr_ix, lbrr_pulses, _misc = res
            if dec is not None:
                _dec_from_st64(dec, st64)
            if lbrr_out is not None:
                for i in range(n_frames):
                    if lbrr_ix[i, 0]:
                        lbrr_out.append(SilkFrame(True, _ix_from_row(
                            lbrr_ix[i], lbrr_pulses[i], n_subfr,
                            p.lpc_order)))
                    else:
                        lbrr_out.append(None)
            return [SilkFrame(bool(ixs[i, 1]),
                              _ix_from_row(ixs[i], pulses[i], n_subfr,
                                           p.lpc_order))
                    for i in range(n_frames)]
    return _parse_silk_packet_py(data, bw, duration_ms, dec, lbrr_out)


def _parse_silk_packet_py(data: bytes, bw: str,
                          duration_ms: int = 20,
                          dec: RangeDecoder | None = None,
                          lbrr_out: list | None = None) -> list[SilkFrame]:
    """Pure-Python packet parse (behaviour oracle for the native path)."""
    if duration_ms not in (10, 20, 40, 60):
        raise NotImplementedError("only 10-60 ms SILK packets")
    n_frames = max(1, duration_ms // 20)
    n_subfr = 2 if duration_ms == 10 else 4
    p = BW[bw]
    frame_length = (duration_ms // n_frames) * p.fs_khz
    if dec is None:
        dec = RangeDecoder(data)
    vad = [bool(dec.dec_bit_logp(1)) for _ in range(n_frames)]
    lbrr = _decode_lbrr_flags(dec, n_frames)
    prev_lbrr: dict = {}
    for i in range(n_frames):
        if lbrr[i]:
            # LBRR frames always use the VAD-conditioned tables
            # (decode_indices.c:51)
            jx = decode_frame_indices(
                dec, bw, True, n_subfr,
                cond_coding=bool(i > 0 and lbrr[i - 1]),
                prev=prev_lbrr)
            jx.pulses = decode_excitation(dec, jx.signal_type,
                                          jx.quant_offset, frame_length)
            if lbrr_out is not None:
                lbrr_out.append(SilkFrame(True, jx))
        elif lbrr_out is not None:
            lbrr_out.append(None)
    prev: dict = {}
    frames = []
    for i in range(n_frames):
        ix = decode_frame_indices(dec, bw, vad[i], n_subfr,
                                  cond_coding=i > 0, prev=prev)
        ix.pulses = decode_excitation(dec, ix.signal_type,
                                      ix.quant_offset, frame_length)
        frames.append(SilkFrame(vad[i], ix))
    return frames


# ---------------------------------------------------------------------------
# NLSF dequantisation -> LPC coefficients (NLSF_decode.c, NLSF2A.c)
# ---------------------------------------------------------------------------

_QUANT_STEP_Q16 = {"nb": 11796, "mb": 11796, "wb": 9830}   # 0.18 / 0.15
_NLSF_QUANT_LEVEL_ADJ_Q10 = 102                            # 0.1 in Q10
_ORDERING = {
    16: [0, 15, 8, 7, 4, 11, 12, 3, 2, 13, 10, 5, 6, 9, 14, 1],
    10: [0, 9, 6, 3, 4, 5, 8, 1, 2, 7],
}


def _nlsf_pred(bw: str, stage1: int, order: int) -> np.ndarray:
    """Backward predictor coefficients for each residual (NLSF_unpack)."""
    T = tables()
    sel = T["NLSF_CB2_SELECT_WB" if bw == "wb" else "NLSF_CB2_SELECT_NB_MB"]
    pred_tab = T["NLSF_PRED_WB_Q8" if bw == "wb" else "NLSF_PRED_NB_MB_Q8"]
    pred = np.zeros(order, np.int64)
    entries = sel[stage1 * order // 2:(stage1 + 1) * order // 2]
    for i in range(0, order, 2):
        entry = int(entries[i // 2])
        pred[i] = pred_tab[i + (entry & 1) * (order - 1)]
        pred[i + 1] = pred_tab[i + ((entry >> 4) & 1) * (order - 1) + 1]
    return pred


def nlsf_decode(bw: str, stage1: int, residuals: list) -> np.ndarray:
    """Dequantise NLSF indices to a stabilised Q15 NLSF vector
    (silk_NLSF_decode: backward-predictive residual dequant, codebook
    vector add with inverse-square-root weights, spacing stabilise)."""
    T = tables()
    order = len(residuals)
    pred = _nlsf_pred(bw, stage1, order)
    step = _QUANT_STEP_Q16[bw]
    # residual dequant, backwards
    res_q10 = np.zeros(order, np.int64)
    out_q10 = 0
    for i in range(order - 1, -1, -1):
        pred_q10 = (out_q10 * pred[i]) >> 8
        out_q10 = residuals[i] << 10
        if out_q10 > 0:
            out_q10 -= _NLSF_QUANT_LEVEL_ADJ_Q10
        elif out_q10 < 0:
            out_q10 += _NLSF_QUANT_LEVEL_ADJ_Q10
        out_q10 = pred_q10 + ((out_q10 * step) >> 16)
        res_q10[i] = out_q10
    cb1 = T["NLSF_CB1_WB_Q8" if bw == "wb" else "NLSF_CB1_NB_MB_Q8"]
    wght = T["NLSF_CB1_WB_Wght_Q9" if bw == "wb" else "NLSF_CB1_Wght_Q9"]
    vec = cb1[stage1 * order:(stage1 + 1) * order]
    w = wght[stage1 * order:(stage1 + 1) * order]
    # silk_DIV32_16 truncates toward zero (C division), not floor
    num = res_q10 << 14
    quot = np.sign(num) * (np.abs(num) // w)
    nlsf = np.clip(quot + (vec << 7), 0, 32767)
    # stabilise ordering/spacing (silk_NLSF_stabilize, 20-iteration cap
    # then a hard sort+clamp pass like the reference fallback)
    dmin = T["NLSF_DELTA_MIN_WB_Q15" if bw == "wb"
             else "NLSF_DELTA_MIN_NB_MB_Q15"]
    nlsf = nlsf.astype(np.int64)
    for _ in range(20):
        diffs = [nlsf[0] - dmin[0]]
        diffs += [nlsf[i] - (nlsf[i - 1] + dmin[i]) for i in range(1, order)]
        diffs.append((1 << 15) - (nlsf[order - 1] + dmin[order]))
        I = int(np.argmin(diffs))
        if diffs[I] >= 0:
            return nlsf.astype(np.int16)
        if I == 0:
            nlsf[0] = dmin[0]
        elif I == order:
            nlsf[order - 1] = (1 << 15) - dmin[order]
        else:
            min_c = int(dmin[:I].sum() + (dmin[I] >> 1))
            max_c = int((1 << 15) - dmin[I + 1:].sum() - (dmin[I] >> 1))
            center = (int(nlsf[I - 1]) + int(nlsf[I]) + 1) >> 1
            center = min(max(center, min_c), max_c)
            nlsf[I - 1] = center - (dmin[I] >> 1)
            nlsf[I] = nlsf[I - 1] + dmin[I]
    # fallback: sort and force minimum spacing in both directions
    nlsf = np.sort(nlsf)
    for i in range(order):
        lo = (nlsf[i - 1] + dmin[i]) if i else dmin[0]
        nlsf[i] = max(nlsf[i], lo)
    for i in range(order - 1, -1, -1):
        hi = (nlsf[i + 1] - dmin[i + 1]) if i < order - 1 \
            else (1 << 15) - dmin[order]
        nlsf[i] = min(nlsf[i], hi)
    return nlsf.astype(np.int16)


def nlsf_to_lpc(nlsf_q15: np.ndarray) -> np.ndarray:
    """Q15 NLSFs -> monic LPC coefficients in Q12 (silk_NLSF2A:
    cosine-table interpolation, interleaved polynomial build, bandwidth
    expansion until stable)."""
    T = tables()
    cos_tab = T["LSFCosTab_FIX_Q12"]
    d = len(nlsf_q15)
    QA = 16
    order = _ORDERING[d]
    clsf = np.zeros(d, np.int64)
    for k in range(d):
        f = int(nlsf_q15[k])
        f_int = f >> 8
        f_frac = f - (f_int << 8)
        cos_val = int(cos_tab[f_int])
        delta = int(cos_tab[f_int + 1]) - cos_val
        clsf[order[k]] = ((cos_val << 8) + delta * f_frac + (1 << 3)) >> 4

    def find_poly(cl, off):
        dd = d // 2
        out = np.zeros(dd + 1, np.int64)
        out[0] = 1 << QA
        out[1] = -cl[off]
        for k in range(1, dd):
            ftmp = int(cl[2 * k + off])
            out[k + 1] = (out[k - 1] << 1) \
                - ((ftmp * out[k] + (1 << (QA - 1))) >> QA)
            for n in range(k, 1, -1):
                out[n] += out[n - 2] \
                    - ((ftmp * out[n - 1] + (1 << (QA - 1))) >> QA)
            out[1] -= ftmp
        return out

    P = find_poly(clsf, 0)
    Q = find_poly(clsf, 1)
    a32 = np.zeros(d, np.int64)
    for k in range(d // 2):
        pt = P[k + 1] + P[k]
        qt = Q[k + 1] - Q[k]
        a32[k] = -qt - pt
        a32[d - k - 1] = qt - pt
    # QA+1 -> Q12 with bandwidth expansion until the filter is stable
    for i in range(20):
        a_q12 = np.round(a32 / (1 << (QA + 1 - 12))).astype(np.int64)
        a = a_q12 / 4096.0
        roots = np.roots(np.concatenate([[1.0], -a]))
        if np.abs(a_q12).max() < 32768 and np.abs(roots).max() < 0.9999:
            return a_q12.astype(np.int16)
        chirp = 1.0 - (2 << i) / 65536.0
        a32 = np.round(a32 * chirp ** np.arange(1, d + 1)).astype(np.int64)
    return np.round(a32 / (1 << (QA + 1 - 12))).astype(np.int16)


# ---------------------------------------------------------------------------
# parameter dequantisation: gains, pitch lags, LTP taps (gain_quant.c,
# decode_pitch.c, decode_parameters.c)
# ---------------------------------------------------------------------------

_N_LEVELS_QGAIN = 64
_MIN_DELTA_GAIN = -4
_MAX_DELTA_GAIN = 36
_GAIN_OFFSET = (2 * 128) // 6 + 16 * 128
#: gain_quant.c:36 INV_SCALE_Q16 — the inner (dB_range*128)/6 divides
#: first (C parenthesisation), then scales by 65536
_INV_SCALE_Q16 = (65536 * (((88 - 2) * 128) // 6)) // (_N_LEVELS_QGAIN - 1)


def _log2lin(x_q7: int) -> int:
    """silk_log2lin: 2**(x/128) with the reference's parabolic frac."""
    if x_q7 < 0:
        return 0
    x_q7 = min(x_q7, 3967)
    out = 1 << (x_q7 >> 7)
    frac = x_q7 & 0x7F
    para = frac + ((frac * (128 - frac) * -174) >> 16)
    if x_q7 < 2048:
        out = out + ((out * para) >> 7)
    else:
        out = out + ((out >> 7) * para)
    return out


def gains_dequant(indices: list, prev_ind: int,
                  conditional: bool = False) -> tuple[list, int]:
    """Gain indices -> linear Q16 gains (silk_gains_dequant);
    returns (gains_q16, new_prev_ind)."""
    out = []
    for k, ind in enumerate(indices):
        if k == 0 and not conditional:
            prev_ind = max(ind, prev_ind - 16)
        else:
            ind_tmp = ind + _MIN_DELTA_GAIN
            thr = 2 * _MAX_DELTA_GAIN - _N_LEVELS_QGAIN + prev_ind
            if ind_tmp > thr:
                prev_ind += (ind_tmp << 1) - thr
            else:
                prev_ind += ind_tmp
        prev_ind = min(max(prev_ind, 0), _N_LEVELS_QGAIN - 1)
        log_q7 = min(((_INV_SCALE_Q16 * prev_ind) >> 16) + _GAIN_OFFSET,
                     3967)
        out.append(_log2lin(log_q7))
    return out, prev_ind


def decode_pitch(lag_index: int, contour_index: int, fs_khz: int,
                 n_subfr: int = 4) -> list:
    """Per-subframe pitch lags (silk_decode_pitch; the 10 ms frame
    codebooks have 2 rows)."""
    T = tables()
    if fs_khz == 8:
        cb = T["CB_lags_stage2" if n_subfr == 4
               else "CB_lags_stage2_10_ms"].reshape(n_subfr, -1)
    else:
        cb = T["CB_lags_stage3" if n_subfr == 4
               else "CB_lags_stage3_10_ms"].reshape(n_subfr, -1)
    min_lag, max_lag = 2 * fs_khz, 18 * fs_khz
    lag = min_lag + lag_index
    return [int(np.clip(lag + cb[k, contour_index], min_lag, max_lag))
            for k in range(n_subfr)]


def ltp_taps_q14(per_index: int, ltp_indices: list) -> np.ndarray:
    """Per-subframe 5-tap LTP filters in Q14 (decode_parameters.c)."""
    T = tables()
    cb = T[f"LTP_gain_vq_{per_index}"].reshape(-1, 5)
    return np.stack([cb[i] << 7 for i in ltp_indices])


# ---------------------------------------------------------------------------
# core synthesis (decode_core.c / decode_frame.c, float formulation)
# ---------------------------------------------------------------------------

_QUANT_LEVEL_ADJUST = 80 / 1024.0          # QUANT_LEVEL_ADJUST_Q10
_LTP_ORDER = 5


def _lcg(seed: int) -> int:
    return (907633515 + seed * 196314165) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Output resampler: internal rate (8/12/16 kHz) -> 48 kHz

_UP2_HQ = (
    # Q16 allpass coefficients, resampler_rom.h:48-50 (even/odd phase);
    # the third section's table entry stores coef-65536, folded back here.
    (1746 / 65536.0, 14986 / 65536.0, 39083 / 65536.0),
    (6854 / 65536.0, 25769 / 65536.0, 55542 / 65536.0),
)


class SilkResampler:
    """SILK output upsampler to 48 kHz: 2x upsampling through two
    cascades of three first-order allpass sections (one cascade per
    output phase, silk/resampler_private_up2_HQ.c:57-103) followed by
    12-phase 8-tap FIR fractional interpolation over the 2x grid
    (silk/resampler_private_IIR_FIR.c:45-66, table
    silk_resampler_frac_FIR_12).  Float reformulation of the Q10/Q15
    fixed-point pipeline; the index schedule (10 ms batch restart,
    rounded-up invRatio_Q16 — silk/resampler.c:111-167) is kept exact
    so output sample counts match the reference decoder's."""

    #: decoder-side input delay, silk/resampler.c delay_matrix_dec
    #: (in -> 48 kHz).  Callers without the one-sample silk_Decode
    #: output buffering (dec_API.c:379-381) add 1 on top.
    DELAY_48 = {8000: 0, 12000: 4, 16000: 7}

    def __init__(self, fs_in_hz: int, input_delay: int | None = None):
        if fs_in_hz not in (8000, 12000, 16000):
            raise ValueError(fs_in_hz)
        self._batch = (fs_in_hz // 1000) * 10
        inv = ((fs_in_hz << 15) // 48000) << 2
        while (inv * 48000) >> 16 < (fs_in_hz << 1):
            inv += 1
        self._incr = inv
        self._zi = [[np.zeros(1) for _ in range(3)] for _ in range(2)]
        self._fir_state = np.zeros(8)
        self._f12 = (tables()["resampler_frac_FIR_12"]
                     .reshape(12, 4).astype(np.float64) / 32768.0)
        self._d = (self.DELAY_48[fs_in_hz] if input_delay is None
                   else input_delay)
        self._dline = np.zeros(self._d)

    def _up2(self, x: np.ndarray) -> np.ndarray:
        from scipy.signal import lfilter
        out = np.empty(2 * len(x))
        for ph in range(2):
            y = x
            for s, a in enumerate(_UP2_HQ[ph]):
                y, self._zi[ph][s] = lfilter(
                    [a, 1.0], [1.0, a], y, zi=self._zi[ph][s])
            out[ph::2] = y
        return out

    def process(self, x: np.ndarray) -> np.ndarray:
        if self._d > 0 and len(x):
            buf = np.concatenate([self._dline, x])
            self._dline = buf[len(x):]
            x = buf[:len(x)]
        outs = []
        pos = 0
        taps = np.arange(8)
        while pos < len(x):
            n = min(self._batch, len(x) - pos)
            buf = np.concatenate(
                [self._fir_state, self._up2(x[pos:pos + n])])
            idx = np.arange(0, n << 17, self._incr, dtype=np.int64)
            ti = ((idx & 0xFFFF) * 12) >> 16
            win = buf[(idx >> 16)[:, None] + taps]
            coef = np.concatenate(
                [self._f12[ti], self._f12[11 - ti][:, ::-1]], axis=1)
            outs.append((win * coef).sum(axis=1))
            self._fir_state = buf[2 * n:2 * n + 8]
            pos += n
        if not outs:
            return np.zeros(0)
        return np.concatenate(outs)


def _have_fix() -> bool:
    """True when the native fixed-point SILK core is available and not
    disabled (OHP_SILK_FLOAT=1 forces the float fallback path)."""
    import os
    if os.environ.get("OHP_SILK_FLOAT"):
        return False
    from ... import native
    return native.have_silk_core()


#: silk/resampler_rom.h:48-50 — up2_HQ allpass coefficients as stored in
#: ROM (the third section of each phase stores coef - 65536; SMLAWB's
#: int16 wrap applies the +1 fold, resampler_private_up2_HQ.c:66,86)
_UP2_HQ_ROM = np.array([1746, 14986, 39083 - 65536,
                        6854, 25769, 55542 - 65536], np.int16)


class SilkResamplerFix:
    """Bit-exact fixed-point variant of SilkResampler
    (silk/resampler_private_IIR_FIR.c over silk/resampler_private_up2_HQ.c
    via native.silk_resampler_iir_fir); int16 in/out."""

    def __init__(self, fs_in_hz: int, input_delay: int | None = None):
        if fs_in_hz not in (8000, 12000, 16000):
            raise ValueError(fs_in_hz)
        self._batch = (fs_in_hz // 1000) * 10
        inv = ((fs_in_hz << 15) // 48000) << 2
        while (inv * 48000) >> 16 < (fs_in_hz << 1):
            inv += 1
        self._incr = inv
        self._s_iir = np.zeros(6, np.int32)
        self._s_fir = np.zeros(8, np.int16)
        self._f12 = tables()["resampler_frac_FIR_12"].astype(np.int16)
        self._d = (SilkResampler.DELAY_48[fs_in_hz] if input_delay is None
                   else input_delay)
        self._dline = np.zeros(self._d, np.int16)

    def process(self, x: np.ndarray) -> np.ndarray:
        from ... import native
        x = np.asarray(x, np.int16)
        if self._d > 0 and len(x):
            buf = np.concatenate([self._dline, x])
            self._dline = buf[len(x):].copy()
            x = buf[:len(x)]
        if not len(x):
            return np.zeros(0, np.int16)
        return native.silk_resampler_iir_fir(
            x, self._batch, self._incr, self._s_iir, self._s_fir,
            _UP2_HQ_ROM, self._f12)


class SilkStreamDecoder:
    """Stateful SILK-only mono decoder at the internal rate.  With the
    native helper built (native.have_silk_core()) synthesis runs the
    reference's fixed-point integer pipeline bit-exactly
    (silk/decode_core.c via native.silk_decode_core_fix); otherwise it
    falls back to the float reformulation below (SNR-bounded, not
    bit-exact, against the reference)."""

    def __init__(self, bw: str):
        self.bw = bw
        p = BW[bw]
        self.fs_khz = p.fs_khz
        self.order = p.lpc_order
        self.frame_len = 20 * p.fs_khz
        self.subfr_len = self.frame_len // 4
        self.ltp_mem = 20 * p.fs_khz
        self.out_buf = np.zeros(self.ltp_mem + self.frame_len)
        self.s_lpc = np.zeros(self.order)
        self.prev_gain = 1.0
        self.prev_gain_ind = 0
        self.prev_nlsf = None
        self.first = True
        self._rs = None
        self.fix = _have_fix()
        if self.fix:
            from ... import native
            # fixed-point state (decode_core.c persistent buffers)
            self._out_buf_i = np.zeros(self.ltp_mem + self.frame_len,
                                       np.int16)
            self._s_lpc_q14 = np.zeros(16, np.int32)
            self._prev_gain_q16 = np.array([65536], np.int32)
            self._last_exc = None
            # PLC/CNG bookkeeping (silk/PLC.c, CNG.c state)
            self._plc = native.SilkPlcState()

    def decode_frame_48k(self, data: bytes,
                         duration_ms: int = 20,
                         dec: RangeDecoder | None = None) -> np.ndarray:
        """One SILK packet -> float PCM at 48 kHz (int16 range),
        through the reference's output resampler chain
        (silk/resampler.c USE_silk_resampler_private_IIR_FIR with the
        delay_matrix_dec input delay + one-sample output buffering)."""
        if self._rs is None:
            # delay = resampler input delay + the one-sample output
            # buffering (dec_API.c keeps the last decoded sample in
            # sStereo.sMid[1] and feeds the resampler from &x[1]);
            # both are pure delays at the internal rate so they fold
            # into one input delay line
            cls = SilkResamplerFix if self.fix else SilkResampler
            self._rs = cls(
                self.fs_khz * 1000,
                input_delay=SilkResampler.DELAY_48[self.fs_khz * 1000]
                + 1)
        return self._rs.process(self.decode_frame(data, duration_ms,
                                                  dec=dec))

    def conceal_frame_48k(self, duration_ms: int = 20) -> np.ndarray:
        """Packet-loss concealment for one lost packet -> 48 kHz PCM
        (the opus_decode(NULL, ...) path for SILK mode)."""
        if self._rs is None:
            cls = SilkResamplerFix if self.fix else SilkResampler
            self._rs = cls(
                self.fs_khz * 1000,
                input_delay=SilkResampler.DELAY_48[self.fs_khz * 1000]
                + 1)
        n_frames = max(1, duration_ms // 20)
        n_subfr = 2 if duration_ms == 10 else 4
        x = np.concatenate([self.conceal(n_subfr)
                            for _ in range(n_frames)])
        return self._rs.process(x)

    def decode_fec_48k(self, data: bytes,
                       duration_ms: int = 20) -> np.ndarray:
        """Recover a lost packet's audio from the NEXT packet's in-band
        LBRR data (opus_decode decode_fec=1 -> silk_Decode
        FLAG_DECODE_LBRR, dec_API.c:253-279); frame slots without LBRR
        fall back to concealment (decode_frame.c FLAG_DECODE_LBRR
        without LBRR_flags -> PLC)."""
        if self._rs is None:
            cls = SilkResamplerFix if self.fix else SilkResampler
            self._rs = cls(
                self.fs_khz * 1000,
                input_delay=SilkResampler.DELAY_48[self.fs_khz * 1000]
                + 1)
        n_frames = max(1, duration_ms // 20)
        n_subfr = 2 if duration_ms == 10 else 4
        lbrr: list = []
        parse_silk_packet(data, self.bw, duration_ms=duration_ms,
                          lbrr_out=lbrr)
        while len(lbrr) < n_frames:
            lbrr.append(None)
        outs = []
        for f in lbrr[:n_frames]:
            if f is not None:
                outs.append(self.synthesise(f.indices))
            else:
                outs.append(self.conceal(n_subfr))
        return self._rs.process(np.concatenate(outs))

    def decode_frame(self, data: bytes,
                     duration_ms: int = 20,
                     dec: RangeDecoder | None = None) -> np.ndarray:
        """One SILK packet (20/40/60 ms) -> float PCM (int16 range)
        at the internal rate.  Pass `dec` to continue from a shared
        range decoder (hybrid mode)."""
        frames = parse_silk_packet(data, self.bw,
                                   duration_ms=duration_ms, dec=dec)
        return np.concatenate(
            [self.synthesise(f.indices) for f in frames])

    def synthesise(self, ix) -> np.ndarray:
        """Parsed frame indices -> PCM at the internal rate
        (silk_decode_frame over silk_decode_core; 4 subframes for
        20 ms frames, 2 for 10 ms).  Fixed-point int16 output on the
        native path, float on the fallback.  Frames parsed natively
        carry their raw index row and take the fused dequant+synthesis
        call (silk_synth.cc); Python-parsed frames dequantise here."""
        if self.fix:
            row = getattr(ix, "row", None)
            if row is not None:
                return self._synthesise_fix_row(ix, row)
            return self._synthesise_fix(ix)
        return self._synthesise_float(ix)

    def _synthesise_fix_row(self, ix, row: np.ndarray) -> np.ndarray:
        """Fused native path: one silk_synth_frame_fix call does the
        whole gains/NLSF/pitch/LTP dequant + core synthesis, with the
        inter-frame dequant state round-tripped through this object
        (single source of truth with the non-row path)."""
        from ... import native
        n_subfr = len(ix.gain_indices)
        dq, dqo = _dq_blob()
        pgi = np.array([self.prev_gain_ind], np.int32)
        pn = np.zeros(16, np.int16)
        have = np.zeros(1, np.int32)
        if self.prev_nlsf is not None:
            pn[:self.order] = self.prev_nlsf
            have[0] = 1
        xq = native.silk_synth_frame_fix(
            row, np.asarray(ix.pulses, np.int16), _BW_IDX[self.bw],
            n_subfr, self.subfr_len, self.order, self.ltp_mem,
            self.fs_khz, dq, dqo, _cos16(), pgi, pn, have,
            self._out_buf_i, self._s_lpc_q14, self._prev_gain_q16,
            self._plc)
        self.prev_gain_ind = int(pgi[0])
        self.prev_nlsf = pn[:self.order].copy()
        self._last_exc = self._plc.exc
        self.first = False
        return xq

    def _synthesise_fix(self, ix) -> np.ndarray:
        """Bit-exact integer synthesis (silk/decode_core.c via
        native.silk_decode_core_fix; parameter dequant per
        silk/decode_parameters.c)."""
        from ... import native
        T = tables()
        n_subfr = len(ix.gain_indices)
        gains_q16, self.prev_gain_ind = gains_dequant(
            ix.gain_indices, self.prev_gain_ind,
            conditional=ix.cond_coding)
        nlsf = nlsf_decode(self.bw, ix.nlsf_stage1, ix.nlsf_residuals)
        cos_tab = T["LSFCosTab_FIX_Q12"].astype(np.int16)
        a1 = native.silk_nlsf2a(nlsf, cos_tab)
        interp = ix.nlsf_interp_q2 < 4 and self.prev_nlsf is not None
        if interp:
            nlsf0 = (self.prev_nlsf.astype(np.int64)
                     + ((ix.nlsf_interp_q2
                         * (nlsf.astype(np.int64)
                            - self.prev_nlsf.astype(np.int64))) >> 2))
            a0 = native.silk_nlsf2a(nlsf0.astype(np.int16), cos_tab)
        else:
            a0 = a1
        self.prev_nlsf = nlsf
        a_both = np.zeros((2, 16), np.int16)
        a_both[0, :self.order] = a0
        a_both[1, :self.order] = a1
        voiced = ix.signal_type == 2
        if voiced:
            lags = decode_pitch(ix.lag_index, ix.contour_index,
                                self.fs_khz, n_subfr)
            b_q14 = ltp_taps_q14(ix.per_index,
                                 ix.ltp_indices).astype(np.int16)
            ltp_scale = int(T["LTPScales_table_Q14"][ix.ltp_scale_index])
        else:
            lags = [0] * n_subfr
            b_q14 = np.zeros((n_subfr, 5), np.int16)
            ltp_scale = 0
        xq = native.silk_frame_fix(
            False, np.asarray(ix.pulses, np.int16), self.subfr_len,
            n_subfr, self.order, self.ltp_mem, a_both, b_q14,
            np.asarray(gains_q16, np.int32), np.asarray(lags, np.int32),
            ltp_scale, ix.signal_type, ix.quant_offset, int(ix.seed),
            interp, nlsf, cos_tab, self.fs_khz, self._out_buf_i,
            self._s_lpc_q14, self._prev_gain_q16, self._plc)
        self._last_exc = self._plc.exc
        self.first = False
        return xq

    def conceal(self, n_subfr: int = 4) -> np.ndarray:
        """One concealed 20 ms (or 10 ms, n_subfr=2) frame of
        packet-loss extrapolation at the internal rate
        (silk/PLC.c silk_PLC_conceal + CNG + glue bookkeeping via
        native.silk_frame_fix(lost=True)); int16 on the fixed path,
        zeros on the float fallback (which has no PLC state)."""
        frame_len = n_subfr * self.subfr_len
        if not self.fix:
            return np.zeros(frame_len)
        from ... import native
        T = tables()
        cos_tab = T["LSFCosTab_FIX_Q12"].astype(np.int16)
        prev_nlsf = (self.prev_nlsf if self.prev_nlsf is not None
                     else np.zeros(self.order, np.int16))
        z16 = np.zeros(frame_len, np.int16)
        xq = native.silk_frame_fix(
            True, z16, self.subfr_len, n_subfr, self.order,
            self.ltp_mem, np.zeros((2, 16), np.int16),
            np.zeros((n_subfr, 5), np.int16),
            np.full(n_subfr, 65536, np.int32),
            np.zeros(n_subfr, np.int32), 0, 0, 0, 0, False,
            prev_nlsf, cos_tab, self.fs_khz, self._out_buf_i,
            self._s_lpc_q14, self._prev_gain_q16, self._plc)
        return xq

    def _synthesise_float(self, ix) -> np.ndarray:
        """Float-reformulation fallback of the synthesis stack (used
        when the native helper is unavailable)."""
        T = tables()
        n_subfr = len(ix.gain_indices)
        frame_len = n_subfr * self.subfr_len
        gains_q16, self.prev_gain_ind = gains_dequant(
            ix.gain_indices, self.prev_gain_ind,
            conditional=ix.cond_coding)
        gains = [g / 65536.0 for g in gains_q16]
        nlsf = nlsf_decode(self.bw, ix.nlsf_stage1, ix.nlsf_residuals)
        a1 = nlsf_to_lpc(nlsf) / 4096.0
        if ix.nlsf_interp_q2 < 4 and self.prev_nlsf is not None:
            nlsf0 = (self.prev_nlsf.astype(np.int64)
                     + ((ix.nlsf_interp_q2
                         * (nlsf.astype(np.int64)
                            - self.prev_nlsf.astype(np.int64))) >> 2))
            a0 = nlsf_to_lpc(nlsf0.astype(np.int16)) / 4096.0
            interp = True
        else:
            a0 = a1
            interp = False
        self.prev_nlsf = nlsf
        voiced = ix.signal_type == 2
        if voiced:
            lags = decode_pitch(ix.lag_index, ix.contour_index,
                                self.fs_khz, n_subfr)
            b_taps = ltp_taps_q14(ix.per_index, ix.ltp_indices) / 16384.0
            ltp_scale = int(T["LTPScales_table_Q14"][ix.ltp_scale_index]) \
                / 16384.0
        # excitation with LCG pseudo-random sign inversion
        offset = int(T["Quantization_Offsets_Q10"].reshape(2, 2)[
            ix.signal_type >> 1, ix.quant_offset]) / 1024.0
        seed = ix.seed
        exc = np.zeros(frame_len)
        for i in range(frame_len):
            seed = _lcg(seed)
            v = float(ix.pulses[i])
            if v > 0:
                v -= _QUANT_LEVEL_ADJUST
            elif v < 0:
                v += _QUANT_LEVEL_ADJUST
            v += offset
            if seed & 0x80000000:      # rand_seed < 0 as int32
                v = -v
            seed = (seed + int(ix.pulses[i])) & 0xFFFFFFFF
            exc[i] = v

        xq = np.zeros(frame_len)
        s_ltp = np.zeros(self.ltp_mem + frame_len)
        s_ltp_idx = self.ltp_mem
        s_lpc = np.concatenate([self.s_lpc, np.zeros(self.subfr_len)])
        for k in range(n_subfr):
            a = a0 if k < 2 else a1
            g = gains[k]
            gain_adj = self.prev_gain / g if g != self.prev_gain else 1.0
            if gain_adj != 1.0:
                s_lpc[:self.order] *= gain_adj
            self.prev_gain = g
            res = exc[k * self.subfr_len:(k + 1) * self.subfr_len].copy()
            if voiced:
                lag = lags[k]
                if k == 0 or (k == 2 and interp):
                    # rewhiten past output into the LTP state
                    start = self.ltp_mem - lag - self.order \
                        - _LTP_ORDER // 2 + k * self.subfr_len
                    seg = self.out_buf[start:self.ltp_mem
                                       + k * self.subfr_len]
                    white = seg.copy()
                    for j in range(self.order, len(seg)):
                        white[j] = seg[j] - np.dot(
                            a, seg[j - self.order:j][::-1])
                    inv_gain = 1.0 / g
                    if k == 0:
                        inv_gain *= ltp_scale
                    n = lag + _LTP_ORDER // 2
                    s_ltp[s_ltp_idx - n:s_ltp_idx] = \
                        white[-n:] * inv_gain
                elif gain_adj != 1.0:
                    n = lag + _LTP_ORDER // 2
                    s_ltp[s_ltp_idx - n:s_ltp_idx] *= gain_adj
                b = b_taps[k]
                for i in range(self.subfr_len):
                    p0 = s_ltp_idx + i - lag + _LTP_ORDER // 2
                    pred = float(np.dot(b, s_ltp[p0 - 4:p0 + 1][::-1]))
                    res[i] = res[i] + pred
                    s_ltp[s_ltp_idx + i] = res[i]
                s_ltp_idx += self.subfr_len
            # short-term synthesis
            for i in range(self.subfr_len):
                pred = float(np.dot(a, s_lpc[i:i + self.order][::-1]))
                s_lpc[self.order + i] = res[i] + pred
            xq[k * self.subfr_len:(k + 1) * self.subfr_len] = \
                np.clip(s_lpc[self.order:self.order + self.subfr_len] * g,
                        -32768, 32767)
            self.out_buf[self.ltp_mem + k * self.subfr_len:
                         self.ltp_mem + (k + 1) * self.subfr_len] = \
                xq[k * self.subfr_len:(k + 1) * self.subfr_len]
            s_lpc[:self.order] = s_lpc[self.subfr_len:
                                       self.subfr_len + self.order]
        self.s_lpc = s_lpc[:self.order].copy()
        self.out_buf[:self.ltp_mem] = self.out_buf[
            frame_len:frame_len + self.ltp_mem].copy()
        self.first = False
        return xq


# ---------------------------------------------------------------------------
# Stereo (mid/side) layer: silk/stereo_decode_pred.c, stereo_MS_to_LR.c
# and the silk_Decode packet flow (dec_API.c:229-440)
# ---------------------------------------------------------------------------


def stereo_decode_pred(dec: RangeDecoder) -> list:
    """Mid/side predictor indices -> pred_Q13[2]
    (silk_stereo_decode_pred; 0.5/STEREO_QUANT_SUB_STEPS in Q16 =
    6554)."""
    T = tables()
    quant = T["stereo_pred_quant_Q13"]
    n = dec.dec_icdf(_icdf(T["stereo_pred_joint_iCDF"]), 8)
    ix2 = [n // 5, n % 5]
    pred = []
    for ch in range(2):
        i0 = dec.dec_icdf(_icdf(T["uniform3_iCDF"]), 8)
        i1 = dec.dec_icdf(_icdf(T["uniform5_iCDF"]), 8)
        i0 += 3 * ix2[ch]
        low = int(quant[i0])
        step = ((int(quant[i0 + 1]) - low) * 6554) >> 16
        pred.append(low + step * (2 * i1 + 1))
    # second predictor is subtracted from the first at encode time
    pred[0] -= pred[1]
    return pred


def parse_silk_packet_stereo(data: bytes, bw: str,
                             duration_ms: int = 20,
                             dec: RangeDecoder | None = None) -> list:
    """Stereo SILK-only packet (20/40/60 ms) -> list of per-20 ms
    tuples (mid SilkFrame, side SilkFrame or None, pred_Q13[2],
    mid_only).  Symbol order per silk_Decode: per-channel VAD+LBRR
    header flags, both channels' LBRR flag symbols, LBRR data
    (decoded and discarded), then per frame: stereo predictors,
    mid-only flag (only when the side channel's VAD flag is 0), the
    mid frame, and the side frame back to back in one range coder."""
    if duration_ms not in (10, 20, 40, 60):
        raise NotImplementedError("only 10-60 ms SILK packets")
    if _use_native_parse() and (dec is None or (dec.buf is data
                                                and dec.storage
                                                == len(data))):
        from ... import native
        n_frames = max(1, duration_ms // 20)
        n_subfr = 2 if duration_ms == 10 else 4
        p = BW[bw]
        frame_length = (duration_ms // n_frames) * p.fs_khz
        blob, offs, pred_q = _parse_blob()
        st64 = _st64_from_dec(dec)
        res = native.silk_parse_packet(
            data, st64, _BW_IDX[bw], True, n_frames, n_subfr,
            frame_length, blob, offs, pred_q)
        if res is not None:
            ixs, pulses, _lbrr_ix, _lbrr_pulses, misc = res
            if dec is not None:
                _dec_from_st64(dec, st64)
            out = []
            for i in range(n_frames):
                m = 2 * i
                fm = SilkFrame(bool(ixs[m, 1]),
                               _ix_from_row(ixs[m], pulses[m], n_subfr,
                                            p.lpc_order))
                side = None
                if ixs[m + 1, 0]:
                    side = SilkFrame(bool(ixs[m + 1, 1]),
                                     _ix_from_row(ixs[m + 1],
                                                  pulses[m + 1],
                                                  n_subfr, p.lpc_order))
                out.append((fm, side,
                            [int(misc[3 * i]), int(misc[3 * i + 1])],
                            int(misc[3 * i + 2])))
            return out
    return _parse_silk_packet_stereo_py(data, bw, duration_ms, dec)


def _parse_silk_packet_stereo_py(data: bytes, bw: str,
                                 duration_ms: int = 20,
                                 dec: RangeDecoder | None = None) -> list:
    """Pure-Python stereo packet parse (behaviour oracle for the
    native path)."""
    n_frames = max(1, duration_ms // 20)
    n_subfr = 2 if duration_ms == 10 else 4
    p = BW[bw]
    frame_length = (duration_ms // n_frames) * p.fs_khz
    if dec is None:
        dec = RangeDecoder(data)
    T = tables()
    vad = []
    lbrr_bit = []
    for _ch in range(2):
        vad.append([bool(dec.dec_bit_logp(1)) for _ in range(n_frames)])
        lbrr_bit.append(dec.dec_bit_logp(1))
    lbrr = []
    for ch in range(2):
        if not lbrr_bit[ch]:
            lbrr.append([0] * n_frames)
        elif n_frames == 1:
            lbrr.append([1])
        else:
            sym = dec.dec_icdf(
                _icdf(T[f"LBRR_flags_{n_frames}_iCDF"]), 8) + 1
            lbrr.append([(sym >> i) & 1 for i in range(n_frames)])
    prev_lbrr = [{}, {}]
    for i in range(n_frames):
        for ch in range(2):
            if lbrr[ch][i]:
                if ch == 0:
                    stereo_decode_pred(dec)
                    if lbrr[1][i] == 0:
                        dec.dec_icdf(
                            _icdf(T["stereo_only_code_mid_iCDF"]), 8)
                jx = decode_frame_indices(
                    dec, bw, True, n_subfr,
                    cond_coding=bool(i > 0 and lbrr[ch][i - 1]),
                    prev=prev_lbrr[ch])
                decode_excitation(dec, jx.signal_type, jx.quant_offset,
                                  frame_length)
    prev = [{}, {}]
    out = []
    prev_mid_only = None
    for i in range(n_frames):
        pred_q13 = stereo_decode_pred(dec)
        mid_only = 0
        if not vad[1][i]:
            mid_only = dec.dec_icdf(
                _icdf(T["stereo_only_code_mid_iCDF"]), 8)
        ix_m = decode_frame_indices(dec, bw, vad[0][i], n_subfr,
                                    cond_coding=i > 0, prev=prev[0])
        ix_m.pulses = decode_excitation(dec, ix_m.signal_type,
                                        ix_m.quant_offset, frame_length)
        side = None
        if not mid_only:
            # side FrameIndex equals i (the mid channel's frame counter
            # increments before the side decode, dec_API.c:344-372):
            # frame 0 independent; later frames conditional unless the
            # previous frame was mid-only (then independent without an
            # LTP scale index)
            if i == 0:
                cond, ltp_dec = False, True
            elif prev_mid_only:
                cond, ltp_dec = False, False
            else:
                cond, ltp_dec = True, False
            ix_s = decode_frame_indices(dec, bw, vad[1][i], n_subfr,
                                        cond_coding=cond, prev=prev[1],
                                        ltp_scale_decoded=ltp_dec)
            ix_s.pulses = decode_excitation(dec, ix_s.signal_type,
                                            ix_s.quant_offset,
                                            frame_length)
            side = SilkFrame(vad[1][i], ix_s)
        prev_mid_only = mid_only
        out.append((SilkFrame(vad[0][i], ix_m), side, pred_q13,
                    mid_only))
    return out


class SilkStereoDecoder:
    """Stereo SILK-only decoder -> 48 kHz L/R (float reformulation of
    silk_Decode + silk_stereo_MS_to_LR).  Handles per-packet
    mono<->stereo switching the way the reference does: mono packets
    pass through the mid history buffer (keeping the one-sample
    buffering delay continuous), side/predictor state resets on the
    transition back to stereo, and the side core resets after
    mid-only frames (dec_API.c:303-311)."""

    def __init__(self, bw: str):
        self.bw = bw
        self.fs_khz = BW[bw].fs_khz
        self.mid = SilkStreamDecoder(bw)
        self.side = SilkStreamDecoder(bw)
        self.fix = self.mid.fix
        self._smid = np.zeros(2)
        self._sside = np.zeros(2)
        self._pred_prev = [0, 0]
        self._prev_mid_only = 0
        self._prev_stereo = False
        rs_cls = SilkResamplerFix if self.fix else SilkResampler
        self._rs = [rs_cls(self.fs_khz * 1000) for _ in range(2)]
        if self.fix:
            # stereo_dec_state (silk/structs.h): raw mid/side history,
            # previous predictors
            self._smid_i = np.zeros(2, np.int16)
            self._sside_i = np.zeros(2, np.int16)
            self._pred_prev_i = np.zeros(2, np.int32)

    def decode_packet_48k(self, data: bytes, stereo: bool,
                          duration_ms: int = 20,
                          dec: RangeDecoder | None = None) -> np.ndarray:
        """One packet frame (20/40/60 ms) -> (2, n) float PCM at
        48 kHz (int16 range; for mono packets both rows are the mid
        channel)."""
        import copy
        L = (10 if duration_ms == 10 else 20) * self.fs_khz
        if not stereo:
            x = self.mid.decode_frame(data, duration_ms, dec=dec)
            outs = []
            for off in range(0, len(x), L):
                if self.fix:
                    x1 = np.concatenate([self._smid_i,
                                         np.asarray(x[off:off + L],
                                                    np.int16)])
                    self._smid_i = x1[L:L + 2].copy()
                else:
                    x1 = np.concatenate([self._smid, x[off:off + L]])
                    self._smid = x1[L:L + 2].copy()
                outs.append(self._rs[0].process(x1[1:L + 1]))
            self._prev_stereo = False
            out = np.concatenate(outs)
            return np.stack([out, out])
        if not self._prev_stereo:
            # mono -> stereo: reset predictors/side history, clone the
            # resampler state into the right channel (dec_API.c:215-219)
            self._pred_prev = [0, 0]
            self._sside = np.zeros(2)
            if self.fix:
                self._pred_prev_i[:] = 0
                self._sside_i[:] = 0
            self._rs[1] = copy.deepcopy(self._rs[0])
        self._prev_stereo = True
        lefts, rights = [], []
        for fm, fs_, pred, mid_only in parse_silk_packet_stereo(
                data, self.bw, duration_ms, dec=dec):
            if not mid_only and self._prev_mid_only:
                self.side = SilkStreamDecoder(self.bw)
                self.side.prev_gain_ind = 10    # LastGainIndex on reset
            xm = self.mid.synthesise(fm.indices)
            xs = (self.side.synthesise(fs_.indices) if fs_ is not None
                  else np.zeros(len(xm), np.int16 if self.fix else None))
            self._prev_mid_only = mid_only
            left, right = self._ms_to_lr(xm, xs, pred)
            lefts.append(self._rs[0].process(left))
            rights.append(self._rs[1].process(right))
        return np.stack([np.concatenate(lefts), np.concatenate(rights)])

    def conceal_packet_48k(self, duration_ms: int = 20) -> np.ndarray:
        """Conceal one lost stereo packet: both cores run PLC
        (dec_API.c lost path; the side is skipped after mid-only
        frames, matching prev_decode_only_middle), then MS->LR with
        the previous predictors and per-channel resampling."""
        L = (10 if duration_ms == 10 else 20) * self.fs_khz
        n_frames = max(1, duration_ms // 20)
        n_subfr = 2 if duration_ms == 10 else 4
        lefts, rights = [], []
        for _ in range(n_frames):
            xm = self.mid.conceal(n_subfr)
            if self._prev_mid_only:
                xs = np.zeros(L, np.int16 if self.fix else None)
            else:
                xs = self.side.conceal(n_subfr)
            pred = (self._pred_prev_i.tolist() if self.fix
                    else list(self._pred_prev))
            left, right = self._ms_to_lr(xm, xs, pred)
            lefts.append(self._rs[0].process(left))
            rights.append(self._rs[1].process(right))
        return np.stack([np.concatenate(lefts),
                         np.concatenate(rights)])

    def _ms_to_lr(self, mid: np.ndarray, side: np.ndarray,
                  pred_q13: list) -> tuple[np.ndarray, np.ndarray]:
        if self.fix:
            from ... import native
            return native.silk_stereo_ms_to_lr(
                np.asarray(mid, np.int16), np.asarray(side, np.int16),
                self._smid_i, self._sside_i, self._pred_prev_i,
                np.asarray(pred_q13, np.int32), self.fs_khz)
        fs = self.fs_khz
        L = len(mid)
        x1 = np.concatenate([self._smid, mid])
        x2 = np.concatenate([self._sside, side])
        # history holds the RAW mid/side tails (buffered before the
        # prediction is applied, stereo_MS_to_LR.c:48-52)
        self._smid = x1[L:L + 2].copy()
        self._sside = x2[L:L + 2].copy()
        interp = 8 * fs                      # STEREO_INTERP_LEN_MS
        w0n, w1n = pred_q13[0] / 8192.0, pred_q13[1] / 8192.0
        w0 = np.full(L, w0n)
        w1 = np.full(L, w1n)
        ramp = np.arange(1, interp + 1) / interp
        w0[:interp] = self._pred_prev[0] / 8192.0 \
            + (w0n - self._pred_prev[0] / 8192.0) * ramp
        w1[:interp] = self._pred_prev[1] / 8192.0 \
            + (w1n - self._pred_prev[1] / 8192.0) * ramp
        self._pred_prev = list(pred_q13)
        # side + w0 * 3-tap-lowpassed mid + w1 * mid, one-sample delay
        lp = (x1[:L] + 2.0 * x1[1:L + 1] + x1[2:L + 2]) * 0.25
        s = x2[1:L + 1] + w0 * lp + w1 * x1[1:L + 1]
        m = x1[1:L + 1]
        return (np.clip(m + s, -32768, 32767),
                np.clip(m - s, -32768, 32767))
