"""Native (C++) host helpers of the port, built on demand with g++ and loaded
via ctypes.

A copy of the JAX package's loader and bindings, cut to the families the
port's paths reach: the FLAC rice-wire parser (``flac_unpack.cc``), the AAC
unpacker and zigzag wire (``aac_unpack.cc``), the SBR payload parser
(``sbr_parse.cc``), the CELT entropy core (``celt_core.cc``), the MP3 Layer
III Huffman decode (``mp3_core.cc``), the Vorbis residue walk
(``vorbis_core.cc``), the SILK packet parse and fixed-point synthesis
(``silk_core.cc``, ``silk_parse.cc``, ``silk_synth.cc``) and the ALAC
residual decode and predictor (``alac_core.cc``).  The ``.cc`` files are
byte copies of the JAX package's.  Where the JAX loader returns None for a
library that does not build, so its ``have_*`` checks read False, this one
raises, so they read True or raise.

Each library is compiled into ``ohpipeline_tpu_torch/_build/`` under a name
that carries a hash of its sources and flags, so an edited source rebuilds.
g++ writes to a temporary file in that directory, which is renamed into
place, so a concurrent process never loads a half-written library.  A build
that fails raises with g++'s output; nothing is cached for it, and no caller
is quietly sent to a Python parser.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
_BUILD = _DIR.parent.parent / "_build"
_CXX = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _load(name: str, sources: list[str],
          flags: list[str] | None = None) -> ctypes.CDLL:
    """Compile (once per content) and dlopen a helper library."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        cmd = [*_CXX, *(flags or [])]
        srcs = [_DIR / s for s in sources]
        digest = hashlib.sha1(" ".join(cmd).encode())
        for s in srcs:
            digest.update(s.name.encode() + b"\0" + s.read_bytes())
        so = _BUILD / f"lib{name}-{digest.hexdigest()[:12]}.so"
        if not so.exists():
            _BUILD.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            try:
                proc = subprocess.run([*cmd, *map(str, srcs), "-o", str(tmp)],
                                      capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed to build lib{name} "
                                       f"({' '.join(sources)}):\n"
                                       f"{proc.stderr}")
                os.replace(tmp, so)
            finally:
                tmp.unlink(missing_ok=True)
        _LIBS[name] = ctypes.CDLL(str(so))
        return _LIBS[name]


_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i16pw = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")


def _flac_lib() -> ctypes.CDLL | None:
    lib = _load("flacunpack", ["flac_unpack.cc"])
    if lib is not None and not getattr(lib, "_sigs_set", False):
        _common = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int64, ctypes.c_int,
            _i32p, _i32p, _i32p, _i32p, _i32p, _i32p, _i32p, _i64p,
            ctypes.POINTER(ctypes.c_int)]
        lib.flac_parse_group.restype = ctypes.c_int
        lib.flac_parse_group.argtypes = _common
        lib.flac_parse_group16.restype = ctypes.c_int
        lib.flac_parse_group16.argtypes = _common + [
            _i16pw, ctypes.POINTER(ctypes.c_int)]
        _u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.flac_parse_group12.restype = ctypes.c_int
        lib.flac_parse_group12.argtypes = _common + [
            _u8, _i32p, _i32p, _i32p, _i32p,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int]
        lib.flac_parse_group_zz.restype = ctypes.c_int
        lib.flac_parse_group_zz.argtypes = _common + [
            _u8, _u8, _i32p, _i32p, _i32p, _i32p,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int64]
        _i8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
        lib.flac_parse_group_rice.restype = ctypes.c_int
        lib.flac_parse_group_rice.argtypes = _common + [
            _i32p,                                    # warm
            _i32p, _i8,                               # gcur, gk
            _i32p, _i8, _i8, _i8, _i32p, _i32p,       # overflow units
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            _i32p, _i32p, _i32p,                      # const fills
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            _i32p, _i32p, _i32p,                      # escapes
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int64]
        lib._sigs_set = True
    return lib


def have_flac_unpack() -> bool:
    return _flac_lib() is not None


_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")

_AAC_TABLES_SET = False
_AAC_KEEPALIVE: list = []


def _aac_lib() -> ctypes.CDLL | None:
    lib = _load("aacunpack", ["aac_unpack.cc"])
    if lib is None:
        return None
    if not getattr(lib, "_sigs_set", False):
        lib.aac_set_tables.argtypes = [
            ctypes.c_int, ctypes.c_int, _u8p, _i32p, _i8p, ctypes.c_int,
            ctypes.c_int]
        lib.aac_set_scl_vals.argtypes = [_i16p]
        lib.aac_set_sfb.argtypes = [ctypes.c_int, _i16p, ctypes.c_int,
                                    _i16p, ctypes.c_int]
        lib.aac_parse_group.restype = ctypes.c_int
        lib.aac_parse_group.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
            _i32p, _i8p, _i32p, _i32p, _u8p, _i32p, _i32p, _f32p, _i32p]
        lib.aac_parse_group_sbr.restype = ctypes.c_int
        lib.aac_parse_group_sbr.argtypes = \
            lib.aac_parse_group.argtypes + [_u8p, _i32p, _i32p]
        lib.aac_prepare_rows.restype = ctypes.c_int
        lib.aac_prepare_rows.argtypes = [
            _i32p, _i8p, _i32p, _i32p, _u8p, _i32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _i32p,
            _i16p, _i16p, _u8p, _i32p, _u8p, _i32p,
            ctypes.c_int, ctypes.c_int,
            _i32p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            _i32p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.POINTER(ctypes.c_int)]
        lib.aac_prepare_rows_sparse.restype = ctypes.c_int
        lib.aac_prepare_rows_sparse.argtypes = [
            _i32p, _i8p, _i32p, _i32p, _u8p, _i32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _i32p,
            _u8p, _i8p, ctypes.c_int,
            _u8p, _i32p, _u8p, _i32p,
            ctypes.c_int, ctypes.c_int,
            _i32p, _i32p, _i32p,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            _i32p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            _i32p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
        lib.aac_prepare_rows_zz.restype = ctypes.c_int
        lib.aac_prepare_rows_zz.argtypes = [
            _i32p, _i8p, _i32p, _i32p, _u8p, _i32p, _i32p, _f32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _i32p,
            _u8p, _u8p, _u8p, _u8p,
            _u8p, _i32p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            _u8p, _f32p, _u8p, _i32p,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int64,
            _i32p, _i32p, _i32p,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            _i32p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
        lib.aac_parse_group_zz.restype = ctypes.c_int
        lib.aac_parse_group_zz.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
            _i32p, _i8p, _i32p, _i32p, _u8p, _i32p, _i32p, _f32p, _i32p,
            _i32p,
            _u8p, _u8p, _u8p, _u8p,
            _u8p, _i32p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            _u8p, _f32p, _u8p, _i32p,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int64,
            _i32p, _i32p, _i32p,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
            _i32p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int]
        _f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.aac_tns_group.argtypes = [
            _f64p, ctypes.c_int, _i32p, _i32p, _i32p, _f32p, ctypes.c_int]
        lib._sigs_set = True
    global _AAC_TABLES_SET
    if not _AAC_TABLES_SET:
        from ..codecs.aac import tables as T
        for cb in range(1, 12):
            lut = T.SPECTRAL_LUTS[cb]
            lens = np.ascontiguousarray(lut.lengths)
            rows = np.ascontiguousarray(lut.values.astype(np.int32))
            vals = np.ascontiguousarray(lut.vals.astype(np.int8))
            _AAC_KEEPALIVE.extend([lens, rows, vals])
            lib.aac_set_tables(cb, lut.maxlen, lens, rows, vals,
                               T.CB_DIM[cb], int(T.CB_UNSIGNED[cb]))
        scl = T.SCL_LUT
        lens = np.ascontiguousarray(scl.lengths)
        rows = np.ascontiguousarray(scl.values.astype(np.int32))
        dummy = np.zeros(1, np.int8)
        sclv = np.ascontiguousarray(scl.vals.reshape(-1).astype(np.int16))
        _AAC_KEEPALIVE.extend([lens, rows, dummy, sclv])
        lib.aac_set_tables(0, scl.maxlen, lens, rows, dummy, 1, 0)
        lib.aac_set_scl_vals(sclv)
        for ri in range(13):
            nl, ns = (int(x) for x in T.SFB_COUNTS[ri])
            lng = np.ascontiguousarray(T.SFB_LONG[ri][:nl + 1])
            sh = np.ascontiguousarray(T.SFB_SHORT[ri][:ns + 1])
            _AAC_KEEPALIVE.extend([lng, sh])
            lib.aac_set_sfb(ri, lng, nl, sh, ns)
        _AAC_TABLES_SET = True
    return lib


def have_aac_unpack() -> bool:
    return _aac_lib() is not None


SFB_SLOTS = 128  # must match aac_unpack.cc (8 groups x 15 stride + mask byte)


def aac_parse_group(buf: bytes, byte_pos: int, *, channels: int,
                    max_frames: int, out: dict = None):
    """Parse up to max_frames ADTS AAC-LC frames starting at byte_pos.

    Returns (nframes, new_byte_pos, batch) with dense arrays (R = F*C):
    ics (R,4), cb (R,120) int8, sf (R,120) i32, quant (R,1024) i32,
    msmask (F,120) u8, tnsn (R,8), tnsp (R,24,3), tnsc (R,24,12) f32,
    rate_index int.  Pass a previous call's batch as ``out`` to reuse its
    arrays (the quant buffer alone is ~1 MB per call — reuse matters on
    the bench's hot parse path).
    """
    lib = _aac_lib()
    if lib is None:
        raise RuntimeError("native aac unpacker unavailable")
    F, C = max_frames, channels
    R = F * C
    if out is not None and out["quant"].shape == (R, 1024):
        ics, cb, sf, quant = out["ics"], out["cb"], out["sf"], out["quant"]
        msmask, tnsn = out["msmask"], out["tnsn"]
        tnsp, tnsc = out["tnsp"], out["tnsc"]
    else:
        ics = np.zeros((R, 4), np.int32)
        cb = np.zeros((R, SFB_SLOTS), np.int8)
        sf = np.zeros((R, SFB_SLOTS), np.int32)
        quant = np.zeros((R, 1024), np.int32)
        msmask = np.zeros((F, SFB_SLOTS), np.uint8)
        tnsn = np.zeros((R, 8), np.int32)
        tnsp = np.zeros((R, 24, 3), np.int32)
        tnsc = np.zeros((R, 24, 12), np.float32)
    rate_index = np.zeros(1, np.int32)
    pos = ctypes.c_int64(byte_pos)
    n = lib.aac_parse_group(buf, len(buf), ctypes.byref(pos), F, C,
                            ics, cb, sf, quant, msmask, tnsn,
                            tnsp.reshape(-1), tnsc.reshape(-1), rate_index)
    batch = dict(ics=ics, cb=cb, sf=sf, quant=quant, msmask=msmask,
                 tnsn=tnsn, tnsp=tnsp, tnsc=tnsc,
                 rate_index=int(rate_index[0]))
    return n, pos.value, batch


SBR_STRIDE = 272  # must match aac_unpack.cc (max FIL payload 269 bytes)


def aac_parse_group_sbr(buf: bytes, byte_pos: int, *, channels: int,
                        max_frames: int, out: dict = None):
    """aac_parse_group that also captures EXT_SBR_DATA(_CRC) fill
    payloads: batch gains ``sbr`` = list of (payload_bytes, nbits, crc)
    or None per frame, the exact triple bitstream.parse_raw_data_block
    produces (HE-AAC path; reference CAacDecoder_DecodeFrame feeds the
    same fill payloads to libSBRdec)."""
    lib = _aac_lib()
    if lib is None:
        raise RuntimeError("native aac unpacker unavailable")
    F, C = max_frames, channels
    R = F * C
    if out is not None and out["quant"].shape == (R, 1024):
        ics, cb, sf, quant = out["ics"], out["cb"], out["sf"], out["quant"]
        msmask, tnsn = out["msmask"], out["tnsn"]
        tnsp, tnsc = out["tnsp"], out["tnsc"]
        sbr_bytes, sbr_nbits, sbr_crc = (out["_sbr_bytes"],
                                         out["_sbr_nbits"],
                                         out["_sbr_crc"])
    else:
        ics = np.zeros((R, 4), np.int32)
        cb = np.zeros((R, SFB_SLOTS), np.int8)
        sf = np.zeros((R, SFB_SLOTS), np.int32)
        quant = np.zeros((R, 1024), np.int32)
        msmask = np.zeros((F, SFB_SLOTS), np.uint8)
        tnsn = np.zeros((R, 8), np.int32)
        tnsp = np.zeros((R, 24, 3), np.int32)
        tnsc = np.zeros((R, 24, 12), np.float32)
        sbr_bytes = np.zeros((F, SBR_STRIDE), np.uint8)
        sbr_nbits = np.zeros(F, np.int32)
        sbr_crc = np.zeros(F, np.int32)
    rate_index = np.zeros(1, np.int32)
    pos = ctypes.c_int64(byte_pos)
    n = lib.aac_parse_group_sbr(
        buf, len(buf), ctypes.byref(pos), F, C, ics, cb, sf, quant,
        msmask, tnsn, tnsp.reshape(-1), tnsc.reshape(-1), rate_index,
        sbr_bytes, sbr_nbits, sbr_crc)
    sbr = [(sbr_bytes[f, :(int(sbr_nbits[f]) + 7) // 8].tobytes(),
            int(sbr_nbits[f]), bool(sbr_crc[f]))
           if sbr_nbits[f] > 0 else None
           for f in range(n)]
    batch = dict(ics=ics, cb=cb, sf=sf, quant=quant, msmask=msmask,
                 tnsn=tnsn, tnsp=tnsp, tnsc=tnsc,
                 rate_index=int(rate_index[0]), sbr=sbr,
                 _sbr_bytes=sbr_bytes, _sbr_nbits=sbr_nbits,
                 _sbr_crc=sbr_crc)
    return n, pos.value, batch


class EscapeList:
    """Shared (row, pos, val) escape triples for one step's slabs."""

    def __init__(self, cap: int):
        self.cap = cap
        self.row = np.full(cap, -1, np.int32)
        self.pos = np.zeros(cap, np.int32)
        self.val = np.zeros(cap, np.int32)
        self.count = ctypes.c_int32(0)

    def reset(self):
        self.row[:] = -1
        self.count.value = 0


class ShortSfPool:
    """Pooled per-coefficient scalefactor bytes for short-window rows
    (the long-window per-band wire can't express their grouping)."""

    def __init__(self, cap: int):
        self.cap = cap
        self.sf = np.zeros((cap, 1024), np.uint8)
        self.row = np.full(cap, -1, np.int32)
        self.count = ctypes.c_int32(0)

    def reset(self):
        self.row[:] = -1
        self.count.value = 0


class TnsPool:
    """Pooled TNS conditioning planes for device-side filtering: per
    pooled row a per-coefficient filter-slot plane (tfi, u8 x1024,
    slot+1 or 0), direct-form coefficients (tco, f32 x24x12), downward
    flags (tdir, u8 x24) and the flat device row (trow)."""

    def __init__(self, cap: int):
        self.cap = cap
        self.tfi = np.zeros((cap, 1024), np.uint8)
        self.tco = np.zeros((cap, 24, 12), np.float32)
        self.tdir = np.zeros((cap, 24), np.uint8)
        self.row = np.full(cap, -1, np.int32)
        self.count = ctypes.c_int32(0)

    def reset(self):
        self.row[:] = -1
        self.count.value = 0


def aac_prepare_rows_zz(batch: dict, nframes: int, F: int, channels: int,
                        prev_shape: np.ndarray, esc: EscapeList,
                        ssf: "ShortSfPool", *,
                        q4: np.ndarray, sfb: np.ndarray, msb: np.ndarray,
                        opx: np.ndarray, col0: int, row_base: int = 0,
                        max_special: int = 64,
                        tns: "TnsPool | None" = None):
    """Zigzag-nibble wire variant (gather-free device decode): quantized
    coefficients land at their spectral positions as zigzag nibbles in
    ``q4`` (rows x 512 u8); long-window scalefactors go per band to
    ``sfb`` (rows x 64 u8, expanded per coefficient on device with a
    one-hot matmul) while short-window rows pool per-coefficient bytes in
    ``ssf``; M/S flags become a per-coefficient bitmask ``msb`` (pairs x
    128 u8, LSB-first) and the window-operator index goes to ``opx``
    (rows u8).  |q| > 7 values become escape triples with the row offset
    ``row_base`` added (also applied to ``ssf`` row indices).

    With a ``tns`` pool, TNS-only rows emit device-side filter
    conditioning (masked frequency-scan planes, applied by
    synthesis.decode_chunk_zz) instead of becoming special rows;
    without one a zero-capacity pool forces them onto the special/side
    path as before.  Returns special (frame*C + channel) row flags or
    None on overflow."""
    lib = _aac_lib()
    SC = q4.shape[1] if q4.ndim == 3 else q4.shape[0] // F
    special = np.zeros(max_special, np.int32)
    n_special = ctypes.c_int32(0)
    if tns is None:
        tns = TnsPool(0)
    rc = lib.aac_prepare_rows_zz(
        np.ascontiguousarray(batch["ics"]),
        np.ascontiguousarray(batch["cb"]),
        np.ascontiguousarray(batch["sf"]),
        np.ascontiguousarray(batch["quant"]),
        np.ascontiguousarray(batch["msmask"]),
        np.ascontiguousarray(batch["tnsn"]),
        np.ascontiguousarray(batch["tnsp"]).reshape(-1),
        np.ascontiguousarray(batch["tnsc"]).reshape(-1),
        nframes, F, channels, batch["rate_index"], prev_shape,
        q4.reshape(-1), sfb.reshape(-1), msb.reshape(-1), opx.reshape(-1),
        ssf.sf.reshape(-1), ssf.row, ctypes.byref(ssf.count), ssf.cap,
        tns.tfi.reshape(-1), tns.tco.reshape(-1), tns.tdir.reshape(-1),
        tns.row, ctypes.byref(tns.count), tns.cap,
        SC, col0, row_base,
        esc.row, esc.pos, esc.val, ctypes.byref(esc.count), esc.cap,
        special, ctypes.byref(n_special), max_special)
    if rc != 0:
        return None
    return special[:n_special.value]


class RiceOverflow:
    """Overflow units for the rice wire (flac_parse_group_rice):
    partial/unaligned unit runs the grid planes can't hold — bit cursor,
    rice parameter (or raw width), mode (0 rice / 1 verbatim), sample
    count (<= 64), global destination row and position."""

    def __init__(self, cap: int):
        self.cap = cap
        self.cur = np.zeros(cap, np.int32)
        self.k = np.zeros(cap, np.int8)
        self.mode = np.zeros(cap, np.int8)
        self.cnt = np.zeros(cap, np.int8)
        self.row = np.full(cap, -1, np.int32)
        self.pos = np.zeros(cap, np.int32)
        self.count = ctypes.c_int32(0)

    def reset(self):
        self.row[:] = -1
        self.count.value = 0


class RiceConstFill:
    """Constant-subframe fills for the rice wire: (global row, value,
    blocksize) triples the device broadcasts into the residual plane."""

    def __init__(self, cap: int):
        self.cap = cap
        self.row = np.full(cap, -1, np.int32)
        self.val = np.zeros(cap, np.int32)
        self.n = np.zeros(cap, np.int32)
        self.count = ctypes.c_int32(0)

    def reset(self):
        self.row[:] = -1
        self.count.value = 0


def flac_parse_group_rice(buf: bytes, bit_pos: int, gcur: np.ndarray,
                          gk: np.ndarray, warm: np.ndarray,
                          scratch: np.ndarray, over: RiceOverflow,
                          cfill: RiceConstFill, esc: EscapeList,
                          row0: int, *,
                          sample_rate: int, bits_per_sample: int,
                          max_blocksize: int, channels: int,
                          max_frames: int, check_crc16: bool = True):
    """flac_parse_group for the rice wire: the entropy-coded stream bytes
    themselves ship to the device (caller copies buf[byte0:byte1] into its
    slab; cursors are bit offsets relative to byte0) and the device
    decodes the rice codes (codecs/flac/rice_jax.decode_units).  ``gcur``/
    ``gk`` are (B, stride//64) planes of per-aligned-unit cursors and rice
    parameters (gk = -1 marks an empty slot); partial units go to
    ``over``, constant subframes to ``cfill``, over-window codewords to
    ``esc`` (all using global rows offset by row0).  Returns
    (nframes, new_bit_pos, status, batch, (byte0, byte1))."""
    lib = _flac_lib()
    if lib is None:
        raise RuntimeError("native flac unpacker unavailable")
    if max_blocksize % 64:
        raise ValueError("flac_parse_group_rice requires a 64-multiple "
                         "max_blocksize")
    stride = max_blocksize
    B = max_frames * channels
    coeffs = np.zeros((B, 32), np.int32)
    shift = np.zeros(B, np.int32)
    order = np.zeros(B, np.int32)
    wasted = np.zeros(B, np.int32)
    assign = np.zeros(max_frames, np.int32)
    blocksize = np.zeros(max_frames, np.int32)
    sample_number = np.zeros(max_frames, np.int64)
    pos = ctypes.c_int64(bit_pos)
    status = ctypes.c_int(0)
    n = lib.flac_parse_group_rice(
        buf, len(buf), ctypes.byref(pos), sample_rate, bits_per_sample,
        max_blocksize, channels, max_frames, stride, int(check_crc16),
        scratch, coeffs, shift, order, wasted, assign, blocksize,
        sample_number, ctypes.byref(status),
        warm.reshape(-1), gcur.reshape(-1), gk.reshape(-1),
        over.cur, over.k, over.mode, over.cnt, over.row, over.pos,
        ctypes.byref(over.count), over.cap,
        cfill.row, cfill.val, cfill.n, ctypes.byref(cfill.count), cfill.cap,
        esc.row, esc.pos, esc.val, ctypes.byref(esc.count), esc.cap, row0)
    batch = dict(coeffs=coeffs, shift=shift, order=order, wasted=wasted,
                 assign=assign, blocksize=blocksize,
                 sample_number=sample_number, data=scratch)
    byte0 = bit_pos >> 3
    byte1 = (pos.value + 7) >> 3
    return n, pos.value, status.value, batch, (byte0, byte1)


def aac_tns_group(specs: np.ndarray, batch: dict, nrows: int) -> None:
    """In-place TNS filtering over (R, 1024) float64 spectra."""
    lib = _aac_lib()
    lib.aac_tns_group(specs, nrows,
                      np.ascontiguousarray(batch["ics"][:nrows]),
                      np.ascontiguousarray(batch["tnsn"][:nrows]),
                      np.ascontiguousarray(batch["tnsp"][:nrows]).reshape(-1),
                      np.ascontiguousarray(batch["tnsc"][:nrows]).reshape(-1),
                      batch["rate_index"])


def flac_parse_group(buf: bytes, bit_pos: int, *, sample_rate: int,
                     bits_per_sample: int, max_blocksize: int, channels: int,
                     max_frames: int, check_crc16: bool = True):
    """Parse up to `max_frames` FLAC frames from `buf` starting at bit_pos.

    Returns (nframes, new_bit_pos, status, batch) where batch is a dict of
    the dense arrays consumed by codecs.flac.synthesise-style device calls:
    data (B, stride) int32, coeffs (B, 32), shift/order/wasted (B,),
    assign/blocksize (F,), sample_number (F,) int64.  B = F * channels.
    """
    lib = _flac_lib()
    if lib is None:
        raise RuntimeError("native flac unpacker unavailable")
    stride = max_blocksize
    B = max_frames * channels
    data = np.zeros((B, stride), np.int32)
    coeffs = np.zeros((B, 32), np.int32)
    shift = np.zeros(B, np.int32)
    order = np.zeros(B, np.int32)
    wasted = np.zeros(B, np.int32)
    assign = np.zeros(max_frames, np.int32)
    blocksize = np.zeros(max_frames, np.int32)
    sample_number = np.zeros(max_frames, np.int64)
    pos = ctypes.c_int64(bit_pos)
    status = ctypes.c_int(0)
    n = lib.flac_parse_group(
        buf, len(buf), ctypes.byref(pos), sample_rate, bits_per_sample,
        max_blocksize, channels, max_frames, stride, int(check_crc16),
        data, coeffs, shift, order, wasted, assign, blocksize, sample_number,
        ctypes.byref(status))
    batch = dict(data=data, coeffs=coeffs, shift=shift, order=order,
                 wasted=wasted, assign=assign, blocksize=blocksize,
                 sample_number=sample_number)
    return n, pos.value, status.value, batch


# ------------------------------------------------------------------------
# CELT entropy-layer core (celt_core.cc) — range decoder + coarse/fine
# energy + allocation + PVQ band decode + anti-collapse, everything
# between RangeDecoder init and MDCT synthesis.  codecs.opus.celt uses
# this when available; its pure-Python path remains the fallback/oracle
# (OHP_CELT_PY=1 forces it).

_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")


def _celt_lib() -> ctypes.CDLL | None:
    # -ffp-contract=off: the float32 energy recursions must round every
    # op like numpy does (no FMA contraction)
    lib = _load("celtcore", ["celt_core.cc"], flags=["-ffp-contract=off"])
    if lib is not None and not getattr(lib, "_celt_ready", False):
        lib.celt_entropy_decode.restype = ctypes.c_int
        lib.celt_entropy_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int,            # data, storage
            _i64p,                                    # rd state
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,                             # C, LM, start, end, loss
            _i32p, ctypes.c_int, ctypes.c_int,        # ebands, nb, eff
            _u8p, ctypes.c_int, _i32p,                # alloc_vectors, nvec, logn
            _i32p, _u8p, _u8p, ctypes.c_int,          # cache_*, short_mdct
            _f32p, _f32p, _f32p,                      # old_ebands, logE, logE2
            _u32p,                                    # seed io
            _f64p, _i32p, _f64p,                      # X, flags, pf_gain
        ]
        lib.celt_deemphasis.restype = None
        lib.celt_deemphasis.argtypes = [
            _f64p, _f64p, ctypes.c_int, ctypes.c_double, _f64p]
        lib.celt_comb_filter.restype = None
        lib.celt_comb_filter.argtypes = [
            _f64p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_int, ctypes.c_int,
            _f64p, ctypes.c_int]
        lib._celt_ready = True
    return lib


def celt_deemphasis(x: np.ndarray, coef0: float, mem: float):
    """First-order deemphasis (celt.py decode_frame tail); returns
    (pcm, new_mem)."""
    lib = _celt_lib()
    pcm = np.empty(len(x), np.float64)
    m = np.array([mem], np.float64)
    lib.celt_deemphasis(np.ascontiguousarray(x, np.float64), pcm,
                        len(x), coef0, m)
    return pcm, float(m[0])


def celt_comb_filter(x: np.ndarray, off: int, T0: int, T1: int, n: int,
                     g0: float, g1: float, tapset0: int, tapset1: int,
                     window: np.ndarray, overlap: int) -> None:
    """In-place comb post-filter over x[off:off+n] (celt.py
    _comb_filter)."""
    lib = _celt_lib()
    lib.celt_comb_filter(x, off, T0, T1, n, g0, g1, tapset0, tapset1,
                         window, overlap)


def have_celt_core() -> bool:
    return _celt_lib() is not None


def _celt_mode_tables(mode) -> dict:
    tabs = getattr(mode, "_native_tabs", None)
    if tabs is None:
        tabs = {
            "ebands": np.ascontiguousarray(mode.ebands, np.int32),
            "alloc_vectors": np.ascontiguousarray(mode.alloc_vectors,
                                                  np.uint8),
            "logn": np.ascontiguousarray(mode.logn, np.int32),
            "cache_index": np.ascontiguousarray(mode.cache_index,
                                                np.int32),
            "cache_bits": np.ascontiguousarray(mode.cache_bits, np.uint8),
            "cache_caps": np.ascontiguousarray(mode.cache_caps, np.uint8),
        }
        mode._native_tabs = tabs
    return tabs


def celt_entropy_decode(data: bytes, rd_state, channels: int, lm: int,
                        start: int, end: int, loss_duration: int, mode,
                        old_ebands: np.ndarray, old_logE: np.ndarray,
                        old_logE2: np.ndarray, seed: int):
    """Run the CELT entropy layer natively.

    rd_state: None for a fresh RangeDecoder over `data`, else a dict of
    the Python RangeDecoder's fields (hybrid-mode handoff).  Returns
    (X, silence, is_transient, pf_pitch, pf_gain, pf_tapset,
    anti_collapse_on, seed_out, rd_state_out) or None when the native
    leaf hit an error (caller falls back to the Python path).
    Mutates old_ebands in place (like the Python path).
    """
    lib = _celt_lib()
    if lib is None:
        return None
    t = _celt_mode_tables(mode)
    st64 = np.zeros(10, np.int64)
    if rd_state is not None:
        st64[0] = 1
        st64[1] = rd_state["offs"]
        st64[2] = rd_state["end_offs"]
        st64[3] = rd_state["end_window"]
        st64[4] = rd_state["nend_bits"]
        st64[5] = rd_state["nbits_total"]
        st64[6] = rd_state["rng"]
        st64[7] = rd_state["rem"]
        st64[8] = rd_state["val"]
        st64[9] = rd_state["error"]
    n = (1 << lm) * mode.short_mdct_size
    X = np.zeros(channels * n, np.float64)
    flags = np.zeros(6, np.int32)
    pf_gain = np.zeros(1, np.float64)
    seed_io = np.array([seed & 0xFFFFFFFF], np.uint32)
    rc = lib.celt_entropy_decode(
        data, len(data), st64, channels, lm, start, end, loss_duration,
        t["ebands"], mode.nb_ebands, mode.eff_ebands,
        t["alloc_vectors"], mode.alloc_vectors.shape[0], t["logn"],
        t["cache_index"], t["cache_bits"], t["cache_caps"],
        mode.short_mdct_size,
        old_ebands, old_logE, old_logE2, seed_io, X, flags, pf_gain)
    if rc != 0:
        return None
    rd_out = {
        "offs": int(st64[1]), "end_offs": int(st64[2]),
        "end_window": int(st64[3]), "nend_bits": int(st64[4]),
        "nbits_total": int(st64[5]), "rng": int(st64[6]),
        "rem": int(st64[7]), "val": int(st64[8]), "error": int(st64[9]),
    }
    return (X, int(flags[0]), int(flags[1]), int(flags[2]),
            float(pf_gain[0]), int(flags[3]), int(flags[4]),
            int(seed_io[0]), rd_out)


# ---------------------------------------------------------------------------
# SBR payload parse (sbr_parse.cc): the bit-serial LP layer of HE-AAC's
# SBR extension in one native call per frame.  Python's parse_sbr_data
# (codecs/aac/sbr.py) stays the oracle/fallback; tests assert
# field-exact agreement.

_SBR_BOOK_IDS = ("huff_EnvLevel10T", "huff_EnvLevel10F",
                 "huff_EnvLevel11T", "huff_EnvLevel11F",
                 "huff_EnvBalance10T", "huff_EnvBalance10F",
                 "huff_EnvBalance11T", "huff_EnvBalance11F",
                 "huff_NoiseLevel11T", "huff_NoiseBalance11T")
_SBR_MAXENV, _SBR_MAXB, _SBR_MAXQ = 5, 64, 8
_sbr_books_keep: list = []      # keep injected arrays alive


def _sbr_lib() -> ctypes.CDLL | None:
    lib = _load("sbrparse", ["sbr_parse.cc"])
    if lib is None:
        return None
    if not getattr(lib, "_sigs_set", False):
        lib.sbr_set_book.argtypes = [ctypes.c_int, _i32p, ctypes.c_int]
        lib.sbr_parse_payload.restype = ctypes.c_int
        # array args as raw pointers: the per-payload call rate is high
        # (one per frame) and ndpointer from_param conversion of 17
        # array args dominated the wrapper cost — pointers come from a
        # reused per-thread scratch whose addresses are computed once
        lib.sbr_parse_payload.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int] \
            + [ctypes.c_void_p] * 16
        from ..codecs.aac.sbr import tables as _sbr_tables
        T = _sbr_tables()
        for i, name in enumerate(_SBR_BOOK_IDS):
            tree = np.ascontiguousarray(T[name].astype(np.int32))
            _sbr_books_keep.append(tree)
            lib.sbr_set_book(i, tree, tree.shape[0])
        lib._sigs_set = True
    return lib


def have_sbr_parse() -> bool:
    return _sbr_lib() is not None


_SBR_TLS = threading.local()


def _sbr_scratch() -> dict:
    """Per-thread reused in/out arrays for sbr_parse_payload with their
    raw addresses computed once — the consumer (_parse_payload_native)
    copies every row it keeps, so reuse across calls is safe."""
    sc = getattr(_SBR_TLS, "sbr", None)
    if sc is None:
        arrs = dict(
            pe=np.zeros((2, _SBR_MAXB), np.int32),
            pel=np.zeros(2, np.int32),
            pr=np.ones(2, np.int32),
            pn=np.zeros((2, _SBR_MAXQ), np.int32),
            pnh=np.zeros(2, np.int32),
            grid=np.zeros((2, 32), np.int32),
            df_env=np.zeros((2, _SBR_MAXENV), np.int32),
            df_noise=np.zeros((2, 2), np.int32),
            invf=np.zeros((2, _SBR_MAXQ), np.int32),
            env=np.zeros((2, _SBR_MAXENV, _SBR_MAXB), np.int32),
            noise=np.zeros((2, 2, _SBR_MAXQ), np.int32),
            add_harm=np.zeros((2, _SBR_MAXB), np.int32),
            ps_bits=np.zeros(2, np.int64),
            coupling=np.zeros(1, np.int32))
        sc = {"a": arrs,
              "p": {k: v.ctypes.data for k, v in arrs.items()}}
        _SBR_TLS.sbr = sc
    return sc


def sbr_parse_payload(payload: bytes, start_bit: int, nbits: int, *,
                      stereo: bool, amp_res: int, n_q: int, n_low: int,
                      n_high: int, idx_h2l: np.ndarray,
                      idx_l2h: np.ndarray, prev_state: list):
    """One SBR payload (after crc + header flag) -> dict of dense
    arrays, or None on parse failure (caller falls back to Python
    without any state having been touched).

    prev_state mirrors sbr.py's _parse_prev: per channel None or
    (env_row, freq_res, noise_row).  The returned arrays are REUSED
    per-thread scratch — copy anything kept beyond the next call (the
    sbr.py consumer already copies every row it stores)."""
    lib = _sbr_lib()
    if lib is None:
        return None
    sc = _sbr_scratch()
    a, p = sc["a"], sc["p"]
    pe, pel, pr, pn, pnh = a["pe"], a["pel"], a["pr"], a["pn"], a["pnh"]
    pe.fill(0)
    pel.fill(0)
    pr.fill(1)
    pn.fill(0)
    pnh.fill(0)
    for i in range(2):
        stt = prev_state[i] if prev_state and i < len(prev_state) else None
        if stt is not None:
            env_row, res, noise_row = stt
            if env_row is not None:
                n = min(len(env_row), _SBR_MAXB)
                pe[i, :n] = np.asarray(env_row, np.int32)[:n]
                pel[i] = n
            pr[i] = int(res)
            if noise_row is not None:
                nn = min(len(noise_row), _SBR_MAXQ)
                pn[i, :nn] = np.asarray(noise_row, np.int32)[:nn]
                pnh[i] = 1
    for k in ("grid", "df_env", "df_noise", "invf", "env", "noise",
              "add_harm", "ps_bits", "coupling"):
        a[k].fill(0)
    if idx_h2l.dtype != np.int32 or not idx_h2l.flags.c_contiguous:
        idx_h2l = np.ascontiguousarray(idx_h2l, np.int32)
    if idx_l2h.dtype != np.int32 or not idx_l2h.flags.c_contiguous:
        idx_l2h = np.ascontiguousarray(idx_l2h, np.int32)
    ok = lib.sbr_parse_payload(
        payload, nbits, start_bit, int(stereo), int(amp_res),
        n_q, n_low, n_high,
        idx_h2l.ctypes.data, idx_l2h.ctypes.data,
        p["pe"], p["pel"], p["pr"], p["pn"], p["pnh"],
        p["grid"], p["df_env"], p["df_noise"], p["invf"], p["env"],
        p["noise"], p["add_harm"], p["ps_bits"], p["coupling"])
    if ok != 1:
        return None
    return {"grid": a["grid"], "df_env": a["df_env"],
            "df_noise": a["df_noise"], "invf": a["invf"],
            "env": a["env"], "noise": a["noise"],
            "add_harm": a["add_harm"], "ps_bits": a["ps_bits"],
            "coupling": bool(a["coupling"][0])}


# ---------------------------------------------------------------------------
# MP3 Layer III Huffman spectrum decode (mp3_core.cc); the Python walk
# ``parse_huffman_py`` in codecs/mp3/bitstream.py is its oracle.

_MP3_TABLES_SET = False
_MP3_KEEPALIVE: list = []


def _mp3_lib() -> ctypes.CDLL:
    lib = _load("mp3core", ["mp3_core.cc"])
    if not getattr(lib, "_sigs_set", False):
        lib.mp3_set_pair_table.argtypes = [
            ctypes.c_int, ctypes.c_int, _u8p, _i32p, _i8p, ctypes.c_int]
        lib.mp3_set_quad_table.argtypes = [
            ctypes.c_int, ctypes.c_int, _u8p, _i32p, _i8p]
        lib.mp3_parse_huffman.restype = ctypes.c_int
        lib.mp3_parse_huffman.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _i32p]
        lib._sigs_set = True
    global _MP3_TABLES_SET
    with _LOCK:
        if not _MP3_TABLES_SET:
            from ..codecs.mp3 import tables as MT
            for tid, lut in MT.PAIR_LUTS.items():
                lens = np.ascontiguousarray(lut.lengths)
                rows = np.ascontiguousarray(lut.rows)
                vals = np.ascontiguousarray(
                    np.asarray(lut.vals).reshape(-1).astype(np.int8))
                _MP3_KEEPALIVE.extend([lens, rows, vals])
                lib.mp3_set_pair_table(tid, lut.maxlen, lens, rows, vals,
                                       int(MT.PAIR_LINBITS[tid]))
            for which, lut in enumerate(MT.QUAD_LUTS):
                lens = np.ascontiguousarray(lut.lengths)
                rows = np.ascontiguousarray(lut.rows)
                vals = np.ascontiguousarray(
                    np.asarray(lut.vals).reshape(-1).astype(np.int8))
                _MP3_KEEPALIVE.extend([lens, rows, vals])
                lib.mp3_set_quad_table(which, lut.maxlen, lens, rows, vals)
            _MP3_TABLES_SET = True
    return lib


def have_mp3_core() -> bool:
    return _mp3_lib() is not None


def mp3_parse_huffman(data: bytes, bit_pos: int, end_bit: int, big: int,
                      region1: int, region2: int, tsel: tuple,
                      count1table: int) -> tuple:
    """(spectrum int32[576], new_bit_pos); EOFError/ValueError on
    malformed data, mirroring the Python walk."""
    lib = _mp3_lib()
    out = np.zeros(576, np.int32)
    pos = ctypes.c_int64(bit_pos)
    rc = lib.mp3_parse_huffman(
        data, len(data) * 8, ctypes.byref(pos), end_bit, big,
        region1, region2, int(tsel[0]), int(tsel[1]), int(tsel[2]),
        count1table, out)
    if rc == -1:
        raise EOFError("bitstream exhausted")
    if rc == -2:
        raise ValueError("bad mp3 huffman code")
    return out, pos.value


# ---------------------------------------------------------------------------
# Vorbis residue walk (vorbis_core.cc); the Python walk in
# codecs/vorbis/residue.py (``native=None``) is its oracle.

def _vorbis_lib() -> ctypes.CDLL:
    lib = _load("vorbiscore", ["vorbis_core.cc"])
    if not getattr(lib, "_sigs_set", False):
        lib.vorbis_ctx_create.restype = ctypes.c_void_p
        lib.vorbis_ctx_create.argtypes = [
            ctypes.c_int32, _i32p, _i32p, _u8p, _u8p, _f64p]
        lib.vorbis_ctx_destroy.restype = None
        lib.vorbis_ctx_destroy.argtypes = [ctypes.c_void_p]
        lib.vorbis_residue_decode.restype = ctypes.c_int32
        lib.vorbis_residue_decode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, _i32p, ctypes.c_int32,
            _u8p, _f64p, ctypes.c_int64]
        lib._sigs_set = True
    return lib


def have_vorbis_core() -> bool:
    return _vorbis_lib() is not None


class VorbisNativeCtx:
    """Native codebook set for one Vorbis stream (residue decode).

    Serialises every parsed codebook (lengths -> canonical Huffman LUT
    rebuilt in C++, VQ value tables as float64) once per stream; per
    packet, `residue_decode` runs the full spec §8.6 partition walk in
    C++ and advances the caller's bit position.  ``ok`` is False when the
    core refused the codebooks.
    """

    def __init__(self, codebooks):
        self._lib = _vorbis_lib()
        self._handle = None
        n = len(codebooks)
        dims = np.array([b.dims for b in codebooks], np.int32)
        entries = np.array([b.entries for b in codebooks], np.int32)
        lengths = np.concatenate(
            [np.asarray(b.lengths, np.uint8) for b in codebooks]) \
            if n else np.zeros(0, np.uint8)
        has_vec = np.array(
            [1 if b.vectors is not None else 0 for b in codebooks],
            np.uint8)
        vecs = [np.ascontiguousarray(b.vectors, np.float64).ravel()
                for b in codebooks if b.vectors is not None]
        vec_cat = (np.concatenate(vecs) if vecs
                   else np.zeros(0, np.float64))
        h = self._lib.vorbis_ctx_create(
            n, np.ascontiguousarray(dims), np.ascontiguousarray(entries),
            np.ascontiguousarray(lengths), np.ascontiguousarray(has_vec),
            vec_cat)
        self._handle = h or None

    @property
    def ok(self) -> bool:
        return self._handle is not None

    def residue_decode(self, data_padded: bytes, nbits: int, bitpos: int,
                       kind: int, begin: int, end: int, psize: int,
                       classifications: int, classbook: int,
                       res_books: np.ndarray, dnd: np.ndarray,
                       out: np.ndarray, n: int):
        """-> (status, new_bitpos); status 0 ok/EOP, 2/3 VorbisError."""
        pos = ctypes.c_int64(bitpos)
        rc = self._lib.vorbis_residue_decode(
            self._handle, data_padded, nbits, ctypes.byref(pos), kind,
            begin, end, psize, classifications, classbook, res_books,
            out.shape[0], dnd, out, n)
        return rc, pos.value

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib is not None:
            self._lib.vorbis_ctx_destroy(self._handle)
            self._handle = None


# ---------------------------------------------------------------------------
# SILK fixed-point synthesis core (silk_core.cc) — bit-exact integer
# pipeline for the normative SILK decoder arithmetic (decode_core.c,
# NLSF2A.c, resampler, stereo_MS_to_LR.c).  codecs/opus/silk.py takes
# these unless OHP_SILK_PY / OHP_SILK_FLOAT force its Python oracle.


def _silk_lib() -> ctypes.CDLL | None:
    lib = _load("silkcore", ["silk_core.cc", "silk_parse.cc",
                             "silk_synth.cc"])
    if lib is not None and not getattr(lib, "_sigs_set", False):
        lib.silk_synth_frame_fix.restype = ctypes.c_int
        lib.silk_synth_frame_fix.argtypes = [
            _i32p, _i16p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            _i32p, _i32p, _i16p,
            _i32p, _i16p, _i32p,
            _i16p, _i32p, _i32p, _i32p, _i32p, _i16p, _i32p, _i16p,
            _i32p, _i16p]
        lib.silk_parse_packet.restype = ctypes.c_int
        lib.silk_parse_packet.argtypes = [
            ctypes.c_char_p, ctypes.c_int, _i64p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            _i32p, _i32p, _i32p, _i16p, _i32p, _i16p, _i32p]
        lib.silk_nlsf2a.restype = None
        lib.silk_nlsf2a.argtypes = [_i16p, ctypes.c_int, _i16p, _i16p]
        lib.silk_decode_core_fix.restype = ctypes.c_int
        lib.silk_decode_core_fix.argtypes = [
            _i16p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _i16p, _i16p, _i32p, _i32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int32,
            ctypes.c_int, _i16p, _i32p, _i32p, _i32p, _i16p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _i32p]
        lib.silk_frame_fix.restype = ctypes.c_int
        lib.silk_frame_fix.argtypes = [
            ctypes.c_int, _i16p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, _i16p, _i16p, _i32p, _i32p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int32,
            ctypes.c_int, _i16p, _i16p, ctypes.c_int,
            _i16p, _i32p, _i32p, _i32p, _i32p, _i16p, _i32p, _i16p,
            _i32p, _i16p]
        lib.silk_resampler_iir_fir.restype = ctypes.c_int
        lib.silk_resampler_iir_fir.argtypes = [
            _i16p, ctypes.c_int, ctypes.c_int, ctypes.c_int32,
            _i32p, _i16p, _i16p, _i16p, _i16p]
        lib.silk_stereo_ms_to_lr.restype = ctypes.c_int
        lib.silk_stereo_ms_to_lr.argtypes = [
            _i16p, _i16p, _i16p, _i16p, _i32p, _i32p,
            ctypes.c_int, ctypes.c_int]
        lib._sigs_set = True
    return lib


def have_silk_core() -> bool:
    return _silk_lib() is not None


def silk_parse_packet(data: bytes, st64: np.ndarray, bw: int, stereo: bool,
                      n_frames: int, n_subfr: int, frame_length: int,
                      tab_blob: np.ndarray, tab_offs: np.ndarray,
                      pred_quant_q13: np.ndarray):
    """Parse one SILK packet's LP layer natively (silk_parse.cc; the
    Python layer in codecs/opus/silk.py is the behaviour oracle).

    st64 is the 10-slot range-decoder handoff state ([0]!=0 resumes,
    always written back).  Returns (ix, pulses, lbrr_ix, lbrr_pulses,
    stereo_misc) — ix rows are the 40-int32 frame-index layout
    documented in silk_parse.cc — or None when the native core is
    unavailable."""
    lib = _silk_lib()
    if lib is None:
        return None
    nch = 2 if stereo else 1
    ix = np.zeros((n_frames * nch, 40), np.int32)
    pulses = np.zeros((n_frames * nch, frame_length), np.int16)
    lbrr_ix = np.zeros((n_frames * nch, 40), np.int32)
    lbrr_pulses = np.zeros((n_frames * nch, frame_length), np.int16)
    stereo_misc = np.zeros(3 * max(n_frames, 1), np.int32)
    rc = lib.silk_parse_packet(
        data, len(data), st64, bw, int(stereo), n_frames, n_subfr,
        frame_length, tab_blob, tab_offs, pred_quant_q13,
        ix, pulses, lbrr_ix, lbrr_pulses, stereo_misc)
    if rc != 0:
        return None
    return ix, pulses, lbrr_ix, lbrr_pulses, stereo_misc


def silk_nlsf2a(nlsf_q15: np.ndarray, cos_tab_q12: np.ndarray) -> np.ndarray:
    """Q15 NLSF vector -> stabilised Q12 LPC (silk/NLSF2A.c)."""
    lib = _silk_lib()
    d = len(nlsf_q15)
    a = np.zeros(d, np.int16)
    lib.silk_nlsf2a(np.ascontiguousarray(nlsf_q15, np.int16), d,
                    np.ascontiguousarray(cos_tab_q12, np.int16), a)
    return a


class SilkPlcState:
    """Persistent PLC/CNG/decoder bookkeeping for silk_frame_fix
    (layouts documented in silk_core.cc)."""

    def __init__(self):
        self.plc_i32 = np.zeros(10, np.int32)
        self.plc_i16 = np.zeros(23, np.int16)
        self.cng_i32 = np.zeros(339, np.int32)
        self.cng_i16 = np.zeros(16, np.int16)
        self.misc = np.zeros(4, np.int32)
        self.misc[2] = 1                       # first_frame_after_reset
        self.exc = np.zeros(320, np.int32)     # last good excitation


def silk_frame_fix(lost: bool, pulses: np.ndarray, subfr_length: int,
                   nb_subfr: int, lpc_order: int, ltp_mem: int,
                   a_q12_both: np.ndarray, b_q14: np.ndarray,
                   gains_q16: np.ndarray, pitch_lags: np.ndarray,
                   ltp_scale_q14: int, signal_type: int,
                   quant_offset: int, seed: int, nlsf_interp: bool,
                   prev_nlsf_q15: np.ndarray, cos_tab_q12: np.ndarray,
                   fs_khz: int, out_buf: np.ndarray,
                   s_lpc_q14: np.ndarray, prev_gain_q16: np.ndarray,
                   plc: "SilkPlcState") -> np.ndarray:
    """One SILK frame: fixed-point decode (lost=False) or packet-loss
    concealment (lost=True), with PLC state tracking, comfort-noise
    and frame gluing (silk/decode_frame.c + PLC.c + CNG.c).  Mutates
    all state arrays in place; returns xq int16."""
    lib = _silk_lib()
    frame_length = subfr_length * nb_subfr
    xq = np.zeros(frame_length, np.int16)
    rc = lib.silk_frame_fix(
        int(lost), np.ascontiguousarray(pulses, np.int16), frame_length,
        subfr_length, nb_subfr, lpc_order, ltp_mem,
        np.ascontiguousarray(a_q12_both, np.int16),
        np.ascontiguousarray(b_q14, np.int16),
        np.ascontiguousarray(gains_q16, np.int32),
        np.ascontiguousarray(pitch_lags, np.int32),
        int(ltp_scale_q14), int(signal_type), int(quant_offset),
        ctypes.c_int32(int(seed)), int(nlsf_interp),
        np.ascontiguousarray(prev_nlsf_q15, np.int16),
        np.ascontiguousarray(cos_tab_q12, np.int16), fs_khz,
        out_buf, s_lpc_q14, prev_gain_q16, plc.exc,
        plc.plc_i32, plc.plc_i16, plc.cng_i32, plc.cng_i16, plc.misc,
        xq)
    if rc != 0:
        raise ValueError("silk_frame_fix failed")
    return xq


def silk_synth_frame_fix(row: np.ndarray, pulses: np.ndarray, bw: int,
                         nb_subfr: int, subfr_length: int,
                         lpc_order: int, ltp_mem: int, fs_khz: int,
                         dq: np.ndarray, dqo: np.ndarray,
                         cos_tab_q12: np.ndarray,
                         prev_gain_ind: np.ndarray,
                         prev_nlsf: np.ndarray, have_prev: np.ndarray,
                         out_buf: np.ndarray, s_lpc_q14: np.ndarray,
                         prev_gain_q16: np.ndarray,
                         plc: "SilkPlcState") -> np.ndarray:
    """Fused dequant + synthesis of one parsed SILK frame row
    (silk_synth.cc): gains/NLSF/pitch/LTP dequant + silk_frame_fix in
    one native call.  Mutates all state arrays in place; returns xq
    int16."""
    lib = _silk_lib()
    frame_length = subfr_length * nb_subfr
    xq = np.zeros(frame_length, np.int16)
    rc = lib.silk_synth_frame_fix(
        np.ascontiguousarray(row, np.int32),
        np.ascontiguousarray(pulses, np.int16), bw, nb_subfr,
        subfr_length, lpc_order, ltp_mem, fs_khz, dq, dqo,
        np.ascontiguousarray(cos_tab_q12, np.int16),
        prev_gain_ind, prev_nlsf, have_prev,
        out_buf, s_lpc_q14, prev_gain_q16, plc.exc,
        plc.plc_i32, plc.plc_i16, plc.cng_i32, plc.cng_i16, plc.misc,
        xq)
    if rc != 0:
        raise ValueError("silk_synth_frame_fix failed")
    return xq


def silk_decode_core_fix(pulses: np.ndarray, subfr_length: int,
                         nb_subfr: int, lpc_order: int, ltp_mem: int,
                         a_q12_both: np.ndarray, b_q14: np.ndarray,
                         gains_q16: np.ndarray, pitch_lags: np.ndarray,
                         ltp_scale_q14: int, signal_type: int,
                         quant_offset: int, seed: int,
                         nlsf_interp: bool, out_buf: np.ndarray,
                         s_lpc_q14: np.ndarray,
                         prev_gain_q16: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray]:
    """One SILK frame of fixed-point inverse NSQ (silk/decode_core.c).
    Mutates out_buf / s_lpc_q14 / prev_gain_q16 state in place; returns
    (xq int16, exc_Q14 int32)."""
    lib = _silk_lib()
    frame_length = subfr_length * nb_subfr
    xq = np.zeros(frame_length, np.int16)
    exc = np.zeros(frame_length, np.int32)
    rc = lib.silk_decode_core_fix(
        np.ascontiguousarray(pulses, np.int16), frame_length, subfr_length,
        nb_subfr, lpc_order, ltp_mem,
        np.ascontiguousarray(a_q12_both, np.int16),
        np.ascontiguousarray(b_q14, np.int16),
        np.ascontiguousarray(gains_q16, np.int32),
        np.ascontiguousarray(pitch_lags, np.int32),
        int(ltp_scale_q14), int(signal_type), int(quant_offset),
        ctypes.c_int32(seed & 0xFFFFFFFF if seed < (1 << 31)
                       else (seed - (1 << 32))), int(nlsf_interp),
        out_buf, s_lpc_q14, prev_gain_q16, exc, xq,
        0, 0, 0, np.zeros(4, np.int32))
    if rc != 0:
        raise ValueError("silk_decode_core_fix: invalid pitch lag state")
    return xq, exc


def silk_resampler_iir_fir(x: np.ndarray, batch: int, incr_q16: int,
                           s_iir: np.ndarray, s_fir: np.ndarray,
                           up2_coefs: np.ndarray,
                           frac_fir_12: np.ndarray) -> np.ndarray:
    """Fixed-point fs->48k upsampler (resampler_private_IIR_FIR.c);
    mutates s_iir int32[6] / s_fir int16[8] in place."""
    lib = _silk_lib()
    x = np.ascontiguousarray(x, np.int16)
    cap = (2 * len(x) * (1 << 16)) // max(incr_q16, 1) + 16
    out = np.zeros(cap, np.int16)
    n = lib.silk_resampler_iir_fir(
        x, len(x), batch, incr_q16, s_iir, s_fir,
        np.ascontiguousarray(up2_coefs, np.int16),
        np.ascontiguousarray(frac_fir_12, np.int16), out)
    return out[:n]


def silk_stereo_ms_to_lr(mid: np.ndarray, side: np.ndarray,
                         s_mid: np.ndarray, s_side: np.ndarray,
                         pred_prev_q13: np.ndarray, pred_q13: np.ndarray,
                         fs_khz: int) -> tuple[np.ndarray, np.ndarray]:
    """Mid/side -> L/R with interpolated predictors
    (silk/stereo_MS_to_LR.c); x inputs are the frame WITHOUT history --
    the 2-sample history is carried in s_mid/s_side (mutated)."""
    lib = _silk_lib()
    frame_length = len(mid)
    x1 = np.zeros(frame_length + 2, np.int16)
    x2 = np.zeros(frame_length + 2, np.int16)
    x1[2:] = mid
    x2[2:] = side
    lib.silk_stereo_ms_to_lr(
        x1, x2, s_mid, s_side, pred_prev_q13,
        np.ascontiguousarray(pred_q13, np.int32), fs_khz, frame_length)
    # dec_API.c feeds the resampler from &x[1]: the converted samples
    # live at [1, L+1) and carry the decoder's one-sample delay
    return x1[1:frame_length + 1], x2[1:frame_length + 1]


# ---------------------------------------------------------------------------
# ALAC hot loops (alac_core.cc): adaptive-Golomb residual decode +
# sign-adaptive FIR prediction (ag_dec.c / dp_dec.c behaviour).
# codecs/alac.py takes these; its pure-Python loops are the oracle the
# tests hold them to.


def _alac_lib() -> ctypes.CDLL | None:
    lib = _load("alaccore", ["alac_core.cc"])
    if lib is not None and not getattr(lib, "_sigs_set", False):
        lib.alac_dyn_decomp.restype = ctypes.c_int
        lib.alac_dyn_decomp.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int, ctypes.c_int, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int, _i32p]
        lib.alac_unpc_block.restype = ctypes.c_int
        lib.alac_unpc_block.argtypes = [
            _i32p, ctypes.c_int, _i32p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, _i32p]
        lib._sigs_set = True
    return lib


def have_alac_core() -> bool:
    return _alac_lib() is not None


def alac_dyn_decomp(data: bytes, bit_pos: int, num: int, chan_bits: int,
                    mb0: int, pb: int, kb: int) -> tuple:
    """(residuals int32[num], new_bit_pos); raises on zero-run overrun."""
    lib = _alac_lib()
    out = np.zeros(num, np.int32)
    pos = ctypes.c_int64(bit_pos)
    rc = lib.alac_dyn_decomp(data, len(data), ctypes.byref(pos), num,
                             chan_bits, mb0, pb, kb, out)
    if rc != 0:
        raise ValueError("alac zero-run overrun")
    return out, pos.value


def alac_unpc_block(resid: np.ndarray, coefs: np.ndarray, numactive: int,
                    chan_bits: int, denshift: int) -> np.ndarray:
    """Prediction synthesis; mutates coefs (int32) like the adaptive
    reference filter.  Returns int32 output."""
    lib = _alac_lib()
    resid = np.ascontiguousarray(resid, np.int32)
    out = np.zeros(len(resid), np.int32)
    lib.alac_unpc_block(resid, len(resid), coefs, numactive, chan_bits,
                        denshift, out)
    return out
