"""The host helpers the port shares with the JAX package, without JAX.

``ohpipeline_tpu.native`` (the C++ parsers behind ctypes) and
``ohpipeline_tpu.core`` import no JAX, so the port imports them as they are.
The FLAC host files ``codecs/flac/{bitreader,frames,encoder}.py``, the AAC
ones ``codecs/aac/{tables,bitstream}.py`` and the SBR host files
``codecs/aac/{sbr,sbr_jax}.py`` (``sbr_jax`` imports JAX only inside its
device functions, which the port never calls) import no JAX at top level
either, but they sit under ``ohpipeline_tpu.codecs``, whose package
``__init__`` imports every codec and, through them, JAX.  This module
registers a private root package holding ``native`` (the real
``ohpipeline_tpu.native``) and a hand-built ``codecs`` package whose
``__path__`` is ``codecs/``, with ``flac`` and ``aac`` sub-packages built by
hand and never executed, and loads those files under it: no codec
``__init__`` runs, ``bitstream.py``'s relative import of ``..flac.bitreader``
and ``sbr_jax.py``'s of ``.sbr`` resolve inside the private package, so does
``sbr.py``'s ``from ... import native`` (which would otherwise fail and
quietly send every SBR payload through the Python bit parser), and the
``ohpipeline_tpu.codecs`` entries of ``sys.modules`` are left alone (a
process may hold both packages, as the tests do).

The C AAC unpacker needs one more step: ``native._aac_lib`` feeds it its
Huffman and band tables from ``ohpipeline_tpu.codecs.aac.tables``, an import
that runs ``ohpipeline_tpu.codecs.__init__`` and with it JAX.
:func:`aac_native` feeds the same tables from the copy loaded here, once,
so the port never reaches that import.  The native SBR payload parser
has the same step (``native._sbr_lib`` reads its Huffman books from
``ohpipeline_tpu.codecs.aac.sbr``); :func:`sbr_native` feeds them from
``aac_sbr``.
"""

from __future__ import annotations

import ctypes
import importlib
import importlib.machinery
import importlib.util
import pathlib
import sys
import threading

import numpy as np

from ohpipeline_tpu import native

_ROOT = "_ohpipeline_tpu_torch_host"
_PKG = f"{_ROOT}.codecs"
_CODECS_DIR = pathlib.Path(native.__file__).resolve().parent.parent / "codecs"


def _package(name: str, path: pathlib.Path | None):
    spec = importlib.machinery.ModuleSpec(name, None, is_package=True)
    spec.submodule_search_locations = [str(path)] if path else []
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    return module


def _host_module(codec: str, name: str):
    if _PKG not in sys.modules:
        # the root has no directory of its own: its only members are the
        # two set here, so nothing else of ohpipeline_tpu can load under it
        root = _package(_ROOT, None)
        root.native = sys.modules[f"{_ROOT}.native"] = native
        root.codecs = parent = _package(_PKG, _CODECS_DIR)
        for sub in ("flac", "aac"):
            setattr(parent, sub, _package(f"{_PKG}.{sub}", _CODECS_DIR / sub))
    return importlib.import_module(f"{_PKG}.{codec}.{name}")


frames = _host_module("flac", "frames")
encoder = _host_module("flac", "encoder")
aac_tables = _host_module("aac", "tables")
aac_bitstream = _host_module("aac", "bitstream")
aac_sbr = _host_module("aac", "sbr")
aac_sbr_jax = _host_module("aac", "sbr_jax")

parse_metadata = frames.parse_metadata
encode_flac = encoder.encode_flac

_AAC_LOCK = threading.Lock()
_SBR_LOCK = threading.Lock()


def _feed_aac_tables(lib) -> None:
    """The table feed of ``native._aac_lib``, from ``aac_tables``."""
    T = aac_tables
    keep = native._AAC_KEEPALIVE
    for cb in range(1, 12):
        lut = T.SPECTRAL_LUTS[cb]
        lens = np.ascontiguousarray(lut.lengths)
        rows = np.ascontiguousarray(lut.values.astype(np.int32))
        vals = np.ascontiguousarray(lut.vals.astype(np.int8))
        keep.extend([lens, rows, vals])
        lib.aac_set_tables(cb, lut.maxlen, lens, rows, vals, T.CB_DIM[cb],
                           int(T.CB_UNSIGNED[cb]))
    scl = T.SCL_LUT
    lens = np.ascontiguousarray(scl.lengths)
    rows = np.ascontiguousarray(scl.values.astype(np.int32))
    dummy = np.zeros(1, np.int8)
    sclv = np.ascontiguousarray(scl.vals.reshape(-1).astype(np.int16))
    keep.extend([lens, rows, dummy, sclv])
    lib.aac_set_tables(0, scl.maxlen, lens, rows, dummy, 1, 0)
    lib.aac_set_scl_vals(sclv)
    for ri in range(13):
        nl, ns = (int(x) for x in T.SFB_COUNTS[ri])
        lng = np.ascontiguousarray(T.SFB_LONG[ri][:nl + 1])
        sh = np.ascontiguousarray(T.SFB_SHORT[ri][:ns + 1])
        keep.extend([lng, sh])
        lib.aac_set_sfb(ri, lng, nl, sh, ns)


def aac_native():
    """``native``, with its AAC unpacker (built on first use) fed its tables
    without importing JAX.  Call before any ``native.aac_*`` function."""
    with _AAC_LOCK:
        if not native._AAC_TABLES_SET:
            # marked set first, so that _aac_lib only loads the library and
            # declares its signatures
            native._AAC_TABLES_SET = True
            try:
                lib = native._aac_lib()
                if lib is None:              # no toolchain: aac_* raise
                    native._AAC_TABLES_SET = False
                else:
                    _feed_aac_tables(lib)
            except BaseException:
                native._AAC_TABLES_SET = False
                raise
    return native


def sbr_native():
    """``native``, with its SBR payload parser (built on first use) given
    its signatures and Huffman books without importing JAX: the set-up of
    ``native._sbr_lib``, with the books read from ``aac_sbr``.  Call before
    the first ``SbrDecoder.parse_payload``, or ``aac_sbr`` takes the Python
    bit parser (its native attempt would import JAX and fail)."""
    with _SBR_LOCK:
        lib = native._load("sbrparse", ["sbr_parse.cc"])
        if lib is not None and not getattr(lib, "_sigs_set", False):
            lib.sbr_set_book.argtypes = [ctypes.c_int, native._i32p,
                                         ctypes.c_int]
            lib.sbr_parse_payload.restype = ctypes.c_int
            lib.sbr_parse_payload.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int] \
                + [ctypes.c_void_p] * 16
            T = aac_sbr.tables()
            for i, name in enumerate(native._SBR_BOOK_IDS):
                tree = np.ascontiguousarray(T[name].astype(np.int32))
                native._sbr_books_keep.append(tree)
                lib.sbr_set_book(i, tree, tree.shape[0])
            lib._sigs_set = True
    return native


__all__ = ["native", "frames", "encoder", "aac_tables", "aac_bitstream",
           "aac_sbr", "aac_sbr_jax", "aac_native", "sbr_native",
           "parse_metadata", "encode_flac"]
