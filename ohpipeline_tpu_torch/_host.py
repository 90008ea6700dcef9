"""The host helpers the port shares with the JAX package, without JAX.

``ohpipeline_tpu.native`` (the C++ parsers behind ctypes) and
``ohpipeline_tpu.core`` import no JAX, so the port imports them as they are.
The FLAC host files ``codecs/flac/{bitreader,frames,encoder}.py`` and the AAC
ones ``codecs/aac/{tables,bitstream}.py`` import no JAX either, but they sit
under ``ohpipeline_tpu.codecs``, whose package ``__init__`` imports every
codec and, through them, JAX.  This module registers one private parent
package whose ``__path__`` is ``codecs/``, with ``flac`` and ``aac``
sub-packages built by hand and never executed, and loads those files under
it: no codec ``__init__`` runs, ``bitstream.py``'s relative import of
``..flac.bitreader`` resolves inside the private package, and the
``ohpipeline_tpu.codecs`` entries of ``sys.modules`` are left alone (a
process may hold both packages, as the tests do).

The C AAC unpacker needs one more step: ``native._aac_lib`` feeds it its
Huffman and band tables from ``ohpipeline_tpu.codecs.aac.tables``, an import
that runs ``ohpipeline_tpu.codecs.__init__`` and with it JAX.
:func:`aac_native` feeds the same tables from the copy loaded here, once,
so the port never reaches that import.
"""

from __future__ import annotations

import importlib
import importlib.machinery
import importlib.util
import pathlib
import sys
import threading

import numpy as np

from ohpipeline_tpu import native

_PKG = "_ohpipeline_tpu_torch_codecs_host"
_CODECS_DIR = pathlib.Path(native.__file__).resolve().parent.parent / "codecs"


def _package(name: str, path: pathlib.Path):
    spec = importlib.machinery.ModuleSpec(name, None, is_package=True)
    spec.submodule_search_locations = [str(path)]
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    return module


def _host_module(codec: str, name: str):
    if _PKG not in sys.modules:
        parent = _package(_PKG, _CODECS_DIR)
        for sub in ("flac", "aac"):
            setattr(parent, sub, _package(f"{_PKG}.{sub}", _CODECS_DIR / sub))
    return importlib.import_module(f"{_PKG}.{codec}.{name}")


frames = _host_module("flac", "frames")
encoder = _host_module("flac", "encoder")
aac_tables = _host_module("aac", "tables")
aac_bitstream = _host_module("aac", "bitstream")

parse_metadata = frames.parse_metadata
encode_flac = encoder.encode_flac

_AAC_LOCK = threading.Lock()


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


__all__ = ["native", "frames", "encoder", "aac_tables", "aac_bitstream",
           "aac_native", "parse_metadata", "encode_flac"]
