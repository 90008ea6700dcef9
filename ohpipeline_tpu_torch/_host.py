"""The host helpers the port shares with the JAX package, without JAX.

``ohpipeline_tpu.native`` (the C++ parsers behind ctypes) and
``ohpipeline_tpu.core`` import no JAX, so the port imports them as they are.
The FLAC host files ``codecs/flac/{bitreader,frames,encoder}.py`` import no
JAX either, but they sit under ``ohpipeline_tpu.codecs``, whose package
``__init__`` imports every codec and, through them, JAX.  This module loads
those three files from their directory under a private package name whose
``__path__`` points there, so that ``__init__`` never runs and the
``ohpipeline_tpu.codecs`` entries of ``sys.modules`` are left alone (a
process may hold both packages, as the tests do).
"""

from __future__ import annotations

import importlib
import importlib.machinery
import importlib.util
import pathlib
import sys

from ohpipeline_tpu import native

_PKG = "_ohpipeline_tpu_torch_flac_host"
_FLAC_DIR = pathlib.Path(native.__file__).resolve().parent.parent \
    / "codecs" / "flac"


def _flac_host_module(name: str):
    if _PKG not in sys.modules:
        spec = importlib.machinery.ModuleSpec(_PKG, None, is_package=True)
        spec.submodule_search_locations = [str(_FLAC_DIR)]
        sys.modules[_PKG] = importlib.util.module_from_spec(spec)
    return importlib.import_module(f"{_PKG}.{name}")


frames = _flac_host_module("frames")
encoder = _flac_host_module("encoder")

parse_metadata = frames.parse_metadata
encode_flac = encoder.encode_flac

__all__ = ["native", "frames", "encoder", "parse_metadata", "encode_flac"]
