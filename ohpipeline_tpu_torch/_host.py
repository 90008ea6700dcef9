"""The host helpers of the port, under the names its modules and tests use.

A plain facade over :mod:`ohpipeline_tpu_torch.host`, the port's own copies
of the JAX package's host files: the C++ parsers behind ctypes (``native``),
the FLAC bit reader, frame parser and encoder, the AAC tables and ADTS
bitstream, the SBR host chain (``sbr.py`` and the host half of
``sbr_jax.py``) and the CELT entropy layer with its Ogg Opus framing.
Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import threading

from .host import native
from .host.codecs import base, opus_headers
from .host.codecs.aac import bitstream as aac_bitstream
from .host.codecs.aac import sbr as aac_sbr
from .host.codecs.aac import sbr_host as aac_sbr_jax
from .host.codecs.aac import tables as aac_tables
from .host.codecs.flac import encoder, frames
from .host.codecs.opus import celt
from .host.codecs.opus.packet import split_packet_frames
from .host.containers import ogg

parse_metadata = frames.parse_metadata
encode_flac = encoder.encode_flac

_LOCK = threading.Lock()


def aac_native():
    """``native``, with its AAC unpacker built and fed its tables (from
    ``aac_tables``) on first call.  Call before any ``native.aac_*``
    function."""
    with _LOCK:
        native._aac_lib()
    return native


def sbr_native():
    """``native``, with its SBR payload parser built and given its Huffman
    books (from ``aac_sbr``) on first call."""
    with _LOCK:
        native._sbr_lib()
    return native


__all__ = ["native", "frames", "encoder", "aac_tables", "aac_bitstream",
           "aac_sbr", "aac_sbr_jax", "aac_native", "sbr_native",
           "parse_metadata", "encode_flac", "base", "opus_headers", "celt",
           "split_packet_frames", "ogg"]
