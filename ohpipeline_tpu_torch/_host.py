"""The host helpers of the port, under the names its modules and tests use.

A plain facade over :mod:`ohpipeline_tpu_torch.host`, the port's own copies
of the JAX package's host files: the C++ parsers behind ctypes (``native``),
the FLAC bit reader, frame parser and encoder, the AAC tables and ADTS
bitstream, the SBR host chain (``sbr.py`` and the host half of
``sbr_jax.py``), the CELT entropy layer with its Ogg Opus framing, the MP3
bitstream, encoder and numpy host prep, and the Vorbis packet decoder,
host synthesis and stream builder.
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
from .host.codecs.mp3 import bitstream as mp3_bitstream
from .host.codecs.mp3 import encoder as mp3_encoder
from .host.codecs.mp3 import prep as mp3_prep
from .host.codecs.opus import celt
from .host.codecs.vorbis import encoder as vorbis_encoder
from .host.codecs.vorbis import synthesis as vorbis_synthesis
from .host.codecs.opus import split_packet_frames
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
           "split_packet_frames", "ogg", "mp3_bitstream", "mp3_encoder",
           "mp3_prep", "vorbis_encoder", "vorbis_synthesis"]
