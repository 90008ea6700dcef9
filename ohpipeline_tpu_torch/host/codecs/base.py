"""Stream readers and codec errors of the port's host code.

The part of the JAX package's ``codecs/base.py`` that ``containers/ogg.py``,
``codecs/opus/celt.py`` and ``codecs/opus/packet.py`` reach: the errors and
the byte-stream readers.  The codec plug-in classes are not copied.
"""

from __future__ import annotations

import abc
from typing import Optional


class EndOfStream(Exception):
    """Raised by `process` when the stream is exhausted."""


class CodecStreamCorrupt(Exception):
    """Unrecoverable bitstream damage (reference CodecStreamCorrupt)."""


class StreamReader(abc.ABC):
    """What a codec sees of the upstream pipeline (ICodecController's Read,
    CodecController.h:29-110): a byte stream with known length and seek."""

    @abc.abstractmethod
    def read(self, nbytes: int) -> bytes:
        """Read up to nbytes; b'' at end of stream."""

    @abc.abstractmethod
    def peek(self, nbytes: int) -> bytes:
        """Read without consuming (recognition window)."""

    @property
    @abc.abstractmethod
    def stream_bytes(self) -> Optional[int]:
        """Total stream length, if known."""

    #: True when try_seek_bytes is a cheap local reposition (in-memory /
    #: file) rather than an upstream protocol seek with flush semantics;
    #: codecs may only scan around (e.g. duration discovery) when set
    random_access = False

    def try_seek_bytes(self, pos: int) -> bool:
        """Reposition the stream (IStreamHandler::TrySeek upstream)."""
        return False


class BufferReader(StreamReader):
    """In-memory StreamReader over a bytes object (tests, file protocol)."""

    random_access = True

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0

    def read(self, nbytes: int) -> bytes:
        out = self._data[self._pos:self._pos + nbytes]
        self._pos += len(out)
        return out

    def peek(self, nbytes: int) -> bytes:
        return self._data[self._pos:self._pos + nbytes]

    @property
    def stream_bytes(self) -> Optional[int]:
        return len(self._data)

    @property
    def pos(self) -> int:
        return self._pos

    def try_seek_bytes(self, pos: int) -> bool:
        if not 0 <= pos <= len(self._data):
            return False
        self._pos = pos
        return True
