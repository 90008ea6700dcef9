"""Stream readers, codec errors and the codec plug-in model of the port's
host code.

The part of the JAX package's ``codecs/base.py`` that ``containers/ogg.py``,
``codecs/opus/celt.py``, ``codecs/opus/packet.py`` and the AAC plug-in
(``ohpipeline_tpu_torch.codecs.aac.CodecAacAdts``) reach: the errors, the
byte-stream readers, ``DecodedBatch`` and ``CodecBase``.  The registry is
not copied.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np

from ..core.streaminfo import PcmStreamInfo


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


@dataclass(slots=True)
class DecodedBatch:
    """One `process()` step's output.

    Either direct samples (`samples` as (channels, n) int32 native range) or
    a deferred device computation: `defer` is a callable executed at batch
    time returning the samples (used by codecs whose synthesis runs on
    device so multiple streams' work can be coalesced).
    `track_offset_samples` is the absolute sample index of the first sample.
    """
    info: PcmStreamInfo
    samples: Optional[np.ndarray] = None
    defer: Optional[Callable[[], np.ndarray]] = None
    track_offset_samples: int = 0

    def resolve(self) -> np.ndarray:
        if self.samples is not None:
            return self.samples
        return self.defer()


class CodecBase(abc.ABC):
    """A codec plug-in (reference CodecBase, CodecController.h:272)."""

    #: Sorted ascending at registration — cheap recognisers run first
    #: (reference RecognitionComplexity).
    recognition_cost: int = 0
    name: str = "?"
    #: Mime types to advertise (IMimeTypeList).
    mime_types: Sequence[str] = ()

    @abc.abstractmethod
    def recognise(self, header: bytes) -> bool:
        """True if `header` (first bytes of the stream) looks like ours."""

    @abc.abstractmethod
    def stream_initialise(self, reader: StreamReader) -> PcmStreamInfo:
        ...

    @abc.abstractmethod
    def process(self, reader: StreamReader) -> DecodedBatch:
        """Decode the next chunk or raise EndOfStream."""

    def try_seek(self, sample: int) -> Optional[int]:
        """Sample index -> byte position, or None if unseekable."""
        return None
