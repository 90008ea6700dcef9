"""Codec plug-in model.

Parity target: the reference's `CodecBase`/`ICodecController`
(OpenHome/Media/Codec/CodecController.h:272,29) — recognition over a
rewindable window, StreamInitialise, a Process loop, TrySeek — recast for a
host-parse/device-synthesize split:

* `recognise(header)` — sniff a byte window (the reference's Rewinder-backed
  recognition, CodecController.cpp:362-388).
* `stream_initialise(reader)` — parse headers, return `PcmStreamInfo`.
* `process(reader)` — decode the next chunk; returns a `DecodedBatch` of
  host arrays (ready to batch onto device) or raises `EndOfStream`.
* `try_seek(sample)` — map a sample position to a byte position.

Codecs that decode dense math on device (FLAC/ALAC/MP3/AAC...) return
*parameter batches* (residuals/coefficients/spectra) via `DecodedBatch.defer`
so the pipeline can coalesce many streams into one device dispatch; simple
PCM codecs return samples directly.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
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


class CodecRegistry:
    """Ordered codec registry (reference CodecFactory + CodecController's
    recognition loop)."""

    def __init__(self):
        self._codecs: list[Callable[[], CodecBase]] = []

    def add(self, factory: Callable[[], CodecBase]) -> None:
        self._codecs.append(factory)

    def instantiate(self) -> list[CodecBase]:
        cs = [f() for f in self._codecs]
        cs.sort(key=lambda c: c.recognition_cost)
        return cs

    def recognise(self, header: bytes) -> Optional[CodecBase]:
        for codec in self.instantiate():
            if codec.recognise(header):
                return codec
        return None


default_registry = CodecRegistry()
