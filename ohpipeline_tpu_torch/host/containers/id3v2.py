"""ID3v2 tag container (reference Codec/Id3v2.cpp): strip the tag block in
front of MP3/AAC/FLAC streams and surface its text frames as metadata."""

from __future__ import annotations

from ..codecs.base import StreamReader
from .base import ContainerBase

_TEXT_FRAMES = {"TIT2": "title", "TPE1": "artist", "TALB": "album",
                "TCON": "genre", "TRCK": "track", "TDRC": "year",
                "TYER": "year"}


def _syncsafe(b: bytes) -> int:
    return (b[0] << 21) | (b[1] << 14) | (b[2] << 7) | b[3]


def parse_id3v2(data: bytes) -> tuple[int, dict]:
    """Returns (total_tag_bytes, metadata) or (0, {})."""
    if data[:3] != b"ID3" or len(data) < 10:
        return 0, {}
    version = data[3]
    flags = data[5]
    size = _syncsafe(data[6:10]) + 10
    if flags & 0x10:   # footer present
        size += 10
    meta: dict = {}
    pos = 10
    if flags & 0x40 and len(data) >= 14:   # extended header
        pos += _syncsafe(data[10:14]) if version >= 4 else \
            int.from_bytes(data[10:14], "big")
    while pos + 10 <= min(size, len(data)):
        fid = data[pos:pos + 4]
        if fid == b"\x00\x00\x00\x00":
            break
        fsize = (_syncsafe(data[pos + 4:pos + 8]) if version >= 4
                 else int.from_bytes(data[pos + 4:pos + 8], "big"))
        body = data[pos + 10:pos + 10 + fsize]
        pos += 10 + fsize
        key = _TEXT_FRAMES.get(fid.decode("latin1", "replace"))
        if key and body:
            enc, payload = body[0], body[1:]
            try:
                if enc == 0:
                    text = payload.decode("latin1")
                elif enc == 1:
                    text = payload.decode("utf-16")
                elif enc == 2:
                    text = payload.decode("utf-16-be")
                else:
                    text = payload.decode("utf-8")
                meta[key] = text.rstrip("\x00")
            except UnicodeDecodeError:
                pass
    return size, meta


class _SkippingReader(StreamReader):
    def __init__(self, inner: StreamReader, skip: int):
        self._inner = inner
        self._skip = skip
        self._skipped = False

    def _ensure(self):
        if not self._skipped:
            remaining = self._skip
            while remaining > 0:
                got = self._inner.read(min(remaining, 1 << 16))
                if not got:
                    break
                remaining -= len(got)
            self._skipped = True

    def read(self, n):
        self._ensure()
        return self._inner.read(n)

    def peek(self, n):
        self._ensure()
        return self._inner.peek(n)

    @property
    def stream_bytes(self):
        total = self._inner.stream_bytes
        return None if total is None else max(0, total - self._skip)

    def try_seek_bytes(self, pos):
        return self._inner.try_seek_bytes(pos + self._skip)


class ContainerId3v2(ContainerBase):
    name = "ID3v2"

    def __init__(self):
        self.metadata = {}
        self._tag_bytes = 0

    def recognise(self, header: bytes) -> bool:
        if header[:3] != b"ID3":
            return False
        self._tag_bytes, self.metadata = parse_id3v2(header)
        return self._tag_bytes > 0

    def wrap(self, reader: StreamReader) -> StreamReader:
        return _SkippingReader(reader, self._tag_bytes)
