"""file:// protocol (reference ProtocolFile.cpp): stream a local file with
byte-seek support."""

from __future__ import annotations

import os
import threading
import urllib.parse

from ..core import events as ev
from ..core.streaminfo import EncodedStreamInfo
from .base import Protocol, ProtocolStreamResult

CHUNK = 128 * 1024


class ProtocolFile(Protocol):
    name = "File"

    def __init__(self):
        super().__init__()
        self._seek_pos = None
        self._stop = False
        self._flush_id = 0
        self._next_flush = 1
        self._stream_id = 0
        self._lock = threading.Lock()

    def recognise(self, uri: str) -> bool:
        return uri.startswith("file://")

    def _path(self, uri: str) -> str:
        parsed = urllib.parse.urlparse(uri)
        return urllib.parse.unquote(parsed.path)

    def try_seek(self, stream_id: int, byte_pos: int) -> int:
        with self._lock:
            if stream_id != self._stream_id:
                return ev.FlushEvent.ID_INVALID
            self._seek_pos = byte_pos
            self._flush_id = self._next_flush
            self._next_flush += 1
            return self._flush_id

    def try_stop(self, stream_id: int) -> int:
        with self._lock:
            if stream_id != self._stream_id:
                return ev.FlushEvent.ID_INVALID
            self._stop = True
            self._flush_id = self._next_flush
            self._next_flush += 1
            return self._flush_id

    def stream(self, uri: str) -> ProtocolStreamResult:
        path = self._path(uri)
        if not os.path.isfile(path):
            return ProtocolStreamResult.ERROR_RECOVERABLE
        size = os.path.getsize(path)
        self._stop = False
        self._seek_pos = None
        self.interrupt(False)
        with self._lock:
            self._stream_id = self.next_stream_id()
        self.supply.output_stream(
            EncodedStreamInfo(uri=uri, total_bytes=size,
                              stream_id=self._stream_id, seekable=True,
                              live=False),
            stream_handler=self)
        with open(path, "rb") as f:
            while True:
                if self.interrupted:
                    return ProtocolStreamResult.STOPPED
                with self._lock:
                    if self._stop:
                        self.supply.output_flush(self._flush_id)
                        return ProtocolStreamResult.STOPPED
                    if self._seek_pos is not None:
                        f.seek(self._seek_pos)
                        self._seek_pos = None
                        self.supply.output_flush(self._flush_id)
                data = f.read(CHUNK)
                if not data:
                    break
                self.supply.output_data(data)
        if hasattr(self.supply, "flush_pending"):
            self.supply.flush_pending()
        return ProtocolStreamResult.SUCCESS
