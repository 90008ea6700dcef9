"""Protocol base classes (reference Protocol.h:16-258)."""

from __future__ import annotations

import enum
import threading
from typing import Optional

from ..core import events as ev


class ProtocolStreamResult(enum.Enum):
    """EProtocolStreamResult (Protocol.h:16-23)."""
    SUCCESS = "success"
    ERROR_RECOVERABLE = "recoverable"
    ERROR_UNRECOVERABLE = "unrecoverable"
    STOPPED = "stopped"


class StreamHandler:
    """IStreamHandler (Msg.h:1725-1793): in-band upstream control."""

    def ok_to_play(self, stream_id: int) -> bool:
        return True

    def try_seek(self, stream_id: int, byte_pos: int) -> int:
        return ev.FlushEvent.ID_INVALID

    def try_stop(self, stream_id: int) -> int:
        return ev.FlushEvent.ID_INVALID

    def try_discard(self, jiffies: int) -> int:
        return ev.FlushEvent.ID_INVALID

    def notify_starving(self, mode: str, stream_id: int,
                        starving: bool) -> None:
        pass


class Protocol(StreamHandler):
    """A protocol plug-in (reference Protocol, Protocol.h:71)."""

    name = "?"

    def __init__(self):
        self.supply = None
        self._active = False
        self._interrupted = threading.Event()
        self._lock = threading.Lock()

    def initialise(self, supply, id_provider) -> None:
        self.supply = supply
        self.id_provider = id_provider

    def recognise(self, uri: str) -> bool:
        raise NotImplementedError

    def stream(self, uri: str) -> ProtocolStreamResult:
        raise NotImplementedError

    def interrupt(self, interrupt: bool) -> None:
        """Unblock network reads so the filler can switch tracks
        (Protocol::Interrupt)."""
        if interrupt:
            self._interrupted.set()
        else:
            self._interrupted.clear()

    @property
    def interrupted(self) -> bool:
        return self._interrupted.is_set()

    def next_stream_id(self) -> int:
        return self.id_provider.next_stream_id() if self.id_provider else 0


class _StreamIdProvider:
    def __init__(self):
        self._next = 1
        self._lock = threading.Lock()

    def next_stream_id(self) -> int:
        with self._lock:
            sid, self._next = self._next, self._next + 1
            return sid


class ProtocolManager:
    """Ordered protocol registry + IUriStreamer (Protocol.cpp:532-560):
    DoStream tries each registered protocol in order until one accepts."""

    def __init__(self, supply, id_provider=None):
        self._protocols: list[Protocol] = []
        self._supply = supply
        self._ids = id_provider or _StreamIdProvider()
        self._current: Optional[Protocol] = None

    def add(self, protocol: Protocol) -> None:
        protocol.initialise(self._supply, self._ids)
        self._protocols.append(protocol)

    def do_stream(self, uri: str) -> ProtocolStreamResult:
        for p in self._protocols:
            if not p.recognise(uri):
                continue
            self._current = p
            try:
                res = p.stream(uri)
            finally:
                self._current = None
            if res is not ProtocolStreamResult.ERROR_RECOVERABLE:
                return res
        return ProtocolStreamResult.ERROR_UNRECOVERABLE

    def interrupt(self) -> None:
        for p in self._protocols:
            p.interrupt(True)

    @property
    def current(self) -> Optional[Protocol]:
        return self._current
