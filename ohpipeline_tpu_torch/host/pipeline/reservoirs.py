"""Bounded reservoirs — the pipeline's backpressure and admission control.

Parity targets: AudioReservoir.cpp (BlockIfFull push side, 38-55),
EncodedAudioReservoir.cpp (byte-bounded), DecodedAudioReservoir.cpp
(jiffy-bounded + gorging 67-113), MsgReservoir occupancy counters
(Msg.h:1326-1443).

The reference decouples its threads with these; here they decouple the
protocol/filler thread (push) from the render pull chain, with identical
semantics: push blocks when full, pull blocks when empty, occupancy is
queryable, and non-live streams "gorge" (buffer >= gorge_jiffies before
the first pull proceeds).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional

from ..core import events as ev
from ..core.jiffies import Jiffies
from .elements import Element, Pushable

ENCODED_RESERVOIR_BYTES = 1536 * 1024          # Pipeline.h:97
DECODED_RESERVOIR_JIFFIES = 2000 * Jiffies.kPerMs   # Pipeline.h:98
GORGE_JIFFIES = 1000 * Jiffies.kPerMs          # Pipeline.h:99
MAX_STREAMS = 10                               # Pipeline.h:101


class Reservoir(Element, Pushable):
    """Base bounded event queue: blocking push/pull with a size functor."""

    def __init__(self, capacity: int, name: str = ""):
        Element.__init__(self, None, name)
        self.capacity = capacity
        self._q: deque[ev.Event] = deque()
        self._size = 0
        self._streams = 0
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._closed = False

    # -- sizing hook -------------------------------------------------------
    def event_size(self, e: ev.Event) -> int:
        return 0

    @property
    def occupancy(self) -> int:
        with self._lock:
            return self._size

    @property
    def stream_count(self) -> int:
        with self._lock:
            return self._streams

    def _block_if_full(self, e: ev.Event) -> bool:
        """True when this event must wait for space (audio only; control
        events always pass so flush/halt can't deadlock — matches the
        reference, AudioReservoir.cpp:38)."""
        return self.event_size(e) > 0 and self._size >= self.capacity

    def push(self, e: ev.Event) -> None:
        with self._not_full:
            while self._block_if_full(e) and not self._closed:
                self._not_full.wait(0.1)
            if self._closed:
                return
            self._q.append(e)
            self._size += self.event_size(e)
            if e.kind in ("encoded_stream", "decoded_stream"):
                self._streams += 1
            self._not_empty.notify_all()

    def pull(self) -> ev.Event:
        with self._not_empty:
            while not self._q and not self._closed:
                self._not_empty.wait(0.1)
            if not self._q:
                return ev.QuitEvent()
            e = self._q.popleft()
            self._size -= self.event_size(e)
            if e.kind in ("encoded_stream", "decoded_stream"):
                self._streams -= 1
            self._not_full.notify_all()
            return e

    def try_pull(self) -> Optional[ev.Event]:
        with self._not_empty:
            if not self._q:
                return None
            e = self._q.popleft()
            self._size -= self.event_size(e)
            if e.kind in ("encoded_stream", "decoded_stream"):
                self._streams -= 1
            self._not_full.notify_all()
            return e

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def clear(self) -> None:
        with self._lock:
            self._q.clear()
            self._size = 0
            self._streams = 0
            self._not_full.notify_all()


class EncodedAudioReservoir(Reservoir):
    """Byte-bounded encoded-audio buffer (EncodedAudioReservoir.cpp).
    Push blocks when the byte count is at capacity -> backpressure on the
    protocol thread (call stack §3.1)."""

    def __init__(self, capacity_bytes: int = ENCODED_RESERVOIR_BYTES,
                 max_streams: int = MAX_STREAMS, name: str = ""):
        super().__init__(capacity_bytes, name)
        self.max_streams = max_streams

    def event_size(self, e: ev.Event) -> int:
        return len(e.data) if e.kind == "encoded_audio" else 0

    def _block_if_full(self, e):
        if e.kind == "encoded_stream" and self._streams >= self.max_streams:
            return True
        return super()._block_if_full(e)


class DecodedAudioReservoir(Reservoir):
    """Jiffy-bounded decoded buffer with gorging
    (DecodedAudioReservoir.cpp:67-113): non-live streams buffer
    `gorge_jiffies` of audio before the first pull proceeds, so playback
    never starts into an empty pipe."""

    def __init__(self, capacity_jiffies: int = DECODED_RESERVOIR_JIFFIES,
                 gorge_jiffies: int = GORGE_JIFFIES,
                 max_streams: int = MAX_STREAMS, name: str = ""):
        super().__init__(capacity_jiffies, name)
        self.gorge_jiffies = gorge_jiffies
        self.max_streams = max_streams
        self._gorging = False
        self._gorge_full = threading.Event()
        self._gorge_full.set()

    def event_size(self, e: ev.Event) -> int:
        if isinstance(e, (ev.AudioPcmEvent, ev.AudioDsdEvent)):
            return e.jiffies
        if e.kind == "silence":
            return e.jiffies
        return 0

    def _start_gorge(self):
        self._gorging = True
        self._gorge_full.clear()

    def push(self, e: ev.Event) -> None:
        if e.kind == "mode":
            # gorge non-live pull-mode streams (reference keys this off the
            # mode's latency support)
            self._start_gorge()
        super().push(e)
        with self._lock:
            if self._gorging and self._size >= self.gorge_jiffies:
                self._gorging = False
                self._gorge_full.set()
        if e.kind in ("halt", "quit", "flush", "stream_interrupted"):
            # stream won't grow further; stop gorging
            self._gorging = False
            self._gorge_full.set()

    def pull(self) -> ev.Event:
        self._gorge_full.wait(timeout=5.0)
        return super().pull()

    def notify_starving(self) -> None:
        """Re-enter gorging after a starvation event (reference
        NotifyStarving path)."""
        self._start_gorge()
