"""Filler, UriProvider, IdManager — the producer side of the pipeline.

Parity targets: Filler.cpp (the producer thread, Run loop at 331),
UriProvider (Filler.h:24-72), IdManager.cpp (stream/track id registry and
OkToPlay arbitration, IdManager.h:12).
"""

from __future__ import annotations

import threading
from typing import Optional

from ..core import events as ev
from ..core.streaminfo import Latency
from ..protocols.base import ProtocolManager, ProtocolStreamResult


class UriProvider:
    """Per-mode track iterator + transport capabilities (Filler.h:24-72)."""

    def __init__(self, mode: str, *, supports_latency=Latency.NOT_SUPPORTED,
                 supports_pause=True, supports_next=False,
                 supports_prev=False, supports_repeat=False,
                 supports_random=False, clock_puller=None):
        self.mode = mode
        self.mode_info = ev.ModeInfo(
            supports_latency=supports_latency, supports_pause=supports_pause,
            supports_next=supports_next, supports_prev=supports_prev,
            supports_repeat=supports_repeat,
            supports_random=supports_random)
        self.clock_puller = clock_puller

    def begin(self, track_id: int) -> None:
        """Position the iterator at track_id (reference Begin/BeginLater)."""

    def get_next(self) -> Optional[ev.Track]:
        raise NotImplementedError

    def current_track_id(self) -> int:
        return -1

    def move_next(self) -> bool:
        return False

    def move_prev(self) -> bool:
        return False


class UriProviderSingleTrack(UriProvider):
    """Plays one pinned track, optionally forever (reference
    UriProviderSingleTrack)."""

    def __init__(self, mode: str, **kw):
        super().__init__(mode, **kw)
        self._track: Optional[ev.Track] = None
        self._played = False

    def set_track(self, track: ev.Track) -> None:
        self._track = track
        self._played = False

    def begin(self, track_id: int) -> None:
        self._played = False

    def get_next(self) -> Optional[ev.Track]:
        if self._track is None or self._played:
            return None
        self._played = True
        return self._track

    def current_track_id(self) -> int:
        return self._track.id if self._track else -1


class UriProviderRepeater(UriProviderSingleTrack):
    """Replays its track forever (reference UriProviderRepeater — radio)."""

    def get_next(self) -> Optional[ev.Track]:
        return self._track


class IdManager:
    """stream-id <-> track-id registry + OkToPlay arbitration
    (IdManager.h:12).  Invalidation on skip/stop prevents stale streams
    from starting."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: list[tuple[int, int, str]] = []  # (track, stream, mode)
        self._invalid_after: Optional[tuple[str, int]] = None
        self._next_stream = 1
        self._active_track = 0
        self._active_mode = ""

    # -- IIdProvider (protocols call next_stream_id per stream) -------------
    def set_active_track(self, track_id: int, mode: str) -> None:
        """Filler announces the track it is about to stream; stream ids
        allocated while it is active pair with it (reference
        IdManager::NextStreamId pairing, IdManager.h:12)."""
        with self._lock:
            self._active_track = track_id
            self._active_mode = mode

    def next_stream_id(self) -> int:
        with self._lock:
            sid = self._next_stream
            self._next_stream += 1
            self._entries.append((self._active_track, sid,
                                  self._active_mode))
            return sid

    def invalidate_at(self, track_id: int) -> None:
        with self._lock:
            self._entries = [e for e in self._entries if e[0] != track_id]

    def invalidate_after(self, track_id: int) -> None:
        with self._lock:
            keep = []
            found = False
            for e in self._entries:
                if found:
                    continue
                keep.append(e)
                if e[0] == track_id:
                    found = True
            self._entries = keep

    def invalidate_all(self) -> None:
        with self._lock:
            self._entries.clear()

    def invalidate_pending(self) -> None:
        with self._lock:
            if self._entries:
                self._entries = self._entries[:1]

    def register(self, track_id: int, stream_id: int, mode: str) -> None:
        with self._lock:
            self._entries.append((track_id, stream_id, mode))

    def ok_to_play(self, stream_id: int) -> bool:
        with self._lock:
            for i, (t, s, m) in enumerate(self._entries):
                if s == stream_id:
                    # playing implies everything before it is done
                    self._entries = self._entries[i:]
                    return True
            return False


class Filler(threading.Thread):
    """The producer thread (Filler.cpp Run at 331): takes tracks from the
    active UriProvider, emits ModeEvent/TrackEvent, hands the uri to the
    ProtocolManager, repeats.  Blocks on `play` when idle."""

    def __init__(self, supply, protocol_manager: ProtocolManager,
                 id_manager: IdManager, name: str = "Filler"):
        super().__init__(daemon=True, name=name)
        self._supply = supply
        self._pm = protocol_manager
        self._ids = id_manager
        self._provider: Optional[UriProvider] = None
        self._pending_mode = False
        self._run = threading.Event()
        self._quit = False
        self._lock = threading.Lock()
        self._track_id = 0

    # -- control -----------------------------------------------------------
    def set_provider(self, provider: UriProvider) -> None:
        with self._lock:
            self._provider = provider
            self._pending_mode = True

    @property
    def provider(self) -> Optional[UriProvider]:
        with self._lock:
            return self._provider

    def play(self) -> None:
        self._run.set()

    def stop(self) -> None:
        self._run.clear()
        self._pm.interrupt()

    def quit(self) -> None:
        self._quit = True
        self._run.set()
        self._pm.interrupt()

    # -- thread ------------------------------------------------------------
    def run(self) -> None:
        while not self._quit:
            self._run.wait(timeout=0.1)
            if not self._run.is_set() or self._quit:
                continue
            with self._lock:
                provider = self._provider
                emit_mode = self._pending_mode
                self._pending_mode = False
            if provider is None:
                self._run.clear()
                continue
            if emit_mode:
                self._supply.output_mode(provider.mode, provider.mode_info,
                                         provider.clock_puller)
            track = provider.get_next()
            if track is None:
                # idle: emit halt and wait for another play
                self._supply.output_halt()
                self._run.clear()
                continue
            self._supply.output_track(track)
            self._ids.set_active_track(track.id, provider.mode)
            res = self._pm.do_stream(track.uri)
            if res is ProtocolStreamResult.ERROR_UNRECOVERABLE:
                self._supply.output_stream_interrupted()
        self._supply.output_quit()
