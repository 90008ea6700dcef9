"""Sources: Playlist (track database), Radio (preset database), and the
UPnP-AV-style external-control source.

Parity targets: Av/Playlist/ (TrackDatabase max 1000 tracks, repeat/
shuffle, UriProviderPlaylist), Av/Radio/ (preset database, ProviderRadio),
Av/UpnpAv/ (externally-driven renderer source).  SURVEY.md §2.5.
"""

from __future__ import annotations

import random
import threading
from typing import Callable, Optional

from ..core.events import Track
from ..core.streaminfo import Latency
from ..pipeline.filler import UriProvider
from .product import Source

MAX_PLAYLIST_TRACKS = 1000   # ProviderPlaylist kMaxTracks
MAX_RADIO_PRESETS = 100


class TrackDatabase:
    """Ordered track store with id allocation (reference TrackDatabase,
    Av/Playlist/TrackDatabase.h)."""

    def __init__(self, max_tracks: int = MAX_PLAYLIST_TRACKS):
        self.max_tracks = max_tracks
        self._tracks: list[Track] = []
        self._next_id = 1
        self._lock = threading.RLock()
        self._observers: list[Callable[[], None]] = []
        self.seq = 0

    def add_observer(self, cb: Callable[[], None]) -> None:
        self._observers.append(cb)

    def _changed(self):
        self.seq += 1
        for cb in self._observers:
            cb()

    def insert(self, after_id: int, uri: str, metadata: str = "") -> int:
        with self._lock:
            if len(self._tracks) >= self.max_tracks:
                raise RuntimeError("playlist full")
            track = Track(uri, metadata, self._next_id)
            self._next_id += 1
            if after_id == 0:
                self._tracks.insert(0, track)
            else:
                idx = self._index_of(after_id)
                if idx is None:
                    raise KeyError(after_id)
                self._tracks.insert(idx + 1, track)
            self._changed()
            return track.id

    def delete(self, track_id: int) -> None:
        with self._lock:
            idx = self._index_of(track_id)
            if idx is not None:
                del self._tracks[idx]
                self._changed()

    def delete_all(self) -> None:
        with self._lock:
            self._tracks.clear()
            self._changed()

    def _index_of(self, track_id: int) -> Optional[int]:
        for i, t in enumerate(self._tracks):
            if t.id == track_id:
                return i
        return None

    def track_by_id(self, track_id: int) -> Optional[Track]:
        with self._lock:
            idx = self._index_of(track_id)
            return self._tracks[idx] if idx is not None else None

    def id_array(self) -> list[int]:
        with self._lock:
            return [t.id for t in self._tracks]

    def __len__(self) -> int:
        return len(self._tracks)

    def next_track(self, current_id: int, repeat: bool,
                   shuffle_order: Optional[list[int]] = None
                   ) -> Optional[Track]:
        with self._lock:
            order = shuffle_order or [t.id for t in self._tracks]
            if not order:
                return None
            if current_id == 0:
                return self.track_by_id(order[0])
            try:
                pos = order.index(current_id)
            except ValueError:
                return self.track_by_id(order[0])
            if pos + 1 < len(order):
                return self.track_by_id(order[pos + 1])
            return self.track_by_id(order[0]) if repeat else None

    def prev_track(self, current_id: int,
                   shuffle_order: Optional[list[int]] = None
                   ) -> Optional[Track]:
        with self._lock:
            order = shuffle_order or [t.id for t in self._tracks]
            if not order or current_id == 0:
                return None
            try:
                pos = order.index(current_id)
            except ValueError:
                return None
            return self.track_by_id(order[pos - 1]) if pos > 0 else None


class UriProviderPlaylist(UriProvider):
    """Track iterator over a TrackDatabase with repeat/shuffle
    (reference UriProviderPlaylist, Av/Playlist/UriProviderPlaylist.h)."""

    def __init__(self, db: TrackDatabase):
        super().__init__("Playlist", supports_pause=True, supports_next=True,
                         supports_prev=True, supports_repeat=True,
                         supports_random=True, supports_latency=Latency.NOT_SUPPORTED)
        self.db = db
        self.repeat = False
        self.shuffle = False
        self._shuffle_order: Optional[list[int]] = None
        self._current_id = 0
        self._pending_id: Optional[int] = None

    def set_repeat(self, on: bool) -> None:
        self.repeat = on

    def set_shuffle(self, on: bool) -> None:
        self.shuffle = on
        if on:
            order = self.db.id_array()
            random.shuffle(order)
            self._shuffle_order = order
        else:
            self._shuffle_order = None

    def begin(self, track_id: int) -> None:
        self._pending_id = track_id if track_id > 0 else None
        if track_id <= 0:
            self._current_id = 0

    def get_next(self) -> Optional[Track]:
        if self._pending_id is not None:
            t = self.db.track_by_id(self._pending_id)
            self._pending_id = None
            if t is not None:
                self._current_id = t.id
                return t
        order = self._shuffle_order if self.shuffle else None
        t = self.db.next_track(self._current_id, self.repeat, order)
        self._current_id = t.id if t else 0
        return t

    def current_track_id(self) -> int:
        return self._current_id

    def move_prev(self) -> bool:
        order = self._shuffle_order if self.shuffle else None
        t = self.db.prev_track(self._current_id, order)
        if t is None:
            return False
        self._pending_id = t.id
        return True


class SourcePlaylist(Source):
    """The Playlist source (reference SourcePlaylist.cpp)."""

    system_name = "Playlist"
    type = "Playlist"

    def __init__(self, pipeline_manager):
        super().__init__()
        self.db = TrackDatabase()
        self.provider = UriProviderPlaylist(self.db)
        self._pm = pipeline_manager
        pipeline_manager.add_provider(self.provider)

    def activate(self, auto_play: bool = False) -> None:
        super().activate(auto_play)
        self._pm.begin("Playlist", self.provider.current_track_id())
        if auto_play:
            self._pm.play()

    def seek_id(self, track_id: int) -> None:
        self._pm.begin("Playlist", track_id)
        self._pm.play()


class RadioPreset:
    def __init__(self, preset_id: int, uri: str, metadata: str = ""):
        self.id = preset_id
        self.uri = uri
        self.metadata = metadata


class PresetDatabase:
    """Numbered radio presets (reference Av/Radio/PresetDatabase.h)."""

    def __init__(self, max_presets: int = MAX_RADIO_PRESETS):
        self.max_presets = max_presets
        self._presets: dict[int, RadioPreset] = {}
        self.seq = 0

    def set_preset(self, index: int, uri: str, metadata: str = "") -> None:
        if not 0 <= index < self.max_presets:
            raise IndexError(index)
        self._presets[index] = RadioPreset(index + 1, uri, metadata)
        self.seq += 1

    def clear_preset(self, index: int) -> None:
        self._presets.pop(index, None)
        self.seq += 1

    def preset(self, index: int) -> Optional[RadioPreset]:
        return self._presets.get(index)

    def id_array(self) -> list[int]:
        return [self._presets[i].id if i in self._presets else 0
                for i in range(self.max_presets)]


class UriProviderRadio(UriProvider):
    """Single-station repeater (reference UriProviderRadio)."""

    def __init__(self, db: PresetDatabase):
        super().__init__("Radio", supports_pause=False, supports_next=False,
                         supports_prev=False)
        self.db = db
        self._track: Optional[Track] = None
        self._played = False

    def set_station(self, uri: str, metadata: str = "",
                    preset_id: int = 0) -> None:
        self._track = Track(uri, metadata, preset_id or 10000)
        self._played = False

    def begin(self, track_id: int) -> None:
        self._played = False

    def get_next(self) -> Optional[Track]:
        if self._track is None or self._played:
            return None
        self._played = True
        return self._track


class SourceRadio(Source):
    """The Radio source (reference SourceRadio.cpp + TuneIn hooks)."""

    system_name = "Radio"
    type = "Radio"

    def __init__(self, pipeline_manager):
        super().__init__()
        self.presets = PresetDatabase()
        self.provider = UriProviderRadio(self.presets)
        self._pm = pipeline_manager
        pipeline_manager.add_provider(self.provider)

    def activate(self, auto_play: bool = False) -> None:
        super().activate(auto_play)
        self._pm.begin("Radio")
        if auto_play:
            self._pm.play()

    def play_preset(self, index: int) -> None:
        p = self.presets.preset(index)
        if p is None:
            raise KeyError(index)
        self.provider.set_station(p.uri, p.metadata, p.id)
        self._pm.begin("Radio")
        self._pm.play()

    def play_uri(self, uri: str, metadata: str = "") -> None:
        self.provider.set_station(uri, metadata)
        self._pm.begin("Radio")
        self._pm.play()
