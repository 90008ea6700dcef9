"""Pins: numbered shortcut slots that replay a serialisable invocation.

Parity target: OpenHome/Av/Pins/Pins.h:64-257 — Pin records (mode, type,
uri, title, description, artwork, shuffle), a device pin set persisted to
the store, an account pin set hook, and IPinInvoker dispatch by mode; the
reference ships invokers for playlist/radio/TuneIn/Tidal/Qobuz/
CalmRadio/podcasts/transport/URLs — the local ones live here.
"""

from __future__ import annotations

import json
import threading
from dataclasses import asdict, dataclass, field
from typing import Callable, Optional

from .config import RamStore, StoreKeyNotFound

DEVICE_PINS = 6       # reference default device pin count
ACCOUNT_PINS = 10

ID_EMPTY = 0          # IPinIdProvider::kIdEmpty


class PinError(Exception):
    """Base pin failure (Pins.h THROW family)."""


class PinIndexOutOfRange(PinError, IndexError):
    """ProviderPins error 801 'Pin index out of range'."""


class PinIdNotFound(PinError, KeyError):
    """ProviderPins error 802 'Pin id not found'."""


class PinModeNotSupported(PinError, KeyError):
    """ProviderPins error 803 'Pin mode not supported'."""


class PinNothingToPlay(PinError):
    """ProviderPins error 805 'Nothing to Play'."""


class PinUriError(PinError, ValueError):
    """ProviderPins error 806 'Pin uri not supported'."""


@dataclass(slots=True)
class Pin:
    mode: str = ""        # invoker id: "playlist", "radio", "transport"...
    type: str = ""
    uri: str = ""
    title: str = ""
    description: str = ""
    artwork_uri: str = ""
    shuffle: bool = False
    #: unique non-zero id while the pin is set (Pin::iId; 0 = empty slot)
    id: int = ID_EMPTY

    @property
    def empty(self) -> bool:
        return not self.mode

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    def to_json_obj(self) -> dict:
        """The reference wire shape (Pin::Write, Pins.cpp:115-125):
        camelCase artworkUri."""
        return {"id": self.id, "mode": self.mode, "type": self.type,
                "uri": self.uri, "title": self.title,
                "description": self.description,
                "artworkUri": self.artwork_uri, "shuffle": self.shuffle}

    @staticmethod
    def from_json(raw: str) -> "Pin":
        try:
            return Pin(**json.loads(raw))
        except (ValueError, TypeError):
            return Pin()


class PinInvoker:
    """One pin mode handler (IPinInvoker, Pins.h:64)."""

    mode: str = "?"
    #: pin-URI versions this invoker accepts (IPinInvoker::SupportsVersion)
    supported_versions = (1,)

    def invoke(self, pin: Pin) -> None:
        raise NotImplementedError


class PinsManager:
    """Device pin set + invoker dispatch (PinsManager, Pins.h:180,
    Pins.cpp:542-700): unique non-zero ids per set pin (PinIdProvider),
    typed failures matching the ProviderPins error table, index- and
    id-addressed operations, and the reference's JSON wire shape.

    Design delta: the reference rejects any pin URI without a
    ``version=N`` query parameter (TryParsePinUriVersion); this build's
    local invokers (transport/url/radio) use bare URIs, so the version
    check applies only when the parameter is present."""

    def __init__(self, store: RamStore, device_pins: int = DEVICE_PINS):
        self._store = store
        self._pins = [Pin() for _ in range(device_pins)]
        self._invokers: dict[str, PinInvoker] = {}
        self._observers: list[Callable[[int], None]] = []
        self._lock = threading.RLock()
        self._next_id = ID_EMPTY
        for i in range(device_pins):
            try:
                self._pins[i] = Pin.from_json(
                    store.read(f"Pins.{i}").decode())
            except StoreKeyNotFound:
                pass
        self._next_id = max([p.id for p in self._pins] + [ID_EMPTY])

    def _fresh_id(self) -> int:
        """PinIdProvider::NextId (Pins.cpp:230-237): monotonic, never
        kIdEmpty."""
        self._next_id += 1
        if self._next_id == ID_EMPTY:
            self._next_id += 1
        return self._next_id

    def add_invoker(self, invoker: PinInvoker) -> None:
        self._invokers[invoker.mode] = invoker

    def modes(self) -> list[str]:
        return sorted(self._invokers)

    def add_observer(self, cb: Callable[[int], None]) -> None:
        self._observers.append(cb)

    def _notify(self, index: int) -> None:
        for cb in self._observers:
            cb(index)

    # -- pin set -----------------------------------------------------------
    def count(self) -> int:
        return len(self._pins)

    @property
    def device_max(self) -> int:
        return len(self._pins)

    @property
    def account_max(self) -> int:
        return 0   # account pin set hook not wired to a cloud setter

    def pin(self, index: int) -> Pin:
        with self._lock:
            self._check_index(index)
            return self._pins[index]

    def _check_index(self, index: int) -> None:
        if not 0 <= index < len(self._pins):
            raise PinIndexOutOfRange(index)

    def _check_uri(self, mode: str, uri: str) -> None:
        """PinsManager::Set URI validation (Pins.cpp:551-569): non-empty,
        and when a version parameter is present the invoker must support
        it (see class docstring for the bare-URI delta)."""
        if not uri:
            raise PinUriError("empty pin uri")
        from urllib.parse import parse_qs, urlparse
        q = parse_qs(urlparse(uri).query)
        if "version" in q:
            try:
                version = int(q["version"][0])
            except ValueError:
                raise PinUriError(uri) from None
            inv = self._invokers[mode]
            if version not in inv.supported_versions:
                raise PinUriError(uri)

    def set(self, index: int, mode: str, type: str = "", uri: str = "",
            title: str = "", description: str = "", artwork_uri: str = "",
            shuffle: bool = False) -> None:
        """ProviderPins SetDevice -> PinsManager::Set
        (Pins.cpp:542-585)."""
        if mode not in self._invokers:
            raise PinModeNotSupported(mode)
        self._check_uri(mode, uri)
        self._check_index(index)
        with self._lock:
            pin = Pin(mode, type, uri, title, description, artwork_uri,
                      shuffle, id=self._fresh_id())
            self._pins[index] = pin
            self._store.write(f"Pins.{index}", pin.to_json().encode())
        self._notify(index)

    def set_pin(self, index: int, pin: Pin) -> None:
        """Python-level convenience over set()/clear (empty pin
        clears)."""
        if pin.empty:
            self.clear_index(index)
            return
        self.set(index, pin.mode, pin.type, pin.uri, pin.title,
                 pin.description, pin.artwork_uri, pin.shuffle)

    def clear_index(self, index: int) -> None:
        with self._lock:
            self._check_index(index)
            self._pins[index] = Pin()
            self._store.write(f"Pins.{index}", Pin().to_json().encode())
        self._notify(index)

    clear_pin = clear_index

    def clear(self, pin_id: int) -> None:
        """ProviderPins Clear -> PinSet::Clear (Pins.cpp:300-313):
        by id, PinIdNotFound for kIdEmpty or unknown ids."""
        with self._lock:
            index = self._index_from_id(pin_id)
            self._pins[index] = Pin()
            self._store.write(f"Pins.{index}", Pin().to_json().encode())
        self._notify(index)

    def _index_from_id(self, pin_id: int) -> int:
        if pin_id == ID_EMPTY:
            raise PinIdNotFound(pin_id)
        for i, p in enumerate(self._pins):
            if p.id == pin_id:
                return i
        raise PinIdNotFound(pin_id)

    def swap(self, a: int, b: int) -> None:
        with self._lock:
            self._check_index(a)
            self._check_index(b)
            self._pins[a], self._pins[b] = self._pins[b], self._pins[a]
            self._store.write(f"Pins.{a}", self._pins[a].to_json().encode())
            self._store.write(f"Pins.{b}", self._pins[b].to_json().encode())
        self._notify(a)
        self._notify(b)

    # -- invocation --------------------------------------------------------
    def _begin_invoke(self, pin: Pin) -> None:
        """PinsManager::BeginInvoke (Pins.cpp:685): empty or unregistered
        mode -> PinModeNotSupported."""
        if not pin.mode:
            raise PinModeNotSupported("empty pin")
        invoker = self._invokers.get(pin.mode)
        if invoker is None:
            raise PinModeNotSupported(pin.mode)
        invoker.invoke(pin)

    def invoke_index(self, index: int) -> None:
        with self._lock:
            self._check_index(index)
            pin = self._pins[index]
        self._begin_invoke(pin)

    invoke = invoke_index

    def invoke_id(self, pin_id: int) -> None:
        with self._lock:
            pin = self._pins[self._index_from_id(pin_id)]
        self._begin_invoke(pin)

    def invoke_uri(self, mode: str, type: str = "", uri: str = "",
                   shuffle: bool = False) -> None:
        """One-shot invocation without touching the pin set
        (Pins.cpp:677-683)."""
        self._begin_invoke(Pin(mode, type, uri, shuffle=shuffle))

    # -- wire shapes (ProviderPins) ----------------------------------------
    def id_array(self) -> list[int]:
        """IdArray property: the slot->id mapping (PinSet::IdArray)."""
        with self._lock:
            return [p.id for p in self._pins]

    def write_json(self, ids: list[int]) -> str:
        """ReadList payload (PinsManager::WriteJson, Pins.cpp:632-646):
        unknown ids are silently skipped."""
        out = []
        with self._lock:
            for pin_id in ids:
                try:
                    out.append(self._pins[self._index_from_id(pin_id)]
                               .to_json_obj())
                except PinIdNotFound:
                    pass
        return json.dumps(out)


# -- local invokers (the reference's PinInvoker* family) ---------------------

class TransportPinInvoker(PinInvoker):
    """Play/pause/stop shortcuts (PinInvokerTransport)."""

    mode = "transport"

    def __init__(self, pipeline_manager):
        self._pm = pipeline_manager

    def invoke(self, pin: Pin) -> None:
        action = pin.uri or pin.type
        if action == "play":
            self._pm.play()
        elif action == "pause":
            self._pm.pause()
        elif action == "stop":
            self._pm.stop()
        else:
            raise ValueError(f"unknown transport pin {action!r}")


class UrlPinInvoker(PinInvoker):
    """Play an arbitrary URI (PinInvokerUrl)."""

    mode = "url"

    def __init__(self, pipeline_manager):
        self._pm = pipeline_manager

    def invoke(self, pin: Pin) -> None:
        self._pm.play_uri(pin.uri, pin.description)


class RadioPinInvoker(PinInvoker):
    """Play a radio preset or station URI (PinInvokerRadio)."""

    mode = "radio"

    def __init__(self, source_radio):
        self._radio = source_radio

    def invoke(self, pin: Pin) -> None:
        if pin.type == "preset":
            self._radio.play_preset(int(pin.uri))
        else:
            self._radio.play_uri(pin.uri, pin.description)


class PlaylistPinInvoker(PinInvoker):
    """Start the playlist source, optionally at a track and shuffled
    (PinInvokerPlaylist)."""

    mode = "playlist"

    def __init__(self, source_playlist, product):
        self._playlist = source_playlist
        self._product = product

    def invoke(self, pin: Pin) -> None:
        self._product.set_source_by_name(self._playlist.system_name)
        self._playlist.provider.set_shuffle(pin.shuffle)
        if pin.uri:
            self._playlist.seek_id(int(pin.uri))
        else:
            self._playlist._pm.play()


class ServiceCatalogPinInvoker(PinInvoker):
    """Streaming-service catalogue pins (TidalPins.cpp / QobuzPins.cpp):
    a pin like ``tidal://album/123`` or ``qobuz://playlist/9?shuffle=1``
    resolves the container to tracks through the service's catalogue
    client and loads them into the playlist source.

    ``browse(kind, ident)`` is the injected catalogue callable returning
    a list of ``TrackMetadata``; per-service invokers bind it to
    TidalCatalogue / QobuzCatalogue methods."""

    def __init__(self, mode: str, browse, source_playlist, product):
        self.mode = mode
        self._browse = browse
        self._playlist = source_playlist
        self._product = product

    def invoke(self, pin: Pin) -> None:
        from urllib.parse import urlparse
        from .misc import didl_lite
        u = urlparse(pin.uri)
        kind = u.netloc            # album / playlist / artist / track ...
        ident = u.path.lstrip("/")
        tracks = self._browse(kind, ident)
        if not tracks:
            # kCodeNothingToPlay 805 (ProviderPins.cpp:27-28)
            raise PinNothingToPlay(
                f"{self.mode} pin found no tracks: {pin.uri}")
        self._product.set_source_by_name(self._playlist.system_name)
        db = self._playlist.db
        db.delete_all()
        after = 0
        for md in tracks:
            after = db.insert(after, md.uri, didl_lite(md))
        self._playlist.provider.set_shuffle(pin.shuffle)
        self._playlist.activate(auto_play=True)


def tidal_pin_invoker(catalogue, token_id: str, source_playlist, product):
    """TidalPins: map pin kinds onto TidalCatalogue requests."""

    def browse(kind: str, ident: str):
        if kind == "album":
            return catalogue.album_tracks(ident, token_id)
        if kind == "playlist":
            return catalogue.playlist_tracks(ident, token_id)
        if kind == "artist":
            return catalogue.artist_top_tracks(ident, token_id)
        if kind == "favorites":
            return catalogue.favorite_tracks(ident, token_id)
        if kind == "genre":
            return catalogue.genre_tracks(ident, token_id)
        if kind == "track":
            return [catalogue.track(ident, token_id)]
        raise ValueError(f"unknown tidal pin kind {kind!r}")
    return ServiceCatalogPinInvoker("tidal", browse, source_playlist,
                                    product)


def qobuz_pin_invoker(catalogue, source_playlist, product):
    """QobuzPins: map pin kinds onto QobuzCatalogue requests."""

    def browse(kind: str, ident: str):
        if kind == "album":
            return catalogue.album_tracks(ident)
        if kind == "playlist":
            return catalogue.playlist_tracks(ident)
        if kind == "favorites":
            return catalogue.favorite_tracks()
        if kind == "track":
            return [catalogue.track(ident)]
        raise ValueError(f"unknown qobuz pin kind {kind!r}")
    return ServiceCatalogPinInvoker("qobuz", browse, source_playlist,
                                    product)
