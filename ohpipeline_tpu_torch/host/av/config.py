"""Typed persistent configuration.

Parity targets: Configuration/ConfigManager.h:110-742 (ConfigNum,
ConfigChoice, ConfigText, ConfigTextChoice — bounds, choice mapping,
observer subscriptions, store-backed serialisation) and IStore.h
(IStoreReadWrite), PowerManager.h StoreVal write-through.

Keys are dotted strings (e.g. "Source.Playlist.Visible", Source.h:45-53).
"""

from __future__ import annotations

import json
import struct
import threading
from typing import Callable, Generic, Optional, TypeVar

T = TypeVar("T")


class StoreKeyNotFound(KeyError):
    pass


class RamStore:
    """In-memory IStoreReadWrite (reference ConfigRamStore, used by every
    test and as the cache layer of persistent stores)."""

    def __init__(self):
        self._data: dict[str, bytes] = {}
        self._lock = threading.Lock()

    def read(self, key: str) -> bytes:
        with self._lock:
            if key not in self._data:
                raise StoreKeyNotFound(key)
            return self._data[key]

    def write(self, key: str, value: bytes) -> None:
        with self._lock:
            self._data[key] = bytes(value)

    def delete(self, key: str) -> None:
        with self._lock:
            self._data.pop(key, None)

    def keys(self) -> list[str]:
        with self._lock:
            return sorted(self._data)


class FileStore(RamStore):
    """JSON-file-backed store with explicit flush (the reference pairs a
    RAM cache with periodic fs flush, FsFlushPeriodic.h)."""

    def __init__(self, path: str):
        super().__init__()
        self._path = path
        try:
            with open(path) as f:
                raw = json.load(f)
            self._data = {k: bytes.fromhex(v) for k, v in raw.items()}
        except (OSError, ValueError):
            pass

    def flush(self) -> None:
        with self._lock:
            raw = {k: v.hex() for k, v in self._data.items()}
        tmp = self._path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(raw, f)
        import os
        os.replace(tmp, self._path)


class ConfigValBase(Generic[T]):
    """A typed config value with observers + store persistence
    (ConfigManager.h:136-266)."""

    def __init__(self, manager: "ConfigManager", key: str, default: T):
        self.key = key
        self.default = default
        self._manager = manager
        self._observers: dict[int, Callable[[str, T], None]] = {}
        self._next_sub = 1
        self._lock = threading.Lock()
        self._value = self._load()
        manager._register(self)

    # -- serialisation hooks ----------------------------------------------
    def _serialise(self, value: T) -> bytes:
        raise NotImplementedError

    def _deserialise(self, data: bytes) -> T:
        raise NotImplementedError

    def _validate(self, value: T) -> T:
        return value

    def _load(self) -> T:
        try:
            return self._validate(
                self._deserialise(self._manager.store.read(self.key)))
        except (StoreKeyNotFound, ValueError, struct.error):
            return self.default

    # -- API ---------------------------------------------------------------
    @property
    def value(self) -> T:
        with self._lock:
            return self._value

    def set(self, value: T) -> bool:
        value = self._validate(value)
        with self._lock:
            if value == self._value:
                return False
            self._value = value
            observers = list(self._observers.values())
        self._manager.store.write(self.key, self._serialise(value))
        for cb in observers:
            cb(self.key, value)
        return True

    def subscribe(self, cb: Callable[[str, T], None]) -> int:
        with self._lock:
            sid = self._next_sub
            self._next_sub += 1
            self._observers[sid] = cb
        cb(self.key, self.value)      # initial callback, as the reference
        return sid

    def unsubscribe(self, sid: int) -> None:
        with self._lock:
            self._observers.pop(sid, None)


class ConfigNum(ConfigValBase[int]):
    """Bounded integer (ConfigManager.h:266)."""

    def __init__(self, manager, key, min_value: int, max_value: int,
                 default: int):
        self.min_value = min_value
        self.max_value = max_value
        super().__init__(manager, key, default)

    def _validate(self, value: int) -> int:
        value = int(value)
        if not self.min_value <= value <= self.max_value:
            raise ValueError(f"{self.key}: {value} out of "
                             f"[{self.min_value},{self.max_value}]")
        return value

    def _serialise(self, v: int) -> bytes:
        return struct.pack(">i", v)

    def _deserialise(self, d: bytes) -> int:
        return struct.unpack(">i", d)[0]


class ConfigChoice(ConfigValBase[int]):
    """Enumerated choice by id with display mapping
    (ConfigManager.h:345)."""

    def __init__(self, manager, key, choices: dict[int, str], default: int):
        self.choices = dict(choices)
        super().__init__(manager, key, default)

    def _validate(self, value: int) -> int:
        value = int(value)
        if value not in self.choices:
            raise ValueError(f"{self.key}: invalid choice {value}")
        return value

    def _serialise(self, v: int) -> bytes:
        return struct.pack(">I", v)

    def _deserialise(self, d: bytes) -> int:
        return struct.unpack(">I", d)[0]


class ConfigText(ConfigValBase[str]):
    """Bounded text (ConfigManager.h:501)."""

    def __init__(self, manager, key, max_length: int, default: str):
        self.max_length = max_length
        super().__init__(manager, key, default)

    def _validate(self, value: str) -> str:
        if len(value) > self.max_length:
            raise ValueError(f"{self.key}: too long")
        return value

    def _serialise(self, v: str) -> bytes:
        return v.encode()

    def _deserialise(self, d: bytes) -> str:
        return d.decode()


class ConfigTextChoice(ConfigValBase[str]):
    """Text constrained to an externally-supplied choice list
    (ConfigManager.h:550)."""

    def __init__(self, manager, key, choices_provider: Callable[[], list[str]],
                 default: str):
        self._choices = choices_provider
        super().__init__(manager, key, default)

    def _validate(self, value: str) -> str:
        choices = self._choices()
        if choices and value not in choices:
            raise ValueError(f"{self.key}: {value!r} not in choices")
        return value

    def _serialise(self, v: str) -> bytes:
        return v.encode()

    def _deserialise(self, d: bytes) -> str:
        return d.decode()


class ConfigManager:
    """Registry of config values over a store (ConfigManager.h:620-742)."""

    def __init__(self, store: Optional[RamStore] = None):
        self.store = store or RamStore()
        self._values: dict[str, ConfigValBase] = {}
        self._open = True

    def _register(self, val: ConfigValBase) -> None:
        if not self._open:
            raise RuntimeError("ConfigManager closed to registration")
        if val.key in self._values:
            raise ValueError(f"duplicate config key {val.key}")
        self._values[val.key] = val

    def close(self) -> None:
        """End of registration phase (reference Open/Close semantics)."""
        self._open = False

    def has(self, key: str) -> bool:
        return key in self._values

    def get(self, key: str) -> ConfigValBase:
        return self._values[key]

    def keys(self) -> list[str]:
        return sorted(self._values)

    def create_num(self, key, min_value, max_value, default) -> ConfigNum:
        return ConfigNum(self, key, min_value, max_value, default)

    def create_choice(self, key, choices, default) -> ConfigChoice:
        return ConfigChoice(self, key, choices, default)

    def create_text(self, key, max_length, default) -> ConfigText:
        return ConfigText(self, key, max_length, default)

    def print_all(self) -> str:
        """Debug dump (reference ConfigManager::Print)."""
        return "\n".join(f"{k} = {self._values[k].value!r}"
                         for k in self.keys())
