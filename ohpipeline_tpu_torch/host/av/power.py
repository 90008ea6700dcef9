"""Power / standby management.

Parity target: OpenHome/PowerManager.h:65-323 — priority-ordered power
handlers, standby level observers, store write-through on power events
(StoreInt/StoreText), periodic fs flush (FsFlushPeriodic.h).
"""

from __future__ import annotations

import threading
from typing import Callable

from .config import RamStore


class PowerManager:
    """Priority-ordered power-down/standby observer registry."""

    def __init__(self, store: RamStore):
        self._store = store
        self._power_handlers: list[tuple[int, Callable[[], None]]] = []
        self._standby_handlers: list[tuple[int, object]] = []
        self._lock = threading.Lock()
        self.standby = True

    # priorities: higher runs earlier on power-down (reference
    # kPowerPriorityHighest=100 ... Lowest=0)
    def register_power_handler(self, priority: int,
                               on_power_down: Callable[[], None]) -> None:
        with self._lock:
            self._power_handlers.append((priority, on_power_down))
            self._power_handlers.sort(key=lambda x: -x[0])

    def register_standby_handler(self, priority: int, handler) -> None:
        """handler provides standby_enabled()/standby_disabled()."""
        with self._lock:
            self._standby_handlers.append((priority, handler))
            self._standby_handlers.sort(key=lambda x: -x[0])

    def power_down(self) -> None:
        """Imminent power loss: flush everything (reference
        PowerManager::NotifyPowerDown)."""
        for _p, cb in list(self._power_handlers):
            cb()
        if hasattr(self._store, "flush"):
            self._store.flush()

    def standby_enable(self) -> None:
        if self.standby:
            return
        self.standby = True
        for _p, h in list(self._standby_handlers):
            h.standby_enabled()

    def standby_disable(self) -> None:
        if not self.standby:
            return
        self.standby = False
        for _p, h in list(self._standby_handlers):
            h.standby_disabled()


class StoreVal:
    """Write-through stored value persisted on power events
    (PowerManager.h:249-323 StoreInt/StoreText)."""

    def __init__(self, power: PowerManager, store: RamStore, key: str,
                 default: bytes):
        self._store = store
        self.key = key
        try:
            self._value = store.read(key)
        except KeyError:
            self._value = default
        power.register_power_handler(100, self._flush)

    @property
    def value(self) -> bytes:
        return self._value

    def set(self, value: bytes) -> None:
        self._value = value
        self._store.write(self.key, value)

    def _flush(self) -> None:
        self._store.write(self.key, self._value)
