"""Ops plumbing: reboot handling, fault codes, buffered device log.

Parity targets: Av/RebootHandler.h, Av/Utils/FaultCode.*, and
Av/Logger.h:23-76 (LoggerBuffered: ring-buffered log retained across the
serial link with an ILogPoster upload hook, surfaced via ProviderDebug).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Optional


class RebootHandler:
    """Pluggable reboot requester (RebootHandler.h): subsystems ask for a
    reboot with a reason; the platform integration performs it."""

    def __init__(self, reboot_fn: Optional[Callable[[str], None]] = None):
        self._reboot = reboot_fn
        self.requests: list[str] = []

    def reboot(self, reason: str) -> None:
        self.requests.append(reason)
        if self._reboot is not None:
            self._reboot(reason)


class FaultCode:
    """Registered fault conditions with set/clear semantics
    (Av/Utils/FaultCode.*)."""

    _codes: dict[str, "FaultCode"] = {}

    def __init__(self, name: str):
        if name in FaultCode._codes:
            raise ValueError(f"duplicate fault code {name}")
        self.name = name
        self.active = False
        self.detail = ""
        FaultCode._codes[name] = self

    def set(self, detail: str = "") -> None:
        self.active = True
        self.detail = detail

    def clear(self) -> None:
        self.active = False
        self.detail = ""

    @classmethod
    def active_faults(cls) -> list[tuple[str, str]]:
        return [(c.name, c.detail) for c in cls._codes.values() if c.active]

    @classmethod
    def reset_all(cls) -> None:
        cls._codes.clear()


class BufferedLog:
    """Ring-buffered log with category levels and an upload hook
    (LoggerBuffered + ILogPoster)."""

    def __init__(self, max_lines: int = 2048,
                 poster: Optional[Callable[[str], None]] = None):
        self._lines: collections.deque[str] = collections.deque(
            maxlen=max_lines)
        self._lock = threading.Lock()
        self._poster = poster
        self.levels: dict[str, bool] = {}

    def enable(self, category: str, on: bool = True) -> None:
        self.levels[category] = on

    def log(self, category: str, message: str) -> None:
        if not self.levels.get(category, True):
            return
        line = f"{time.strftime('%H:%M:%S')} [{category}] {message}"
        with self._lock:
            self._lines.append(line)

    def dump(self) -> str:
        with self._lock:
            return "\n".join(self._lines)

    def post(self) -> bool:
        """Upload the buffer through the poster (ProviderDebug's
        SendLog)."""
        if self._poster is None:
            return False
        self._poster(self.dump())
        return True
