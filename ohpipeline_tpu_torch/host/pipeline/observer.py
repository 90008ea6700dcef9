"""ObserverThread: marshals observer callbacks off the audio threads.

Parity target: PipelineElementObserverThread (ElementObserver.h:21-70) —
pipeline elements never run UI/network callbacks inline; they schedule
them onto this thread.  `ElementObserverSync` (the test double from
ElementObserver.h:70) runs callbacks inline.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable


class ObserverThread:
    def __init__(self, name: str = "PipelineObserver", max_events: int = 256):
        self._q: "queue.Queue[tuple]" = queue.Queue(max_events)
        self._quit = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._thread.start()

    def schedule(self, fn: Callable, *args) -> None:
        try:
            self._q.put_nowait((fn, args))
        except queue.Full:
            pass                      # observers must never stall audio

    def _run(self) -> None:
        while not self._quit:
            try:
                fn, args = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                fn(*args)
            except Exception:                              # noqa: BLE001
                pass                  # observer bugs can't kill the thread

    def flush(self, timeout: float = 2.0) -> None:
        import time
        deadline = time.monotonic() + timeout
        while not self._q.empty() and time.monotonic() < deadline:
            time.sleep(0.005)

    def quit(self) -> None:
        self._quit = True
        self._thread.join(1.0)


class ObserverSync:
    """Synchronous stand-in for tests (ElementObserverSync)."""

    def schedule(self, fn: Callable, *args) -> None:
        fn(*args)
