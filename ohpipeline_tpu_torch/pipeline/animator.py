"""Animators: the render boundary that pulls the pipeline and feeds a DAC (or
a file or test sink).

Port of ``ohpipeline_tpu.pipeline.animator``.  ``RenderBatcher`` collects
the audio events of one pull quantum into an (events, channels, samples)
tile on its ``device`` and runs the port's ``ops.pcm.apply_gain`` on it, one
call for all of them; events with unity gain pass through bit-exactly, with
no device work.  The animators take a ``device`` where the JAX ones take
``use_device``; the CPU route is ``device="cpu"``.  ``AnimatorBasic`` also
counts its late quanta.  A :class:`DecodeFaultEvent` (the pump thread's
end after a device fault) is raised in the caller of ``AnimatorBatch.run``
or ``AnimatorBasic.join``.  ``AnimatorSongcastSender`` is not ported: it
needs the Songcast sender of the net layer.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from .. import _kernels
from ..host.core import events as ev
from ..host.core.jiffies import Jiffies
from ..host.pipeline.manager import DecodeFaultEvent
from ..ops import pcm as pcm_ops

_UNITY = pcm_ops.UNITY_ATTENUATION


class RenderBatcher:
    """Fuses a list of AudioPcmEvents into one gain pass on ``device``."""

    def __init__(self, device="cuda"):
        self.device = _kernels.checked_device(device)
        #: batches that ran the gain pass (the others were all unity)
        self.gain_tiles = 0

    def render(self, events: list[ev.AudioPcmEvent]) -> list[np.ndarray]:
        """Returns per-event (channels, n) int32 arrays, gains applied."""
        if not events:
            return []
        # fast path: all unity -> no math at all
        if all(not e.ramp.enabled and e.attenuation == _UNITY
               for e in events):
            return [e.samples for e in events]
        nmax = max(e.num_samples for e in events)
        C = max(e.samples.shape[0] for e in events)
        B = len(events)
        tile = np.zeros((B, C, nmax), np.int32)
        rs = np.ones(B, np.float32)
        re = np.ones(B, np.float32)
        gain = np.ones(B, np.float32)
        for i, e in enumerate(events):
            c, n = e.samples.shape
            tile[i, :c, :n] = e.samples
            if e.ramp.enabled:
                rs[i] = e.ramp.start / _UNITY
                re[i] = e.ramp.end / _UNITY
            gain[i] = e.attenuation / _UNITY
        args = [torch.from_numpy(a).to(self.device)
                for a in (tile, rs, re, gain)]
        out = pcm_ops.apply_gain(*args).cpu().numpy()
        self.gain_tiles += 1
        return [out[i, :e.samples.shape[0], :e.num_samples]
                for i, e in enumerate(events)]


class AnimatorBase:
    """Shared pull-and-render loop machinery."""

    def __init__(self, pipeline, sink: Callable[[np.ndarray, object], None],
                 device="cuda"):
        """sink(samples, stream_info) receives rendered (ch, n) arrays."""
        self.pipeline = pipeline
        self.sink = sink
        self.batcher = RenderBatcher(device)
        self.info = None
        self._quit = False

    def _handle(self, e: ev.Event, audio_batch: list) -> bool:
        """Returns False when the loop should stop; raises the error of a
        DecodeFaultEvent."""
        if isinstance(e, ev.AudioPcmEvent):
            audio_batch.append(e)
        elif isinstance(e, ev.AudioDsdEvent):
            # DSD bypasses the gain batcher (the reference never ramps DSD
            # samples — MuterVolume handles level; IDsdProcessor sink,
            # Msg.h:1204-1278).  Flush queued PCM first to keep ordering.
            self._flush(audio_batch)
            self.sink(e.data, e.info)
        elif e.kind == "silence" and self.info is not None:
            n = e.num_samples(self.info.sample_rate)
            if n > 0:
                audio_batch.append(ev.AudioPcmEvent(
                    np.zeros((self.info.num_channels, n), np.int32),
                    self.info))
        elif e.kind == "decoded_stream":
            self._flush(audio_batch)
            self.info = e.info
        elif e.kind == "drain":
            self._flush(audio_batch)
            e.report_drained()
        elif e.kind == "halt":
            self._flush(audio_batch)
            e.report_halted()
        elif e.kind == "quit":
            self._flush(audio_batch)
            if isinstance(e, DecodeFaultEvent):
                raise e.error
            return False
        return True

    def _flush(self, audio_batch: list) -> None:
        if not audio_batch:
            return
        rendered = self.batcher.render(audio_batch)
        for e, samples in zip(audio_batch, rendered):
            self.sink(samples, e.info)
        audio_batch.clear()

    def quit(self):
        self._quit = True


class AnimatorBatch(AnimatorBase):
    """Pulls as fast as possible until QuitEvent/HaltEvent — the batch/bench
    run mode."""

    def run(self, max_events: Optional[int] = None,
            stop_on_halt: bool = True) -> None:
        batch: list[ev.AudioPcmEvent] = []
        count = 0
        while not self._quit:
            e = self.pipeline.pull()
            count += 1
            if not self._handle(e, batch):
                break
            if e.kind == "halt" and stop_on_halt:
                break
            if len(batch) >= 64:
                self._flush(batch)
            if max_events is not None and count >= max_events:
                break
        self._flush(batch)


class AnimatorBasic(AnimatorBase):
    """Realtime cadenced animator (AnimatorBasic.cpp): a thread pulls
    `quantum_ms` of audio every `quantum_ms`, honouring a pullable clock.
    ``late_quanta`` counts the quanta whose deadline had passed when their
    render ended, ``worst_late_s`` the largest such lateness."""

    def __init__(self, pipeline, sink, quantum_ms: int = 5, device="cuda",
                 realtime: bool = True):
        super().__init__(pipeline, sink, device)
        self.quantum_ms = quantum_ms
        self.realtime = realtime
        self._thread: Optional[threading.Thread] = None
        self._clock_multiplier = 1.0   # IPullableClock (ClockPuller.h)
        self._error: Optional[BaseException] = None
        self.late_quanta = 0
        self.worst_late_s = 0.0

    def pull_clock(self, multiplier: float) -> None:
        """Fractional rate adjustment (reference IPullableClock::PullClock):
        the quantum's period is divided by it."""
        self._clock_multiplier = multiplier

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="Animator")
        self._thread.start()

    def join(self, timeout=None):
        """Waits for the render thread (up to ``timeout``) and raises what
        ended it, a DecodeFaultEvent's error included."""
        if self._thread:
            self._thread.join(timeout)
        if self._error is not None:
            raise self._error

    def is_alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _run(self) -> None:
        batch: list[ev.AudioPcmEvent] = []
        next_deadline = time.monotonic()
        quantum_jiffies = self.quantum_ms * Jiffies.kPerMs
        try:
            while not self._quit:
                pulled = 0
                while pulled < quantum_jiffies and not self._quit:
                    e = self.pipeline.pull()
                    if isinstance(e, (ev.AudioPcmEvent, ev.AudioDsdEvent)):
                        pulled += e.jiffies
                    elif e.kind == "silence":
                        pulled += e.jiffies
                    if not self._handle(e, batch):
                        self._quit = True
                        break
                self._flush(batch)
                if self.realtime:
                    period = ((self.quantum_ms / 1000.0)
                              / self._clock_multiplier)
                    next_deadline += period
                    delay = next_deadline - time.monotonic()
                    if delay > 0:
                        time.sleep(delay)
                    else:
                        self.late_quanta += 1
                        self.worst_late_s = max(self.worst_late_s, -delay)
                        next_deadline = time.monotonic()
        except BaseException as exc:                   # noqa: BLE001
            self._error = exc
        finally:
            self._quit = True


class Silencer:
    """Non-blocking upstream wrapper generating silence while the
    pipeline is halted (Media/Utils/Silencer.cpp): a thread pulls the
    (blocking) pipeline into a bounded queue; pull() hands out queued
    events when available, otherwise — once a stream format is known —
    a SilenceEvent of `silence_jiffies`.  Halt events are swallowed
    (cpp:100-106: "the driver presumably can't do anything with them").
    An exception on the thread ends it with a DecodeFaultEvent, which
    pull() hands out like any event."""

    def __init__(self, upstream, silence_jiffies: int = 5 * Jiffies.kPerMs,
                 max_events: int = 4):
        self._up = upstream
        self._q: "queue.Queue[ev.Event]" = queue.Queue(max_events)
        self._silence = silence_jiffies
        self._info = None
        self.halted = True
        self._quit = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="Silencer")
        self._thread.start()

    def _run(self) -> None:
        try:
            while not self._quit:
                e = self._up.pull()
                self._q.put(e)
                if e.kind == "quit":
                    break
        except BaseException as exc:                   # noqa: BLE001
            self._q.put(DecodeFaultEvent(exc))

    def pull(self) -> ev.Event:
        while True:
            if self._info is None or not self._q.empty():
                e = self._q.get()
                if e.kind == "halt":
                    self.halted = True
                    e.report_halted()
                    continue
                if e.kind == "decoded_stream":
                    self._info = e.info
                elif isinstance(e, ev.AudioPcmEvent):
                    self.halted = False
                elif e.kind == "quit":
                    self._quit = True
                return e
            return ev.SilenceEvent(self._silence, self._info)
