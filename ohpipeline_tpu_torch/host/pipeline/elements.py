"""Pipeline elements — the composable pull-model chain.

Parity targets: the element set of OpenHome/Media/Pipeline/ (SURVEY.md §2.1,
chain order from Pipeline.cpp:339-589).  Design stance (TPU-first): elements
are host-side event processors that *annotate* audio events (ramps, gains,
delays, drops); the sample math they imply executes in one fused batched
device program at the render boundary (ops.pcm.apply_gain et al.), so the
per-element cost here is O(events), never O(samples).

Every element implements `pull() -> Event` by pulling from its upstream and
transforming, exactly the reference's `IPipelineElementUpstream::Pull` chain
(Msg.h:1844).  Elements that split audio queue the remainder locally
(`self._defer`), mirroring the reference's per-element msg queues.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Optional

import numpy as np

from ..core import events as ev
from ..core.jiffies import Jiffies
from ..core.ramp import RAMP_MAX, RAMP_MIN, Ramp, RampDirection, set_ramp


class Element:
    """Base pull-model element (IPipelineElementUpstream)."""

    def __init__(self, upstream: "Element | None" = None, name: str = ""):
        self.upstream = upstream
        self.name = name or type(self).__name__
        self._deferred: deque[ev.Event] = deque()

    def _defer(self, event: ev.Event) -> None:
        """Queue an event to be returned by the next pull()s."""
        self._deferred.append(event)

    def _next(self) -> ev.Event:
        """Next input event: deferred first, else upstream."""
        if self._deferred:
            return self._deferred.popleft()
        return self.upstream.pull()

    def pull(self) -> ev.Event:
        return self._next()


class Pushable:
    """Downstream push interface (IPipelineElementDownstream::Push)."""

    def push(self, event: ev.Event) -> None:
        raise NotImplementedError


class Logger(Element):
    """Per-element msg tracer (Pipeline/Logger.h:10-40), filterable per
    event kind; insertable after every element via Pipeline assembly."""

    def __init__(self, upstream, name="", enabled=False, kinds=None,
                 sink: Callable[[str], None] = print):
        super().__init__(upstream, name)
        self.enabled = enabled
        self.kinds = set(kinds) if kinds else None
        self.sink = sink

    def pull(self):
        e = self._next()
        if self.enabled and (self.kinds is None or e.kind in self.kinds):
            self.sink(f"[{self.name}] {e.kind}")
        return e


class RampValidator(Element):
    """Runtime invariant checker: ramp continuity (RampValidator.cpp).
    The reference compiles these validators into the chain in debug
    pipelines (Pipeline.h:23-31); here they assert."""

    def __init__(self, upstream, name=""):
        super().__init__(upstream, name)
        self._last_end: Optional[int] = None

    def pull(self):
        e = self._next()
        if isinstance(e, (ev.AudioPcmEvent, ev.AudioDsdEvent)):
            r = e.ramp
            if r.enabled:
                if self._last_end is not None:
                    assert r.start == self._last_end, \
                        (f"{self.name}: ramp discontinuity "
                         f"{self._last_end} -> {r.start}")
                self._last_end = r.end if r.end not in (RAMP_MAX,) else None
            else:
                self._last_end = None
        elif e.kind in ("decoded_stream", "mode", "halt", "flush", "track"):
            self._last_end = None
        return e


class DecodedAudioValidator(Element):
    """Stream/audio consistency checker (DecodedAudioValidator.cpp)."""

    def __init__(self, upstream, name=""):
        super().__init__(upstream, name)
        self._info = None

    def pull(self):
        e = self._next()
        if e.kind == "decoded_stream":
            self._info = e.info
        elif isinstance(e, ev.AudioPcmEvent):
            assert self._info is not None, f"{self.name}: audio before stream"
            assert e.info.sample_rate == self._info.sample_rate, self.name
            assert e.samples.shape[0] == self._info.num_channels, self.name
        return e


class StreamValidator(Element):
    """Drops audio whose format the animator rejects (StreamValidator.cpp)."""

    def __init__(self, upstream,
                 supported: Callable[[ev.DecodedStreamEvent], bool] = lambda e: True,
                 name=""):
        super().__init__(upstream, name)
        self._supported = supported
        self._flushing = False

    def pull(self):
        while True:
            e = self._next()
            if e.kind == "decoded_stream":
                self._flushing = not self._supported(e)
                if self._flushing:
                    continue
            elif self._flushing and isinstance(e, ev.AUDIO_EVENT_TYPES):
                continue
            elif e.kind in ("mode", "track", "halt"):
                self._flushing = False
            return e


class DecodedAudioAggregator(Element):
    """Coalesce small decoded chunks up to 5ms blocks
    (DecodedAudioAggregator.cpp) so downstream tiling sees uniform sizes."""

    MAX_JIFFIES = 5 * Jiffies.kPerMs

    def __init__(self, upstream, name=""):
        super().__init__(upstream, name)
        self._held: Optional[ev.AudioPcmEvent] = None

    @staticmethod
    def _can_join(a: ev.AudioPcmEvent, b: ev.AudioPcmEvent) -> bool:
        return (a.info == b.info and not a.ramp.enabled
                and not b.ramp.enabled and a.attenuation == b.attenuation)

    def _flush_held(self) -> Optional[ev.AudioPcmEvent]:
        h, self._held = self._held, None
        return h

    def pull(self):
        while True:
            if self._deferred:
                return self._deferred.popleft()
            e = self.upstream.pull()
            if isinstance(e, ev.AudioPcmEvent):
                if self._held is None:
                    if e.jiffies >= self.MAX_JIFFIES or e.ramp.enabled:
                        return e
                    self._held = e
                    continue
                if self._can_join(self._held, e):
                    self._held = ev.AudioPcmEvent(
                        np.concatenate([self._held.samples, e.samples],
                                       axis=1),
                        self._held.info, self._held.track_offset_jiffies,
                        self._held.ramp, self._held.attenuation)
                    if self._held.jiffies >= self.MAX_JIFFIES:
                        return self._flush_held()
                    continue
                self._defer(e)
                return self._flush_held()
            if self._held is not None:
                self._defer(e)
                return self._flush_held()
            return e


class Attenuator(Element):
    """Songcast-slave attenuation (Attenuator.cpp), applied on device via
    the event's attenuation field; kUnityAttenuation = 1<<14."""

    def __init__(self, upstream, name=""):
        super().__init__(upstream, name)
        self.attenuation = 1 << 14
        self.active = False

    def set_attenuation(self, att: int) -> None:
        self.attenuation = max(0, min(att, 1 << 14))

    def pull(self):
        e = self._next()
        if self.active and isinstance(e, ev.AudioPcmEvent):
            e.attenuation = (e.attenuation * self.attenuation) >> 14
        return e


class TrackInspector(Element):
    """Notifies observers of tracks that fail to produce audio
    (TrackInspector.cpp; IStreamPlayObserver::NotifyTrackFailed)."""

    def __init__(self, upstream, name=""):
        super().__init__(upstream, name)
        self._observers: list[Callable[[ev.Track, bool], None]] = []
        self._track: Optional[ev.Track] = None
        self._seen_audio = False

    def add_observer(self, cb: Callable[[ev.Track, bool], None]) -> None:
        self._observers.append(cb)

    def _finish_track(self):
        if self._track is not None:
            for cb in self._observers:
                cb(self._track, self._seen_audio)
        self._track, self._seen_audio = None, False

    def pull(self):
        e = self._next()
        if e.kind == "track":
            self._finish_track()
            self._track = e.track
        elif isinstance(e, (ev.AudioPcmEvent, ev.AudioDsdEvent)):
            self._seen_audio = True
        elif e.kind in ("halt", "quit"):
            self._finish_track()
        return e


class PreDriver(Element):
    """Final normalisation before the animator (PreDriver.cpp): pass only
    what the animator consumes."""

    KEEP = frozenset(("audio_pcm", "audio_dsd", "silence", "decoded_stream",
                      "halt", "quit", "drain", "mode"))

    def pull(self):
        while True:
            e = self._next()
            if e.kind in self.KEEP:
                return e


class Ramper(Element):
    """Ramp up at the (re)start of a stream (Ramper.cpp): streams joining
    mid-track (sample_start > 0, non-live) get an up-ramp so the DAC
    doesn't click."""

    def __init__(self, upstream, ramp_jiffies=Jiffies.kPerMs * 500, name=""):
        super().__init__(upstream, name)
        self.ramp_jiffies = ramp_jiffies
        self._remaining = 0
        self._current = RAMP_MIN

    def pull(self):
        e = self._next()
        if e.kind == "decoded_stream":
            enabled = e.info.sample_start > 0 and not e.info.live
            self._remaining = self.ramp_jiffies if enabled else 0
            self._current = RAMP_MIN
        elif isinstance(e, ev.AudioPcmEvent) and self._remaining > 0:
            per = e.info.jiffies_per_sample
            if self._remaining < per:          # sub-sample tail: done
                self._remaining = 0
                return e
            if e.jiffies > self._remaining:
                left, right = e.split(self._remaining)
                self._defer(right)
                e = left
            ramp, _ = set_ramp(self._current, e.jiffies, self._remaining,
                               RampDirection.UP)
            self._remaining -= e.jiffies
            self._current = ramp.end
            return e.with_ramp(ramp)
        return e


class VolumeRamperElement(Element):
    """Analog-bypass volume ramping (VolumeRamper.cpp): when samples bypass
    the DSP path, ramps are applied by stepping volume instead."""

    def __init__(self, upstream, volume_ramper=None, name=""):
        super().__init__(upstream, name)
        self._vr = volume_ramper
        self._bypass = False

    def pull(self):
        e = self._next()
        if e.kind == "decoded_stream":
            self._bypass = e.info.analog_bypass
        elif self._bypass and isinstance(e, ev.AudioPcmEvent) \
                and self._vr is not None:
            self._vr.apply_multiplier(e.ramp.median_multiplier())
            e.ramp = Ramp()    # consumed by the volume path
        return e
