"""Control-flow pipeline elements: the Play/Pause/Stop, seek, skip, wait
state machines.

Parity targets: Stopper.cpp (728 LoC state machine), Skipper.cpp, Waiter.cpp,
Seeker.cpp, Muter.cpp, Drainer.cpp, Reporter.cpp from
OpenHome/Media/Pipeline/ (SURVEY.md §2.1 rows 9-16, 24).

All ramp math is annotation only (executed on device); blocking behaviour
(paused pipeline) uses a threading.Event exactly where the reference blocks
its pull thread on a semaphore.
"""

from __future__ import annotations

import enum
import threading
from typing import Callable, Optional

from ..core import events as ev
from ..core.jiffies import Jiffies
from ..core.ramp import RAMP_MAX, RAMP_MIN, Ramp, RampDirection, set_ramp
from .elements import Element

RAMP_LONG = 500 * Jiffies.kPerMs      # Pipeline.h:102 kLongRampDurationDefault
RAMP_SHORT = 50 * Jiffies.kPerMs      # Pipeline.h:103
RAMP_EMERGENCY = 20 * Jiffies.kPerMs  # Pipeline.h:104


class _RampEngine:
    """Shared ramp annotator: walks a ramp across successive audio events,
    splitting the event where the ramp completes."""

    def __init__(self, duration: int):
        self.duration = duration
        self.remaining = 0
        self.current = RAMP_MAX
        self.direction = RampDirection.NONE

    @property
    def active(self) -> bool:
        return self.direction is not RampDirection.NONE and self.remaining > 0

    def start(self, direction: RampDirection,
              duration: Optional[int] = None) -> None:
        self.direction = direction
        self.remaining = duration if duration is not None else self.duration
        self.current = RAMP_MAX if direction is RampDirection.DOWN else RAMP_MIN

    def cancel(self) -> None:
        self.direction = RampDirection.NONE
        self.remaining = 0

    def reverse(self, direction: RampDirection) -> bool:
        """Invert the running ramp in place: the remaining span flips to
        ``duration - remaining`` and the level carries (reference
        Stopper.cpp:58-66,117-121 "don't change iCurrentRampValue - just
        start ramp ... from whatever value it is already at";
        Muter.cpp:81-129 does the same).  Returns False when the old
        ramp had consumed nothing — the level already sits at the new
        direction's terminal value, so the caller jumps straight to the
        terminal state."""
        flipped = self.duration - self.remaining
        if flipped <= 0:
            self.cancel()
            return False
        self.direction = direction
        self.remaining = flipped
        return True

    def apply(self, e: ev.AudioPcmEvent, defer) -> tuple[ev.AudioPcmEvent, bool]:
        """Annotate `e` (splitting via defer(right)); returns (event, done).

        `remaining` is snapped to the sample grid so the final fragment
        lands exactly on the terminal multiplier (the reference rounds via
        Jiffies::RoundDown before Ramp::Set).
        """
        per = e.info.jiffies_per_sample
        if self.remaining % per:
            self.remaining = max(per, (self.remaining // per) * per)
        if e.jiffies > self.remaining:
            left, right = e.split(self.remaining)
            defer(right)
            e = left
        ramp, _ = set_ramp(self.current, e.jiffies, self.remaining,
                           self.direction)
        self.remaining -= e.jiffies
        done = self.remaining <= 0
        if done:
            # force the exact terminal value (integer division can leave
            # an off-by-a-few residue)
            terminal = (RAMP_MIN if self.direction
                        in (RampDirection.DOWN, RampDirection.MUTE)
                        else RAMP_MAX)
            ramp = Ramp(ramp.start, terminal, self.direction, True)
            self.cancel()
        self.current = ramp.end
        return e.with_ramp(ramp), done


class StopperState(enum.Enum):
    RUNNING = "running"
    RAMPING_DOWN = "ramping_down"
    RAMPING_UP = "ramping_up"
    PAUSED = "paused"
    STOPPED = "stopped"
    FLUSHING = "flushing"


class Stopper(Element):
    """Play/Pause/Stop state machine (Stopper.cpp:221-259).

    Pause: ramp down then block the pull thread; Play from paused: unblock
    and ramp up; Stop: ramp down, emit HaltEvent, then block until Play or
    a new stream.  Streams are admitted via `ok_to_play` (IdManager
    arbitration, reference `Stopper::ProcessMsgEncodedStream`/OkToPlay).
    """

    def __init__(self, upstream, ramp_jiffies=RAMP_LONG,
                 ok_to_play: Callable[[int], bool] = lambda sid: True,
                 observer: Optional[Callable[[str], None]] = None, name=""):
        super().__init__(upstream, name)
        self._ramp = _RampEngine(ramp_jiffies)
        self.state = StopperState.RUNNING
        self._ok_to_play = ok_to_play
        self._observer = observer or (lambda s: None)
        self._resume = threading.Event()
        self._resume.set()
        self._lock = threading.RLock()
        self._halt_pending = False
        self._ramp_on_pause = True
        self._flushing_stream = False   # stream refused by OkToPlay

    # -- control API (PipelineManager calls these) -------------------------
    def play(self) -> None:
        with self._lock:
            if self.state in (StopperState.PAUSED, StopperState.STOPPED):
                self.state = StopperState.RAMPING_UP
                self._ramp.start(RampDirection.UP)
                self._resume.set()
            elif self.state == StopperState.RAMPING_DOWN:
                # Stopper.cpp:58-66: reverse the ramp in place — the
                # level carries; restarting the up ramp from kMin made
                # the output jump mid-ramp (caught by the monkey test's
                # RampValidator as a discontinuity)
                if self._ramp.reverse(RampDirection.UP):
                    self.state = StopperState.RAMPING_UP
                else:
                    self.state = StopperState.RUNNING
            # Play() cancels any pending stop (Stopper.cpp:83,
            # iTargetHaltId = MsgHalt::kIdInvalid)
            self._halt_pending = False
            self._observer("playing")

    def pause(self, ramp: bool = True) -> None:
        with self._lock:
            if self.state == StopperState.RUNNING:
                self.state = StopperState.RAMPING_DOWN
                if ramp and self._ramp_on_pause:
                    self._ramp.start(RampDirection.DOWN)
                else:
                    self._ramp.cancel()
                    self._enter_paused()
            elif self.state == StopperState.RAMPING_UP:
                # Stopper.cpp:117-121: reverse the up ramp in place
                if not (ramp and self._ramp_on_pause):
                    self._ramp.cancel()
                    self._enter_paused()
                elif self._ramp.reverse(RampDirection.DOWN):
                    self.state = StopperState.RAMPING_DOWN
                else:
                    self._enter_paused()   # up ramp hadn't left silence

    def stop(self) -> None:
        with self._lock:
            if self.state in (StopperState.RUNNING,):
                self.state = StopperState.RAMPING_DOWN
                self._halt_pending = True
                self._ramp.start(RampDirection.DOWN)
            elif self.state == StopperState.RAMPING_DOWN:
                # a pause ramp in flight becomes a stop: the reference
                # records iTargetHaltId before the switch
                # (Stopper.cpp:131-139), so ramp completion halts
                self._halt_pending = True
            elif self.state == StopperState.RAMPING_UP:
                # Stopper.cpp:154-158: reverse down, level carries
                self._halt_pending = True
                if self._ramp.reverse(RampDirection.DOWN):
                    self.state = StopperState.RAMPING_DOWN
                else:
                    self._enter_paused()
            elif self.state == StopperState.PAUSED:
                self.state = StopperState.STOPPED
                self._halt_pending = True
                self._resume.set()

    def quit(self) -> None:
        with self._lock:
            self._resume.set()

    def _enter_paused(self):
        self.state = (StopperState.STOPPED if self._halt_pending
                      else StopperState.PAUSED)
        self._observer("paused" if self.state is StopperState.PAUSED
                       else "stopped")
        self._resume.clear()

    # -- pull --------------------------------------------------------------
    def pull(self):
        while True:
            with self._lock:
                blocked = not self._resume.is_set()
                halt_pending = self._halt_pending
            if blocked:
                if halt_pending:
                    self._halt_pending = False
                    return ev.HaltEvent()
                self._resume.wait()
                continue
            e = self._next()
            with self._lock:
                if e.kind == "mode":
                    self._flushing_stream = False
                elif e.kind == "decoded_stream":
                    # stream admission (Stopper.cpp:221-259): every new
                    # stream must be arbitrated via OkToPlay; refused
                    # streams are swallowed along with their audio.
                    if not self._ok_to_play(e.stream_id):
                        self._flushing_stream = True
                        continue
                    self._flushing_stream = False
                    if self.state in (StopperState.STOPPED,):
                        self.state = StopperState.RUNNING
                elif (isinstance(e, (ev.AudioPcmEvent, ev.AudioDsdEvent))
                      or e.kind == "silence") and self._flushing_stream:
                    continue
                elif isinstance(e, ev.AudioPcmEvent):
                    if self.state == StopperState.RAMPING_DOWN:
                        e, done = self._ramp.apply(e, self._defer)
                        if done:
                            self._enter_paused()
                        return e
                    if self.state == StopperState.RAMPING_UP:
                        e, done = self._ramp.apply(e, self._defer)
                        if done:
                            self.state = StopperState.RUNNING
                        return e
                    if self.state in (StopperState.PAUSED,
                                      StopperState.STOPPED):
                        self._defer(e)   # hold audio while blocked
                        continue
            return e


class Skipper(Element):
    """Ramp down and discard the current stream (Skipper.cpp) on
    Next/Prev/RemoveStream.  After the ramp, audio is discarded until the
    next flush/stream boundary."""

    def __init__(self, upstream, ramp_jiffies=RAMP_SHORT,
                 stream_handler=None, name=""):
        super().__init__(upstream, name)
        self._ramp = _RampEngine(ramp_jiffies)
        self._flushing = False
        self._flush_id = ev.FlushEvent.ID_INVALID
        self._stream_handler = stream_handler
        self._stream_id = 0
        self._lock = threading.RLock()

    def _try_stop_upstream(self) -> None:
        """Halt the protocol feeding the removed stream (Skipper.cpp calls
        IStreamHandler::TryStop); the returned flush id marks where the
        discard ends."""
        handler = self._stream_handler
        if handler is None:
            return
        fid = handler.try_stop(self._stream_id)
        if fid != ev.FlushEvent.ID_INVALID:
            self._flush_id = fid

    def remove_current_stream(self, ramp_down: bool = True) -> None:
        with self._lock:
            if ramp_down:
                self._ramp.start(RampDirection.DOWN)
            else:
                self._flushing = True
                self._try_stop_upstream()

    def try_remove_stream(self, flush_id: int) -> None:
        with self._lock:
            self._flushing = True
            self._flush_id = flush_id

    def pull(self):
        while True:
            e = self._next()
            with self._lock:
                if isinstance(e, ev.AudioPcmEvent):
                    if self._ramp.active:
                        e, done = self._ramp.apply(e, self._defer)
                        if done:
                            self._flushing = True
                            self._deferred.clear()
                            self._try_stop_upstream()
                        return e
                    if self._flushing:
                        continue
                elif e.kind in ("track", "mode", "encoded_stream",
                                "decoded_stream"):
                    if e.kind == "decoded_stream":
                        self._stream_handler = (e.stream_handler
                                                or self._stream_handler)
                        self._stream_id = e.stream_id
                    # a new stream cancels any pending removal — the
                    # ramp/flush applied to the PREVIOUS stream only
                    # (Skipper.cpp NewStream: iState -> eRunning); without
                    # this a RemoveAll issued while idle wedged the next
                    # played stream in the stale removal ramp
                    self._ramp.cancel()
                    self._flushing = False
                elif e.kind == "flush":
                    if e.id == self._flush_id:
                        self._flushing = False
                        self._flush_id = ev.FlushEvent.ID_INVALID
                elif e.kind in ("silence",) and self._flushing:
                    continue
            return e


class Waiter(Element):
    """Handles expected discontinuities (Waiter.cpp): a WaitEvent ramps
    down; the next audio/stream ramps back up."""

    def __init__(self, upstream, ramp_jiffies=RAMP_SHORT,
                 observer: Optional[Callable[[bool], None]] = None, name=""):
        super().__init__(upstream, name)
        self._down = _RampEngine(ramp_jiffies)
        self._up = _RampEngine(ramp_jiffies)
        self._waiting = False
        self._target_flush = ev.FlushEvent.ID_INVALID
        self._observer = observer or (lambda w: None)

    def wait(self, flush_id: int) -> None:
        """Render-side wait command (Waiter::Wait): ramp down, go quiet,
        and resume when FlushEvent(flush_id) passes (PipelineManager.h
        Wait(aFlushId))."""
        self._target_flush = flush_id
        if not self._waiting:
            self._down.start(RampDirection.DOWN)

    def pull(self):
        while True:
            e = self._next()
            if e.kind == "wait":
                if not self._waiting:
                    self._down.start(RampDirection.DOWN)
                return e
            if (e.kind == "flush"
                    and e.id == self._target_flush
                    and self._target_flush != ev.FlushEvent.ID_INVALID):
                self._target_flush = ev.FlushEvent.ID_INVALID
                if self._waiting:
                    self._waiting = False
                    self._observer(False)
                    self._up.start(RampDirection.UP)
                elif self._down.active:
                    self._down.cancel()
                continue            # consumed, as the reference Waiter does
            if e.kind in ("decoded_stream", "track", "stream_interrupted"):
                if self._waiting:
                    self._waiting = False
                    self._observer(False)
                    self._up.start(RampDirection.UP)
                return e
            if isinstance(e, ev.AudioPcmEvent):
                if self._down.active:
                    e, done = self._down.apply(e, self._defer)
                    if done:
                        self._waiting = True
                        self._observer(True)
                    return e
                if self._waiting:
                    # discard audio while waiting (reference replaces with
                    # silence at the StarvationRamper level)
                    continue
                if self._up.active:
                    e, _ = self._up.apply(e, self._defer)
                    return e
            return e


class Seeker(Element):
    """Seek orchestration (Seeker.cpp:63-330): ramp down -> StartSeek ->
    discard until FlushEvent(flush_id) -> ramp up."""

    def __init__(self, upstream, start_seek: Callable[[int, int], int],
                 ramp_jiffies=RAMP_SHORT, restreamer=None, name=""):
        """start_seek(stream_id, sample) -> flush_id (or FlushEvent.ID_INVALID
        on failure); restreamer: ISeekRestreamer fallback."""
        super().__init__(upstream, name)
        self._ramp = _RampEngine(ramp_jiffies)
        self._up = _RampEngine(ramp_jiffies)
        self._start_seek = start_seek
        self._restreamer = restreamer
        self._lock = threading.RLock()
        self._pending: Optional[tuple[int, int]] = None
        self._flush_id = ev.FlushEvent.ID_INVALID
        self._flushing = False
        self._fail_count = 0

    def seek(self, stream_id: int, sample: int) -> bool:
        with self._lock:
            if self._pending is not None or self._flushing:
                return False
            self._pending = (stream_id, sample)
            self._ramp.start(RampDirection.DOWN)
            return True

    def _fire_seek(self):
        stream_id, sample = self._pending
        self._pending = None
        fid = self._start_seek(stream_id, sample)
        if fid != ev.FlushEvent.ID_INVALID:
            self._flush_id = fid
            self._flushing = True
            self._fail_count = 0
        else:
            self._fail_count += 1
            if self._restreamer is not None and self._fail_count >= 3:
                self._restreamer.seek_restream(stream_id, sample)
            self._up.start(RampDirection.UP)

    def pull(self):
        while True:
            e = self._next()
            with self._lock:
                if isinstance(e, ev.AudioPcmEvent):
                    if self._ramp.active:
                        e, done = self._ramp.apply(e, self._defer)
                        if done:
                            self._deferred.clear()
                            self._fire_seek()
                        return e
                    if self._flushing:
                        continue
                    if self._up.active:
                        e, _ = self._up.apply(e, self._defer)
                        return e
                elif e.kind == "flush" and e.id == self._flush_id:
                    self._flushing = False
                    self._flush_id = ev.FlushEvent.ID_INVALID
                    self._up.start(RampDirection.UP)
                    continue
                elif e.kind == "decoded_stream" and self._flushing:
                    # new stream announcement after seek carries new
                    # sample_start; pass it on and resume
                    self._flushing = False
                    self._up.start(RampDirection.UP)
            return e


class Muter(Element):
    """Sample-ramp mute (Muter.cpp): mute ramps audio to zero then marks
    subsequent audio muted; unmute ramps back.  A mid-ramp call inverts
    the running ramp in place — the remaining span flips to
    ``duration - remaining`` and the current value carries, mirroring
    Muter.cpp:75-87,110-129."""

    def __init__(self, upstream, ramp_jiffies=RAMP_SHORT, name=""):
        super().__init__(upstream, name)
        self._ramp = _RampEngine(ramp_jiffies)
        self.muted = False
        self._lock = threading.RLock()

    def _invert(self, direction: RampDirection) -> bool:
        """Flip the running ramp; False when it had consumed nothing
        (already sitting at the new direction's start level)."""
        return self._ramp.reverse(direction)

    def mute(self):
        with self._lock:
            if self.muted:
                return
            if self._ramp.active:
                if self._ramp.direction is RampDirection.UP \
                        and not self._invert(RampDirection.DOWN):
                    self.muted = True     # up-ramp hadn't left silence yet
                return
            self._ramp.start(RampDirection.DOWN)

    def unmute(self):
        with self._lock:
            if self._ramp.active:
                if self._ramp.direction is RampDirection.DOWN:
                    # cancel an in-flight mute: ramp back up from the
                    # level already reached (or stay at full level if
                    # the down ramp hadn't consumed anything)
                    self.muted = False
                    self._invert(RampDirection.UP)
                return
            if self.muted:
                self.muted = False
                self._ramp.start(RampDirection.UP)

    def pull(self):
        e = self._next()
        if isinstance(e, ev.AudioPcmEvent):
            with self._lock:
                if self._ramp.active:
                    # capture before apply(): completion cancels the
                    # engine (direction -> NONE), and reading it after
                    # re-muted the pipeline at every UNMUTE completion
                    direction = self._ramp.direction
                    e, done = self._ramp.apply(e, self._defer)
                    if done and direction is RampDirection.DOWN:
                        self.muted = True
                    return e
                if self.muted:
                    return e.with_ramp(Ramp.muted())
        return e


class Drainer(Element):
    """Emits DrainEvent and waits for the animator's acknowledgement before
    passing further audio (Drainer.cpp) so format changes never glitch."""

    def __init__(self, upstream, name=""):
        super().__init__(upstream, name)
        self._drain_done = threading.Event()
        self._drain_done.set()
        self._armed = False

    def arm(self) -> None:
        """Request a drain before the next audio event."""
        self._armed = True

    def pull(self):
        if self._armed:
            self._armed = False
            self._drain_done.clear()
            return ev.DrainEvent(callback=self._drain_done.set)
        self._drain_done.wait()
        e = self._next()
        if e.kind == "halt":
            # a halt implies the pipeline may go quiet; drain afterwards
            self._armed = True
        return e


class DecodedStreamView:
    """Observer view of a decoded-stream announcement: the PcmStreamInfo
    plus the stream id (the reference's DecodedStreamInfo carries
    StreamId, Msg.h:833, which IPipelineObserver::NotifyStreamInfo
    consumers like ProviderTransport rely on)."""

    __slots__ = ("info", "stream_id")

    def __init__(self, info, stream_id: int):
        self.info = info
        self.stream_id = stream_id

    def __getattr__(self, name):
        return getattr(self.info, name)


class Reporter(Element):
    """Feeds IPipelineObserver equivalents (Reporter.cpp): track, metatext
    and per-second time callbacks, marshalled off the audio thread by
    ObserverThread (ElementObserver.h)."""

    def __init__(self, upstream, observer_thread=None, name=""):
        super().__init__(upstream, name)
        self._observers = []
        self._ot = observer_thread
        self._info = None
        self._track = None
        self._mode = ""
        self._last_second = -1
        self._offset_jiffies = 0

    def add_observer(self, obs) -> None:
        self._observers.append(obs)

    def _emit(self, fn_name, *args):
        for o in self._observers:
            fn = getattr(o, fn_name, None)
            if fn is None:
                continue
            if self._ot is not None:
                self._ot.schedule(fn, *args)
            else:
                fn(*args)

    def pull(self):
        e = self._next()
        if e.kind == "mode":
            self._mode = e.mode
            self._emit("notify_mode", e.mode, e.info)
        elif e.kind == "track":
            self._track = e.track
            self._emit("notify_track", e.track, e.start_of_stream)
        elif e.kind == "metatext":
            self._emit("notify_metatext", e.text)
        elif e.kind == "decoded_stream":
            self._info = e.info
            self._offset_jiffies = (e.info.sample_start
                                    * e.info.jiffies_per_sample)
            self._emit("notify_stream_info",
                       DecodedStreamView(e.info, e.stream_id))
            self._last_second = -1
        elif isinstance(e, ev.AudioPcmEvent) and self._info is not None:
            self._offset_jiffies += e.jiffies
            sec = self._offset_jiffies // Jiffies.kPerSecond
            if sec != self._last_second:
                self._last_second = sec
                self._emit("notify_time", int(sec),
                           self._info.track_length_jiffies
                           // Jiffies.kPerSecond)
        return e
