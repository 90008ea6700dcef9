"""Pipeline assembly + PipelineManager facade.

Parity targets: Pipeline.cpp:339-589 (element construction order, optional
validator/logger wrapping via EPipelineSupportElements, Pipeline.h:23-31)
and PipelineManager.h:65-303 (Begin/Play/Pause/Wait/Stop/Seek/Next/Prev,
observer registry, wiring of Filler + IdManager + ProtocolManager).

Thread model (reference §2.7 stage parallelism): Filler thread pushes
through protocols into the encoded reservoir; a decode pump thread runs
the codec controller chain into the decoded reservoir; the animator thread
pulls the render chain.  Reservoir backpressure bounds each stage.

The port's copy of the JAX package's ``pipeline/manager.py``, with three
changes.  ``Pipeline`` and ``PipelineManager`` take the codec registry as an
argument (the port builds one for a device:
``ohpipeline_tpu_torch.codecs.default_registry``, passed in by the facade
``ohpipeline_tpu_torch.pipeline.PipelineManager``).  And an exception that
escapes the decode chain on the pump thread (a device fault, which the codec
controller does not turn into a stream interruption) is kept in
``Pipeline.fault`` and handed to the render side as a
:class:`DecodeFaultEvent`, which the animators raise, where the JAX pump
thread would die and leave the render side waiting.  And the pump thread's
push into the decoded reservoir is a ``pump.push`` span
(``ohpipeline_tpu_torch.tracing``): the time it blocks on a full reservoir.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass
from typing import Optional

from ..codecs.base import CodecRegistry
from ..core import events as ev
from ..core.jiffies import Jiffies
from ...tracing import span
from ..protocols import make_default_manager
from . import control
from .codec_controller import CodecController
from .control import (Drainer, Muter, Reporter, Seeker, Skipper, Stopper,
                      Waiter)
from .elements import (Attenuator, DecodedAudioAggregator,
                       DecodedAudioValidator, Element, Logger, PreDriver,
                       RampValidator, Ramper, StreamValidator, TrackInspector,
                       VolumeRamperElement)
from .filler import Filler, IdManager, UriProvider, UriProviderSingleTrack
from .reservoirs import DecodedAudioReservoir, EncodedAudioReservoir
from .starvation import StarvationRamper
from .supply import SupplyAggregator


@dataclass(frozen=True)
class DecodeFaultEvent(ev.QuitEvent):
    """The pump thread's end after an exception escaped the decode chain:
    a QuitEvent (so every element passes it on and the pipeline winds down)
    that carries the exception for the animator to raise."""
    error: Optional[BaseException] = None


class SupportElements(enum.Flag):
    """EPipelineSupportElements (Pipeline.h:23-31)."""
    NONE = 0
    VALIDATOR_MINIMAL = enum.auto()
    VALIDATOR_FULL = enum.auto()
    LOGGER = enum.auto()
    AUDIO_DUMPER = enum.auto()


class PipelineInitParams:
    """Buffer sizes / ramp durations / support elements
    (reference PipelineInitParams, Pipeline.h:33-110)."""

    def __init__(self):
        self.encoded_reservoir_bytes = 1536 * 1024
        self.decoded_reservoir_jiffies = 2000 * Jiffies.kPerMs
        self.gorge_jiffies = 1000 * Jiffies.kPerMs
        self.starvation_ramper_min_jiffies = 20 * Jiffies.kPerMs
        self.ramp_long_jiffies = control.RAMP_LONG
        self.ramp_short_jiffies = control.RAMP_SHORT
        self.ramp_emergency_jiffies = control.RAMP_EMERGENCY
        self.max_streams = 10
        self.support_elements = SupportElements.NONE
        self.threaded_starvation_ramper = True
        # reference default: observer callbacks marshalled off the audio
        # threads (PipelineElementObserverThread, ElementObserver.h:36);
        # tests may force synchronous delivery (ElementObserverSync)
        self.synchronous_observers = False


class PipelineState(enum.Enum):
    STOPPED = "stopped"
    PLAYING = "playing"
    PAUSED = "paused"
    BUFFERING = "buffering"
    WAITING = "waiting"


class Pipeline:
    """Owns construction order and the element chain (reference Pipeline,
    Pipeline.h:159-367)."""

    def __init__(self, params: Optional[PipelineInitParams],
                 codec_registry: CodecRegistry, observer=None):
        p = self.params = params or PipelineInitParams()
        self.encoded = EncodedAudioReservoir(p.encoded_reservoir_bytes,
                                             p.max_streams)
        self.supply = SupplyAggregator(self.encoded)
        self.id_manager = IdManager()

        def wrap(element: Element, name: str) -> Element:
            if p.support_elements & SupportElements.LOGGER:
                element = Logger(element, name=f"log:{name}", enabled=True)
            if p.support_elements & SupportElements.VALIDATOR_FULL:
                element = RampValidator(element, name=f"rampv:{name}")
                element = DecodedAudioValidator(element, name=f"dav:{name}")
            return element

        # decode chain (runs on the pump thread)
        self.codec_controller = CodecController(
            self.encoded, codec_registry)
        chain = wrap(self.codec_controller, "codec")
        chain = StreamValidator(chain)
        chain = wrap(DecodedAudioAggregator(chain), "aggregator")
        self._decode_chain = chain
        self.decoded = DecodedAudioReservoir(
            p.decoded_reservoir_jiffies, p.gorge_jiffies, p.max_streams)

        # render chain (runs on the animator thread); order mirrors
        # Pipeline.cpp:339-589
        from .branch import (AirplayReporter, AsyncTrackObserver,
                             Brancher, SampleReporter, SpotifyReporter)
        from .latency import PhaseAdjuster, StarterTimed, VariableDelay
        e: Element = self.decoded
        self.ramper = Ramper(e, p.ramp_long_jiffies)
        e = wrap(self.ramper, "ramper")
        self.seeker = Seeker(e, self.codec_controller.start_seek,
                             p.ramp_short_jiffies)
        e = wrap(self.seeker, "seeker")
        self.variable_delay_left = VariableDelay(e)
        e = wrap(self.variable_delay_left, "variabledelayL")
        self.track_inspector = TrackInspector(e)
        e = wrap(self.track_inspector, "trackinspector")
        self.skipper = Skipper(e, p.ramp_short_jiffies)
        e = wrap(self.skipper, "skipper")
        self.waiter = Waiter(e, p.ramp_short_jiffies,
                             observer=self._on_waiting)
        e = wrap(self.waiter, "waiter")
        self.stopper = Stopper(e, p.ramp_long_jiffies,
                               ok_to_play=self.id_manager.ok_to_play,
                               observer=self._on_stopper)
        e = wrap(self.stopper, "stopper")
        from .observer import ObserverSync, ObserverThread
        self.observer_thread = (ObserverSync()
                                if p.synchronous_observers
                                else ObserverThread())
        self.reporter = Reporter(e, observer_thread=self.observer_thread)
        e = wrap(self.reporter, "reporter")
        self.async_track_observer = AsyncTrackObserver(e)
        e = wrap(self.async_track_observer, "asynctrack")
        self.sample_reporter = SampleReporter(e)
        e = wrap(self.sample_reporter, "samplereporter")
        # distinct per-source position-correcting reporters, composed in
        # the reference order (Pipeline.cpp:479-483: AirplayReporter,
        # then SpotifyReporter, then the generic Reporter downstream)
        self.airplay_reporter = AirplayReporter(e)
        e = wrap(self.airplay_reporter, "airplayreporter")
        self.spotify_reporter = SpotifyReporter(e)
        e = wrap(self.spotify_reporter, "spotifyreporter")
        self.brancher_songcast = Brancher(e, "brancher-songcast")
        e = wrap(self.brancher_songcast, "brancherSongcast")
        self.attenuator = Attenuator(e)
        e = wrap(self.attenuator, "attenuator")
        self.variable_delay_right = VariableDelay(e)
        e = wrap(self.variable_delay_right, "variabledelayR")
        self.starvation = StarvationRamper(
            e, p.starvation_ramper_min_jiffies,
            on_starving=self._on_starving,
            threaded=p.threaded_starvation_ramper)
        e = wrap(self.starvation, "starvation")
        self.phase_adjuster = PhaseAdjuster(e)
        e = wrap(self.phase_adjuster, "phaseadjuster")
        self.starter_timed = StarterTimed(e)
        e = wrap(self.starter_timed, "startertimed")
        self.muter = Muter(e, p.ramp_short_jiffies)
        e = wrap(self.muter, "muter")
        self.volume_ramper = VolumeRamperElement(e)
        e = wrap(self.volume_ramper, "volumeramper")
        self.brancher_bt = Brancher(e, "brancher-bt", exclusive=True)
        e = wrap(self.brancher_bt, "brancherBt")
        self.drainer = Drainer(e)
        self.predriver = PreDriver(self.drainer)
        self._observer = observer
        self.state = PipelineState.STOPPED

        # decode pump thread: codec chain -> decoded reservoir
        self._pump_quit = False
        self.fault: Optional[BaseException] = None
        self._pump = threading.Thread(target=self._pump_loop, daemon=True,
                                      name="DecodePump")
        self._pump.start()

    # -- callbacks ---------------------------------------------------------
    def _on_stopper(self, state: str) -> None:
        self.state = {"playing": PipelineState.PLAYING,
                      "paused": PipelineState.PAUSED,
                      "stopped": PipelineState.STOPPED}.get(state, self.state)
        if self._observer:
            self._observer(self.state)

    def _on_waiting(self, waiting: bool) -> None:
        if waiting:
            self.state = PipelineState.WAITING
            if self._observer:
                self._observer(self.state)

    def _on_starving(self, starving: bool) -> None:
        if starving:
            self.decoded.notify_starving()

    # -- pump --------------------------------------------------------------
    def _pump_loop(self) -> None:
        try:
            while not self._pump_quit:
                e = self._decode_chain.pull()
                with span("pump.push"):
                    self.decoded.push(e)
                if e.kind == "quit":
                    break
        except BaseException as exc:                   # noqa: BLE001
            # the render side raises it (DecodeFaultEvent), so the fault
            # reaches the caller of the animator instead of a hang
            self.fault = exc
            self.decoded.push(DecodeFaultEvent(exc))

    # -- public ------------------------------------------------------------
    def pull(self) -> ev.Event:
        return self.predriver.pull()

    def quit(self) -> None:
        self._pump_quit = True
        self.stopper.quit()
        self.starvation.quit()
        self.encoded.close()
        self.decoded.close()
        if hasattr(self.observer_thread, "flush"):
            self.observer_thread.flush()
            self.observer_thread.quit()

    def flush_observers(self) -> None:
        if hasattr(self.observer_thread, "flush"):
            self.observer_thread.flush()


class PipelineManager:
    """Public facade (PipelineManager.h:65-303)."""

    def __init__(self, params: Optional[PipelineInitParams],
                 codec_registry: CodecRegistry,
                 protocol_manager_factory=None):
        self.pipeline = Pipeline(params, codec_registry,
                                 observer=self._on_state)
        factory = protocol_manager_factory or make_default_manager
        try:
            # IdManager is the stream-id provider so every stream a
            # protocol announces is paired with its track for OkToPlay
            # arbitration (IdManager.h:12)
            self.protocol_manager = factory(self.pipeline.supply,
                                            self.pipeline.id_manager)
        except TypeError:
            self.protocol_manager = factory(self.pipeline.supply)
        self.filler = Filler(self.pipeline.supply, self.protocol_manager,
                             self.pipeline.id_manager)
        self.filler.start()
        self._observers = []
        self._providers: dict[str, UriProvider] = {}
        self._default_provider = UriProviderSingleTrack("Default")
        self.add_provider(self._default_provider)
        self._next_track_id = 1

    # -- observers ---------------------------------------------------------
    def add_observer(self, obs) -> None:
        self._observers.append(obs)
        self.pipeline.reporter.add_observer(obs)

    def _on_state(self, state: PipelineState) -> None:
        for o in self._observers:
            fn = getattr(o, "notify_pipeline_state", None)
            if fn:
                fn(state)

    # -- modes/providers ---------------------------------------------------
    def add_provider(self, provider: UriProvider) -> None:
        self._providers[provider.mode] = provider

    def begin(self, mode: str, track_id: int = -1) -> None:
        provider = self._providers[mode]
        provider.begin(track_id)
        self.pipeline.filler_provider = provider
        self.filler.set_provider(provider)

    # -- transport ---------------------------------------------------------
    def play(self) -> None:
        self.filler.play()
        self.pipeline.stopper.play()

    def play_uri(self, uri: str, metadata: str = "") -> None:
        """Convenience: pin a single-track provider to `uri` and play."""
        track = ev.Track(uri, metadata, self._next_track_id)
        self._next_track_id += 1
        self._default_provider.set_track(track)
        self.begin("Default")
        self.play()

    def play_as(self, mode: str, command: str = "") -> None:
        """PipelineManager::PlayAs (PipelineManager.cpp:220-229): drop
        everything queued, switch to `mode` and play.  A 'track={json}'
        command pins the given track first (PlayAsCommandTrack,
        Av/TransportControl.cpp:73-93); modes whose provider cannot pin
        a single track play via the default single-track provider."""
        self.remove_all()
        if command.startswith("track="):
            import json as _json
            try:
                t = _json.loads(command[len("track="):])
                uri = t["uri"]
            except (ValueError, KeyError, TypeError):
                raise ValueError(f"bad PlayAs command {command!r}")
            provider = self._providers.get(mode)
            track = ev.Track(uri, t.get("metadata", ""),
                             self._next_track_id)
            self._next_track_id += 1
            if provider is not None and hasattr(provider, "set_track"):
                provider.set_track(track)
            else:
                self._default_provider.set_track(track)
                mode = "Default"
        self.begin(mode)
        self.play()

    def remove_all(self) -> None:
        """PipelineManager::RemoveAllLocked (cpp:305-316): stop the
        filler, invalidate queued streams, discard the current one."""
        self.filler.stop()
        self.pipeline.id_manager.invalidate_pending()
        self.pipeline.skipper.remove_current_stream()

    def stop_prefetch(self, mode: str, track_id: int = -1) -> None:
        """PipelineManager::StopPrefetch: flush everything, then queue
        `mode`'s track WITHOUT starting playback — the filler streams
        and the reservoirs fill while the Stopper keeps the sink
        silent until Play()."""
        self.remove_all()
        self.begin(mode, track_id)
        self.filler.play()

    def flush_quick(self, flush_id: int) -> None:
        """PipelineManager::FlushQuick (cpp:244-249): discard the
        current stream up to `flush_id` without the removal ramp."""
        self.pipeline.skipper.try_remove_stream(flush_id)

    def pause(self) -> None:
        self.pipeline.stopper.pause()

    def stop(self) -> None:
        self.pipeline.stopper.stop()
        self.filler.stop()
        # queued-but-unplayed streams must not start after a Stop
        # (reference PipelineManager::Stop -> IdManager invalidation)
        self.pipeline.id_manager.invalidate_pending()

    def wait(self, flush_id: int) -> None:
        """Go quiet until FlushEvent(flush_id) passes the Waiter
        (PipelineManager.h Wait(aFlushId))."""
        self.pipeline.waiter.wait(flush_id)

    def seek(self, stream_id: int, seconds: float,
             sample_rate: int) -> bool:
        return self.pipeline.seeker.seek(stream_id,
                                         int(seconds * sample_rate))

    def _skip(self, backwards: bool) -> None:
        provider = self.filler.provider
        if provider is not None:
            if backwards:
                if provider.mode_info.supports_prev:
                    provider.move_prev()
            elif provider.mode_info.supports_next:
                provider.move_next()
        self.pipeline.skipper.remove_current_stream()

    def next(self) -> None:
        self._skip(backwards=False)

    def prev(self) -> None:
        """Backward navigation of the active UriProvider (Filler.h:24-72
        TrackPrev) — NOT an alias of next()."""
        self._skip(backwards=True)

    def mute(self) -> None:
        self.pipeline.muter.mute()

    def unmute(self) -> None:
        self.pipeline.muter.unmute()

    def pull(self) -> ev.Event:
        return self.pipeline.pull()

    def flush_observers(self) -> None:
        """Wait for queued observer callbacks (tests/shutdown)."""
        self.pipeline.flush_observers()

    def quit(self) -> None:
        self.filler.quit()
        self.pipeline.quit()
