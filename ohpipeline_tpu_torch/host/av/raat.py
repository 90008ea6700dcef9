"""Roon RAAT source: protocol push layer + transport/volume/signal-path
bridges.

Parity target: OpenHome/Av/Raat/ (3,688 LoC) — ProtocolRaat
(ProtocolRaat.h:25-60: RAAT pushes decoded PCM/DSD into a
SupplyAggregator, with DsdFiller block chunking), RaatTransport
(Transport.cpp: Roon transport controls <-> pipeline state),
RaatVolume (Volume.cpp) and RaatSignalPath (SignalPath.h).

SDK boundary: the reference links Roon's proprietary `raat` SDK
(projectdata/dependencies.json:130) for discovery/handshake/transport
framing.  That SDK is not redistributable, so this module implements
everything ABOVE the SDK against the small `IRaatReader`-shaped duck
interface (stream_format/notify_ready/read/interrupt, mirroring
Output.h:42-50); a real SDK binding drops in as one adapter class.
tests/test_raat.py drives it with a mock peer.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from ..core import events as ev
from ..core.jiffies import Jiffies
from ..core.streaminfo import AudioFormat, Latency, PcmStreamInfo
from ..core.events import Track
from ..pipeline.filler import UriProviderSingleTrack
from ..protocols.base import Protocol, ProtocolStreamResult
from .product import Source

RAAT_URI = "raat://raat"
DSD_BLOCK_BYTES = 4          # ProtocolRaat::kDsdBlockBytes
DEFAULT_DELAY_MS = 150       # ProtocolRaat::kDefaultDelayMs
DSD_SILENCE = 0x69           # DsdFiller kSilenceByte


@dataclass(slots=True)
class RaatStreamFormat:
    """RaatStreamFormat (Output.h:75)."""
    audio_format: AudioFormat = AudioFormat.PCM
    sample_rate: int = 44100
    bit_depth: int = 16
    num_channels: int = 2

    def pcm_info(self) -> PcmStreamInfo:
        return PcmStreamInfo(
            sample_rate=self.sample_rate,
            bit_depth=1 if self.audio_format is AudioFormat.DSD
            else self.bit_depth,
            num_channels=self.num_channels, codec_name="RAAT",
            lossless=True, seekable=False, live=True,
            audio_format=self.audio_format)


class ProtocolRaat(Protocol):
    """ProtocolRaat (ProtocolRaat.h:25): pull-from-RAAT push-to-pipeline
    with DSD block chunking and drain/flush state transitions."""

    name = "RAAT"

    def __init__(self, raat_reader):
        super().__init__()
        self._reader = raat_reader
        self._stream_id = 0
        self._stop = False
        self._flush_id = 0
        self._next_flush = 3000
        self._dsd_pending = b""

    def recognise(self, uri: str) -> bool:
        return uri.startswith("raat://")

    def try_stop(self, stream_id: int) -> int:
        with self._lock:
            if stream_id != self._stream_id:
                return ev.FlushEvent.ID_INVALID
            self._stop = True
            self._flush_id = self._next_flush
            self._next_flush += 1
            self._reader.interrupt()
            return self._flush_id

    # -- IRaatWriter (the reader pushes through this) ------------------------
    def write(self, data: bytes) -> None:
        if self._fmt.audio_format is AudioFormat.DSD:
            self._write_dsd(data)
        else:
            self.supply.output_data(data)

    def _write_dsd(self, data: bytes) -> None:
        """DsdFiller chunking: emit only whole blocks of
        DSD_BLOCK_BYTES * channels; remainder carried to the next push."""
        buf = self._dsd_pending + data
        block = DSD_BLOCK_BYTES * self._fmt.num_channels
        whole = len(buf) - (len(buf) % block)
        if whole:
            self.supply.output_data(buf[:whole])
        self._dsd_pending = buf[whole:]

    def _flush_dsd(self) -> None:
        """Pad the trailing partial block with DSD silence (DsdFiller
        flush semantics) so downstream block parsing never misaligns."""
        if not self._dsd_pending:
            return
        block = DSD_BLOCK_BYTES * self._fmt.num_channels
        pad = block - len(self._dsd_pending)
        self.supply.output_data(self._dsd_pending
                                + bytes([DSD_SILENCE]) * pad)
        self._dsd_pending = b""

    # -- streaming -----------------------------------------------------------
    def stream(self, uri: str) -> ProtocolStreamResult:
        self._stop = False
        self.interrupt(False)
        fmt: RaatStreamFormat = self._reader.stream_format()
        if fmt is None:
            return ProtocolStreamResult.ERROR_UNRECOVERABLE
        self._fmt = fmt
        self._dsd_pending = b""
        with self._lock:
            self._stream_id = self.next_stream_id()
        from ..core.streaminfo import EncodedStreamInfo
        self.supply.output_stream(
            EncodedStreamInfo(
                uri=uri, total_bytes=0, stream_id=self._stream_id,
                seekable=False, live=True, pcm_format=fmt.pcm_info()),
            stream_handler=self)
        self.supply.output_delay(DEFAULT_DELAY_MS * Jiffies.kPerMs)
        self._reader.notify_ready()
        while True:
            if self.interrupted:
                self._flush_dsd()
                return ProtocolStreamResult.STOPPED
            with self._lock:
                if self._stop:
                    self._flush_dsd()
                    self.supply.output_flush(self._flush_id)
                    return ProtocolStreamResult.STOPPED
            more = self._reader.read(self)
            if not more:
                break
        self._flush_dsd()
        with self._lock:
            if self._stop:          # TryStop raced the reader's EOF
                self.supply.output_flush(self._flush_id)
                return ProtocolStreamResult.STOPPED
        if hasattr(self.supply, "flush_pending"):
            self.supply.flush_pending()
        return ProtocolStreamResult.SUCCESS


class RaatTransportBridge:
    """RaatTransport (Transport.cpp): Roon transport controls drive the
    pipeline; pipeline state updates flow back as RAAT transport info."""

    def __init__(self, pipeline_manager,
                 notify: Optional[Callable[[dict], None]] = None):
        self._pm = pipeline_manager
        self._notify = notify or (lambda info: None)
        self._state = "stopped"
        pipeline_manager.add_observer(self)

    # controls from the RAAT side
    def play(self) -> None:
        self._pm.play()

    def pause(self) -> None:
        self._pm.pause()

    def stop(self) -> None:
        self._pm.stop()

    def next(self) -> None:
        self._pm.next()

    def previous(self) -> None:
        self._pm.prev()

    # pipeline observer -> RAAT transport info
    def notify_pipeline_state(self, state) -> None:
        self._state = getattr(state, "value", str(state))
        self._notify({"loop": "disabled", "shuffle": False,
                      "state": {"playing": "playing",
                                "paused": "paused",
                                "buffering": "loading"}.get(self._state,
                                                            "stopped")})

    @property
    def state(self) -> str:
        return self._state


class RaatVolumeBridge:
    """RaatVolume (Volume.cpp): Roon's 0..1 volume scale mapped onto the
    VolumeManager, with change notifications back to the peer."""

    def __init__(self, volume_manager,
                 notify: Optional[Callable[[float], None]] = None):
        self._vm = volume_manager
        self._notify = notify or (lambda v: None)
        volume_manager.add_observer(self._on_volume)

    def set_volume(self, fraction: float) -> None:
        vmax = self._vm.profile.max_volume
        self._vm.set_volume(int(round(max(0.0, min(1.0, fraction))
                                      * vmax)))

    def volume(self) -> float:
        return self._vm.volume / self._vm.profile.max_volume

    def set_mute(self, mute: bool) -> None:
        if mute:
            self._vm.mute()
        else:
            self._vm.unmute()

    def _on_volume(self, value: int) -> None:
        self._notify(value / self._vm.profile.max_volume)


@dataclass(slots=True)
class RaatSignalPath:
    """RaatSignalPath (SignalPath.h): advertised output chain flags."""
    exakt: bool = False
    space_optimisation: bool = False
    amplifier: bool = True
    output: str = "speakers"


class SourceRaat(Source):
    """SourceRaat (SourceRaat.cpp): owns the RAAT protocol + bridges."""

    system_name = "Roon"
    type = "Raat"

    def __init__(self, pipeline_manager, raat_reader, volume_manager=None,
                 transport_notify=None, volume_notify=None):
        super().__init__()
        self._pm = pipeline_manager
        self.protocol = ProtocolRaat(raat_reader)
        pipeline_manager.protocol_manager.add(self.protocol)
        self.provider = UriProviderSingleTrack(
            "RAAT", supports_latency=Latency.EXTERNAL,
            supports_pause=True, supports_next=True, supports_prev=True)
        pipeline_manager.add_provider(self.provider)
        self.transport = RaatTransportBridge(pipeline_manager,
                                             transport_notify)
        self.volume = RaatVolumeBridge(volume_manager, volume_notify) \
            if volume_manager is not None else None
        self.signal_path = RaatSignalPath()

    def activate(self, auto_play: bool = False) -> None:
        super().activate(auto_play)
        self.provider.set_track(Track(RAAT_URI, "", 9004))
        self._pm.begin("RAAT")
        if auto_play:
            self._pm.play()
