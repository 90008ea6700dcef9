"""Receiver-type sources: Songcast receiver, SCD receiver, UPnP-AV-style
externally-controlled source, and the RAOP (AirPlay) source scaffold.

Parity targets: Av/Songcast/SourceReceiver.cpp (mode "Receiver",
ProtocolOhm feeding the pipeline with external latency), Av/Scd/
(SourceScd), Av/UpnpAv/ (the classic MediaRenderer source where an
external controller sets the URI), Av/Raop/ (mDNS-advertised AirPlay
endpoint: RTSP handshake + RTP receive; the session plumbing lands here,
the RTSP/RTP wire protocol in a later round).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from ..core.events import ModeInfo, Track
from ..core.jiffies import Jiffies
from ..core.streaminfo import (EncodedStreamInfo, Latency,
                               PcmStreamInfo, SampleFormat)
from ..pipeline.filler import UriProviderSingleTrack
from ..protocols.base import Protocol, ProtocolStreamResult
from .product import Source


class _PcmPushProtocol(Protocol):
    """Protocol backing push-style receivers: a network thread calls
    `push_pcm`; `stream()` announces the raw-PCM format and relays bytes
    until stopped (the shape of ProtocolOhm/ProtocolScd/ProtocolRaat:
    network push -> SupplyAggregator)."""

    def __init__(self, scheme: str):
        super().__init__()
        self.name = scheme
        self.scheme = scheme
        self._fmt: Optional[PcmStreamInfo] = None
        self._latency_jiffies = 0
        self._buffer: list[bytes] = []
        self._cv = threading.Condition()
        self._stopped = False

    def recognise(self, uri: str) -> bool:
        return uri.startswith(f"{self.scheme}://")

    def set_format(self, fmt: PcmStreamInfo,
                   latency_ms: int = 0) -> None:
        with self._cv:
            self._fmt = fmt
            self._latency_jiffies = latency_ms * Jiffies.kPerMs
            self._cv.notify_all()

    def push_pcm(self, samples: np.ndarray) -> None:
        """(channels, n) int32 native range from the network thread."""
        from ..ops.pcm import pack_pcm_bytes
        if self._fmt is None:
            return
        data = pack_pcm_bytes(samples, self._fmt.bit_depth, big_endian=True)
        with self._cv:
            self._buffer.append(data)
            self._cv.notify_all()

    def push_halt(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()

    FORMAT_WAIT_S = 10.0

    def stream(self, uri: str) -> ProtocolStreamResult:
        import time as _time
        deadline = _time.monotonic() + self.FORMAT_WAIT_S
        with self._cv:
            self._stopped = False
            # the format announcement rides the first network audio; wait
            # for it (the reference blocks in its socket read the same way)
            while self._fmt is None and not self._stopped \
                    and not self.interrupted:
                if _time.monotonic() > deadline:
                    return ProtocolStreamResult.ERROR_UNRECOVERABLE
                self._cv.wait(0.1)
            fmt = self._fmt
        if fmt is None:
            return ProtocolStreamResult.STOPPED
        sid = self.next_stream_id()
        wire = {16: SampleFormat.S16_BE, 24: SampleFormat.S24_BE,
                32: SampleFormat.S32_BE}[fmt.bit_depth]
        self.supply.output_stream(
            EncodedStreamInfo(uri=uri, stream_id=sid, seekable=False,
                              live=True, pcm_format=fmt),
            stream_handler=self)
        if self._latency_jiffies:
            self.supply.output_delay(self._latency_jiffies)
        while True:
            with self._cv:
                while not self._buffer and not self._stopped \
                        and not self.interrupted:
                    self._cv.wait(0.1)
                if self._stopped or self.interrupted:
                    return ProtocolStreamResult.STOPPED
                chunk, self._buffer = self._buffer, []
            for data in chunk:
                self.supply.output_data(data)
            if hasattr(self.supply, "flush_pending"):
                self.supply.flush_pending()


class UriError(ValueError):
    """Invalid sender URI (the reference's UriError, surfaced by
    ProviderReceiver as error 800 'Invalid sender uri',
    ProviderReceiver.cpp:15-16)."""


class SourceReceiver(Source):
    """Songcast receiver source (SourceReceiver.cpp): mode "Receiver",
    external latency, sender URI selection; audio arrives over OHM and is
    re-broadcast by the Brancher when this device is also a sender.

    Full SetSender semantics (SourceReceiver.cpp:340-398): empty URI
    clears the sender; an ohz:// URI must target the OHZ multicast
    endpoint and carry a '/zone' path (else UriError) and switches the
    source to zone monitoring; any other URI is joined directly.  The
    chosen uri/metadata/zone persist in the store under Receiver.Uri /
    Receiver.Metadata / Receiver.Zone (cpp:214-230)."""

    system_name = "Receiver"
    type = "Receiver"

    # SourceReceiver.cpp:191
    PROTOCOL_INFO = "ohz:*:*:*,ohm:*:*:*,ohu:*.*.*"

    def __init__(self, pipeline_manager, multicast: bool = True,
                 sender_endpoint=None, store=None, zone_handler=None):
        super().__init__()
        self._pm = pipeline_manager
        self.protocol = _PcmPushProtocol("ohm")
        pipeline_manager.protocol_manager.add(self.protocol)
        self.provider = UriProviderSingleTrack(
            "Receiver", supports_latency=Latency.EXTERNAL,
            supports_pause=False)
        pipeline_manager.add_provider(self.provider)
        self._receiver = None
        self._multicast = multicast
        self._sender_endpoint = sender_endpoint
        self._store = store
        self._zone_handler = zone_handler
        self._lock = threading.Lock()
        self.playing = False
        self.uri = self._store_get("Receiver.Uri")
        self.metadata = self._store_get("Receiver.Metadata")
        self.zone = self._store_get("Receiver.Zone")
        self._track_uri = "" if self.zone else self.uri
        if zone_handler is not None:
            zone_handler.on_zone_uri = self._zone_uri_changed

    # -- store persistence (StoreText analogues, cpp:214-230) -------------
    def _store_get(self, key: str) -> str:
        if self._store is None:
            return ""
        try:
            return self._store.read(key).decode()
        except KeyError:
            return ""

    def _store_set(self, key: str, value: str) -> None:
        if self._store is not None:
            self._store.write(key, value.encode())

    # -- ISourceReceiver (ProviderReceiver.h:15-22) ------------------------
    def set_sender(self, uri: str = "ohm://239.253.1.1:51970",
                   metadata: str = "") -> None:
        from urllib.parse import urlparse
        from ..net.songcast import OHZ_MCAST, OHZ_PORT
        with self._lock:
            if uri and urlparse(uri).scheme == "ohz":
                # must target the OHZ multicast endpoint with a /zone
                # path (cpp:356-373)
                p = urlparse(uri)
                try:
                    host, port = p.hostname, p.port
                except ValueError:
                    raise UriError(uri)
                if host != OHZ_MCAST or port != OHZ_PORT:
                    raise UriError(uri)
                if len(p.path) < 2 or not p.path.startswith("/"):
                    raise UriError(uri)
                self._track_uri = ""
                self.zone = p.path[1:]
                self._store_set("Receiver.Zone", self.zone)
                if self.playing:
                    self._start_monitoring()
            else:
                self.zone = ""
                self._store_set("Receiver.Zone", "")
                self._stop_monitoring()
                self._track_uri = uri
                if uri and self.active:
                    self._uri_changed()
            self.uri, self.metadata = uri, metadata
            self._store_set("Receiver.Uri", uri)
            self._store_set("Receiver.Metadata", metadata)

    def sender_info(self) -> tuple[str, str]:
        """Persisted sender selection (SourceReceiver::SenderInfo,
        cpp:400-404)."""
        return (self._store_get("Receiver.Uri") if self._store else self.uri,
                self._store_get("Receiver.Metadata") if self._store
                else self.metadata)

    def play(self) -> None:
        """ProviderReceiver Play -> SourceReceiver::Play (cpp:307-327)."""
        if not self.active:
            self.activate(auto_play=False)
        with self._lock:
            self.playing = True
            if self.zone:
                self._start_monitoring()
            if self._track_uri:
                self._uri_changed()

    def stop(self) -> None:
        """ProviderReceiver Stop -> SourceReceiver::Stop (cpp:329-338)."""
        with self._lock:
            self.playing = False
            self._pm.stop()
            self._stop_monitoring()

    # -- zone monitoring (ZoneUriChanged, cpp:405-418) ---------------------
    def _start_monitoring(self) -> None:
        if self._zone_handler is not None and self.zone:
            self._zone_handler.query(self.zone)

    def _stop_monitoring(self) -> None:
        pass  # the handler keeps listening; we just ignore answers

    def _zone_uri_changed(self, zone: str, uri: str) -> None:
        with self._lock:
            if zone != self.zone or uri == self._track_uri or \
                    not self.playing:
                return
            self._track_uri = uri
            self._uri_changed()

    def _uri_changed(self) -> None:
        self.provider.set_track(Track(self._track_uri or self.uri,
                                      self.metadata, 9001))
        if self.active:
            self._pm.begin("Receiver")
            self._pm.play()

    def activate(self, auto_play: bool = False) -> None:
        super().activate(auto_play)
        from ..net.songcast import OhmReceiver
        if self.provider._track is None and (self._track_uri or self.uri):
            self.provider.set_track(Track(self._track_uri or self.uri,
                                          self.metadata, 9001))
        if self._receiver is None:
            self._receiver = OhmReceiver(
                self._on_audio, multicast=self._multicast,
                sender_endpoint=self._sender_endpoint,
                on_track=lambda uri, md: None,
                on_metatext=lambda t: None)
            self._receiver.start()
        self._pm.begin("Receiver")
        self._pm.play()
        self.playing = True

    def deactivate(self) -> None:
        super().deactivate()
        self.playing = False
        if self._receiver is not None:
            self._receiver.stop()
            self._receiver = None
        self.protocol.push_halt()

    def _on_audio(self, samples: np.ndarray, msg) -> None:
        if self.protocol._fmt is None \
                or self.protocol._fmt.sample_rate != msg.sample_rate:
            self.protocol.set_format(
                PcmStreamInfo(msg.sample_rate, msg.bit_depth, msg.channels,
                              codec_name="OHM", live=True),
                latency_ms=msg.media_latency // (44100 * 256 // 1000)
                if msg.media_latency else 100)
        self.protocol.push_pcm(samples)


class SourceScd(Source):
    """SCD receiver source (Av/Scd/SourceScd)."""

    system_name = "SCD"
    type = "Scd"

    def __init__(self, pipeline_manager):
        super().__init__()
        self._pm = pipeline_manager
        self.protocol = _PcmPushProtocol("scd")
        pipeline_manager.protocol_manager.add(self.protocol)
        self.provider = UriProviderSingleTrack("SCD", supports_pause=False)
        pipeline_manager.add_provider(self.provider)
        self._receiver = None

    def connect(self, host: str, port: int) -> None:
        from ..net.scd import ScdReceiver
        self.provider.set_track(Track(f"scd://{host}:{port}", "", 9002))

        def on_audio(samples, fmt):
            if self.protocol._fmt is None:
                self.protocol.set_format(PcmStreamInfo(
                    fmt.sample_rate, fmt.bit_depth, fmt.channels,
                    codec_name="SCD", live=fmt.live))
            self.protocol.push_pcm(samples)

        self._receiver = ScdReceiver(host, port, on_audio,
                                     on_halt=self.protocol.push_halt)
        self._receiver.start()
        self._pm.begin("SCD")
        self._pm.play()

    def deactivate(self) -> None:
        super().deactivate()
        if self._receiver:
            self._receiver.stop()
            self._receiver = None


class SourceUpnpAv(Source):
    """Externally-controlled renderer source (Av/UpnpAv/): a controller
    (AVTransport-style, here via ODP Transport.PlayUri) sets the URI and
    drives transport; playback uses the normal protocol stack."""

    system_name = "UpnpAv"
    type = "UpnpAv"

    def __init__(self, pipeline_manager):
        super().__init__()
        self._pm = pipeline_manager
        self.provider = UriProviderSingleTrack("UpnpAv",
                                               supports_pause=True)
        pipeline_manager.add_provider(self.provider)

    def set_uri(self, uri: str, metadata: str = "") -> None:
        self.provider.set_track(Track(uri, metadata, 9003))

    def play(self) -> None:
        self._pm.begin("UpnpAv")
        self._pm.play()

    def activate(self, auto_play: bool = False) -> None:
        super().activate(auto_play)
        self._pm.begin("UpnpAv")


class SourceRaop(Source):
    """AirPlay (RAOP) source (Av/Raop/): owns the RTSP/RTP endpoint
    (net.raop.RaopReceiver) and feeds decrypted ALAC-decoded PCM into the
    pipeline with the AirPlay latency.  `start_endpoint()` binds the RTSP
    listener; mDNS advertisement hooks onto FriendlyNameManager."""

    system_name = "Net Aux"
    type = "NetAux"

    def __init__(self, pipeline_manager, rsa_private_pem=None):
        super().__init__()
        self._pm = pipeline_manager
        self.protocol = _PcmPushProtocol("raop")
        pipeline_manager.protocol_manager.add(self.protocol)
        self.provider = UriProviderSingleTrack("RAOP", supports_pause=False,
                                               supports_latency=Latency.EXTERNAL)
        pipeline_manager.add_provider(self.provider)
        self.session_active = False
        self._rsa_pem = rsa_private_pem
        self.receiver = None

    def start_endpoint(self, port: int = 0) -> int:
        """Bind the RTSP listener; returns its port."""
        from ..net.raop import RaopReceiver
        self.receiver = RaopReceiver(self._on_rtp_audio,
                                     on_session=self._on_session,
                                     rsa_private_pem=self._rsa_pem,
                                     port=port)
        return self.receiver.rtsp_port

    def _on_session(self, session, event: str) -> None:
        if event == "record":
            rate = session.alac.sample_rate if session.alac else 44100
            depth = session.alac.bit_depth if session.alac else 16
            ch = session.alac.num_channels if session.alac else 2
            self.session_start(rate, bit_depth=depth, channels=ch)
        elif event == "teardown":
            self.session_end()

    def _on_rtp_audio(self, samples: np.ndarray) -> None:
        self.push_audio(samples)

    def session_start(self, sample_rate: int = 44100,
                      latency_ms: int = 150, bit_depth: int = 16,
                      channels: int = 2) -> None:
        self.session_active = True
        self.protocol.set_format(
            PcmStreamInfo(sample_rate, bit_depth, channels,
                          codec_name="RAOP", live=True),
            latency_ms=latency_ms)
        self.provider.set_track(Track("raop://session", "", 9004))
        self._pm.begin("RAOP")
        self._pm.play()

    def push_audio(self, samples: np.ndarray) -> None:
        self.protocol.push_pcm(samples)

    def session_end(self) -> None:
        self.session_active = False
        self.protocol.push_halt()

    def deactivate(self) -> None:
        super().deactivate()
        if self.receiver is not None:
            self.receiver.close()
            self.receiver = None
