"""Branching and async-source elements: Brancher, SenderThread,
AsyncTrackObserver, SpotifyReporter/AirplayReporter, AudioDumper.

Parity targets: Brancher.h:69-127 (tee cloning msgs to an attached branch
— the Songcast sender attach point, SourceReceiver.cpp:520-531),
SenderThread.cpp (decouples the branch from pipeline timing),
AsyncTrackObserver.cpp (out-of-band track/metadata injection),
SpotifyReporter/AirplayReporter (sample-counting + out-of-band track
change), AudioDumper (debug tap writing encoded audio to disk).

The port's copy of the JAX package's ``pipeline/branch.py`` without
``IciBranch``, the multiroom fan-out over a device mesh, which is the
port's ``pipeline/branch.py`` (on ``parallel.room_fanout``).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

import numpy as np

from ..core import events as ev
from ..core import jiffies
from .elements import Element, Pushable


class Brancher(Element):
    """Tee: passes events downstream unchanged while cloning them to an
    attached branch (exclusive=True detaches the main path instead — the
    Bluetooth-offload variant)."""

    def __init__(self, upstream, name: str = "", exclusive: bool = False):
        super().__init__(upstream, name)
        self._branch: Optional[Pushable] = None
        self.exclusive = exclusive
        self._lock = threading.Lock()

    def attach(self, branch: Pushable) -> None:
        with self._lock:
            self._branch = branch

    def detach(self) -> None:
        with self._lock:
            self._branch = None

    def pull(self) -> ev.Event:
        e = self._next()
        with self._lock:
            branch = self._branch
        if branch is not None:
            if isinstance(e, ev.AudioPcmEvent):
                clone = ev.AudioPcmEvent(e.samples, e.info,
                                         e.track_offset_jiffies, e.ramp,
                                         e.attenuation)
                branch.push(clone)
            elif e.kind in ("decoded_stream", "track", "metatext", "halt",
                            "mode", "drain"):
                branch.push(e)
            if self.exclusive and isinstance(e, ev.AudioPcmEvent):
                return ev.SilenceEvent(e.jiffies, e.info)
        return e


class SenderThread(Pushable):
    """Decouples a pipeline branch from audio-thread timing
    (SenderThread.cpp): events are queued and drained by a worker that
    feeds the sink (e.g. net.songcast.OhmSender)."""

    def __init__(self, sink: Callable[[ev.Event], None],
                 max_events: int = 256, name: str = "SenderThread"):
        self._sink = sink
        self._q: "queue.Queue[ev.Event]" = queue.Queue(max_events)
        self._quit = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=name)
        self._thread.start()

    def push(self, event: ev.Event) -> None:
        try:
            self._q.put_nowait(event)
        except queue.Full:
            # sender slower than realtime: drop oldest (the reference
            # discards when its fifo fills rather than stalling audio)
            try:
                self._q.get_nowait()
                self._q.put_nowait(event)
            except queue.Empty:
                pass

    def _run(self) -> None:
        while not self._quit:
            try:
                e = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            self._sink(e)
            if e.kind == "quit":
                break

    def quit(self) -> None:
        self._quit = True
        self._thread.join(1.0)


class SongcastBranch(Pushable):
    """Glue: pipeline branch events -> net.songcast.OhmSender frames
    (the reference's Sender element, Av/Songcast/Sender)."""

    FRAME_SAMPLES = 1024

    def __init__(self, sender):
        self._sender = sender
        self._info = None
        self._pending = None
        self._sample_pos = 0

    def push(self, e: ev.Event) -> None:
        if e.kind == "decoded_stream":
            self._info = e.info
        elif e.kind == "track":
            self._sender.send_track(e.track.uri, e.track.metadata)
        elif e.kind == "metatext":
            self._sender.send_metatext(e.text)
        elif isinstance(e, ev.AudioPcmEvent) and self._info is not None:
            samples = e.samples
            if self._pending is not None:
                samples = np.concatenate([self._pending, samples], axis=1)
            pos = 0
            while samples.shape[1] - pos >= self.FRAME_SAMPLES:
                chunk = samples[:, pos:pos + self.FRAME_SAMPLES]
                self._sender.send_audio(
                    chunk, self._info.sample_rate, self._info.bit_depth,
                    sample_start=self._sample_pos)
                self._sample_pos += self.FRAME_SAMPLES
                pos += self.FRAME_SAMPLES
            self._pending = samples[:, pos:] if pos < samples.shape[1] \
                else None
        elif e.kind == "halt":
            if self._pending is not None and self._info is not None:
                self._sender.send_audio(self._pending,
                                        self._info.sample_rate,
                                        self._info.bit_depth,
                                        sample_start=self._sample_pos,
                                        halt=True)
                self._pending = None


class AsyncTrackObserver(Element):
    """Out-of-band track/metadata injection for async sources
    (AsyncTrackObserver.cpp): external callers post track/metadata that
    get emitted at the next pull boundary."""

    def __init__(self, upstream, name=""):
        super().__init__(upstream, name)
        self._lock = threading.Lock()
        self._pending: list[ev.Event] = []

    def track_changed(self, uri: str, metadata: str = "") -> None:
        with self._lock:
            self._pending.append(ev.TrackEvent(ev.Track(uri, metadata)))

    def metadata_changed(self, text: str) -> None:
        with self._lock:
            self._pending.append(ev.MetaTextEvent(text))

    def pull(self) -> ev.Event:
        with self._lock:
            if self._pending:
                return self._pending.pop(0)
        return self._next()


class _StartOffset:
    """Start offset in ms with sample conversion and absolute diff
    (SpotifyReporter.cpp:62-90 StartOffset)."""

    def __init__(self):
        self.ms = 0

    def set_ms(self, offset_ms: int) -> None:
        self.ms = int(offset_ms)

    def offset_sample(self, sample_rate: int) -> int:
        return self.ms * sample_rate // 1000

    def absolute_diff(self, offset_ms: int) -> int:
        return abs(self.ms - int(offset_ms))


class InterceptReporter(Element):
    """Shared SpotifyReporter/AirplayReporter core (SpotifyReporter.cpp,
    AirplayReporter.cpp): intercepts one pipeline mode and corrects the
    stream's position metadata from the source's out-of-band timeline.

    Because async sources push audio before track offset/duration are
    known, the element regenerates MsgDecodedStream with the true start
    offset + metadata duration (CreateMsgDecodedStreamLocked,
    SpotifyReporter.cpp:519-537), emits a generated MsgTrack carrying
    the source's metadata (start_of_stream=False so downstream stream
    detection is not re-entered), and counts decoded samples so the
    source can map pipeline time back to its own clock.

    Out-of-band surface: metadata_changed / track_offset_changed (a
    track change or seek moved the timeline) / track_position (periodic
    sync; regenerates the stream only when drifted beyond the 2000 ms
    threshold, SpotifyReporter.h:117) / flush (suspend counting until
    the MsgFlush passes)."""

    INTERCEPT_MODE = ""
    OFFSET_CHANGE_THRESHOLD_MS = 2000

    def __init__(self, upstream, name=""):
        super().__init__(upstream, name)
        self._lock = threading.RLock()
        self._intercept = False
        self._track_uri = ""
        self._pipeline_track_seen = False
        self._generated_track_pending = False
        self._stream_pending = False
        self._start_offset = _StartOffset()
        self._stream: Optional[ev.DecodedStreamEvent] = None
        self._metadata: Optional[dict] = None
        self._duration_ms = 0            # from out-of-band metadata
        self._duration_ms_stream = 0     # from the decoded stream
        self._pending_flush_id = ev.FlushEvent.ID_INVALID
        self.sample_count = 0            # frames since stream start

    # -- out-of-band surface (ISpotifyTrackObserver analogues) ---------
    def metadata_changed(self, metadata: Optional[dict]) -> None:
        with self._lock:
            self._metadata = metadata
            if metadata is not None:
                self._duration_ms = int(metadata.get("duration_ms", 0))
            self._generated_track_pending = True
            self._stream_pending = True

    def track_offset_changed(self, offset_ms: int) -> None:
        with self._lock:
            self._stream_pending = True
            self._start_offset.set_ms(offset_ms)

    def track_position(self, position_ms: int) -> None:
        with self._lock:
            if self._start_offset.absolute_diff(position_ms) \
                    > self.OFFSET_CHANGE_THRESHOLD_MS:
                self._stream_pending = True
            self._start_offset.set_ms(position_ms)

    def flush(self, flush_id: int) -> None:
        with self._lock:
            self._pending_flush_id = flush_id
            self._on_flush_requested()

    def _on_flush_requested(self) -> None:
        pass

    # -- hooks for the subclasses --------------------------------------
    def _didl(self, info) -> str:
        return ""

    def _on_track(self, prev_uri: str) -> None:
        pass

    def _on_stream(self, info) -> None:
        pass

    def _on_audio_locked(self) -> None:
        pass

    def _count(self, num_samples: int, num_channels: int) -> None:
        self.sample_count += num_samples

    def _reset_counts(self) -> None:
        self.sample_count = 0

    @property
    def track_position_ms(self) -> int:
        with self._lock:
            if self._stream is None:
                return 0
            rate = self._stream.info.sample_rate
            return self.sample_count * 1000 // rate if rate else 0

    # -- pipeline element ----------------------------------------------
    def pull(self) -> ev.Event:
        while True:
            with self._lock:
                if self._intercept and self._pipeline_track_seen \
                        and self._stream is not None:
                    if self._generated_track_pending:
                        # generated MsgTrack with the out-of-band
                        # metadata; start_of_stream False (Pull(),
                        # SpotifyReporter.cpp:~250)
                        self._generated_track_pending = False
                        didl = self._didl(self._stream.info)
                        return ev.TrackEvent(
                            ev.Track(self._track_uri, didl),
                            start_of_stream=False)
                    if self._stream_pending:
                        self._stream_pending = False
                        msg = self._updated_stream_locked()
                        self._stream = msg
                        return msg
            e = self._next()
            out = self._process(e)
            if out is not None:
                return out

    def _updated_stream_locked(self) -> ev.DecodedStreamEvent:
        from dataclasses import replace
        info = self._stream.info
        rate = info.sample_rate
        updated = replace(
            info,
            track_length_jiffies=(self._duration_ms * rate // 1000)
            * jiffies.Jiffies.per_sample(rate)
            if self._duration_ms else info.track_length_jiffies,
            sample_start=self._start_offset.offset_sample(rate))
        return ev.DecodedStreamEvent(self._stream.stream_id, updated,
                                     self._stream.stream_handler)

    def _process(self, e: ev.Event) -> Optional[ev.Event]:
        with self._lock:
            if e.kind == "mode":
                was = self._intercept
                self._intercept = (e.mode == self.INTERCEPT_MODE)
                if self._intercept:
                    self._stream_pending = True
                    self._reset_counts()
                    self._stream = None
                    self._pipeline_track_seen = False
                    if was:
                        self._duration_ms_stream = 0
                return e
            if not self._intercept:
                return e
            if e.kind == "track":
                prev = self._track_uri
                self._track_uri = e.track.uri
                if e.start_of_stream:
                    self._stream = None
                self._pipeline_track_seen = True
                self._generated_track_pending = True
                self._on_track(prev)
                return e
            if e.kind == "decoded_stream":
                self._stream = e
                rate = e.info.sample_rate
                samples_total = (e.info.track_length_jiffies
                                 // jiffies.Jiffies.per_sample(rate)) \
                    if rate else 0
                self._duration_ms_stream = (samples_total * 1000 // rate
                                            if rate else 0)
                self._on_stream(e.info)
                self._stream_pending = True
                return None      # replaced by the regenerated stream
            if isinstance(e, ev.AudioPcmEvent):
                self._on_audio_locked()
                if self._pending_flush_id == ev.FlushEvent.ID_INVALID:
                    self._count(e.num_samples, e.samples.shape[0])
                return e
            if e.kind == "flush":
                if e.id >= self._pending_flush_id:
                    self._pending_flush_id = ev.FlushEvent.ID_INVALID
                return e
        return e


class SpotifyReporter(InterceptReporter):
    """Spotify position correction + playback eventing
    (SpotifyReporter.cpp): parses the Spotify stream id from the track
    URI, counts SUB-samples (samples x channels), and notifies playback
    observers of track length / playback started / continued / finished
    naturally with positions computed from the track-based subsample
    count (which restarts at each stream's sample_start)."""

    INTERCEPT_MODE = "Spotify"
    STREAM_ID_INVALID = 0

    def __init__(self, upstream, name=""):
        super().__init__(upstream, name)
        self.sub_samples = 0             # continuous, never reset by track
        self._sub_samples_track = 0      # restarts at stream sample_start
        self._stream_id = self.STREAM_ID_INVALID
        self._observers: list = []
        self._playback_start_pending = False
        self._playback_continue_pending = False

    def add_playback_observer(self, observer) -> None:
        with self._lock:
            self._observers.append(observer)

    def get_playback_pos_ms(self) -> tuple[int, int]:
        """(stream_id, position_ms), atomically
        (ISpotifyReporter::GetPlaybackPosMs)."""
        with self._lock:
            return self._stream_id, self._pos_ms_locked()

    def _pos_ms_locked(self) -> int:
        if self._stream is None:
            return 0
        info = self._stream.info
        samples = self._sub_samples_track // info.num_channels
        return samples * 1000 // info.sample_rate

    def _reset_counts(self) -> None:
        super()._reset_counts()
        self.sub_samples = 0
        self._sub_samples_track = 0
        self._stream_id = self.STREAM_ID_INVALID
        self._duration_ms_stream = 0

    def _count(self, num_samples: int, num_channels: int) -> None:
        super()._count(num_samples, num_channels)
        self.sub_samples += num_samples * num_channels
        self._sub_samples_track += num_samples * num_channels

    def _on_flush_requested(self) -> None:
        # a seek flush: subsequent audio means playback continued
        # (overridden if a new stream starts first)
        self._playback_continue_pending = True

    def _on_track(self, prev_uri: str) -> None:
        # stream id rides after the scheme separator in the track uri
        prev_id = self._stream_id
        tail = self._track_uri.split(":", 1)
        try:
            self._stream_id = int(tail[1]) if len(tail) > 1 \
                else self.STREAM_ID_INVALID
        except ValueError:
            self._stream_id = self.STREAM_ID_INVALID
        self._playback_start_pending = True
        if prev_id != self.STREAM_ID_INVALID:
            pos = self._pos_ms_locked()
            for o in self._observers:
                o.notify_playback_finished_naturally(prev_id, pos)

    def _on_stream(self, info) -> None:
        # track-based subsample count restarts at the stream's start
        # sample (continuous sub_samples keeps running)
        self._sub_samples_track = info.sample_start * info.num_channels
        for o in self._observers:
            o.notify_track_length(self._stream_id,
                                  self._duration_ms_stream)

    def _on_audio_locked(self) -> None:
        if self._playback_start_pending:
            self._playback_start_pending = False
            self._playback_continue_pending = False
            for o in self._observers:
                o.notify_playback_started(self._stream_id)
        if self._playback_continue_pending:
            self._playback_continue_pending = False
            for o in self._observers:
                o.notify_playback_continued(self._stream_id)

    def _didl(self, info) -> str:
        m = self._metadata or {}
        dur_s = (self._duration_ms or 0) // 1000
        dur = f"{dur_s // 3600}:{dur_s // 60 % 60:02d}:{dur_s % 60:02d}"
        bits = (f' bitsPerSample="{info.bit_depth}"'
                f' nrAudioChannels="{info.num_channels}"'
                f' sampleFrequency="{info.sample_rate}"')
        return (
            '<DIDL-Lite xmlns:dc="http://purl.org/dc/elements/1.1/" '
            'xmlns:upnp="urn:schemas-upnp-org:metadata-1-0/upnp/" '
            'xmlns="urn:schemas-upnp-org:metadata-1-0/DIDL-Lite/">'
            '<item id="" parentID="" restricted="True">'
            f'<dc:title>{m.get("track", "")}</dc:title>'
            f'<upnp:artist>{m.get("artist", "")}</upnp:artist>'
            f'<upnp:album>{m.get("album", "")}</upnp:album>'
            f'<upnp:albumArtURI>{m.get("album_cover_url", "")}'
            '</upnp:albumArtURI>'
            f'<res duration="{dur}"{bits} '
            f'protocolInfo="spotify:*:audio/L16:*">{self._track_uri}'
            '</res>'
            '<upnp:class>object.item.audioItem.musicTrack</upnp:class>'
            '</item></DIDL-Lite>')


class AirplayReporter(InterceptReporter):
    """Airplay position correction (AirplayReporter.cpp): same offset /
    position / flush machinery on the "AirPlay2" mode, but a plain
    per-frame sample count (IAirplayReporter::Samples) and the simpler
    Airplay metadata set."""

    INTERCEPT_MODE = "AirPlay2"

    @property
    def samples(self) -> int:
        with self._lock:
            return self.sample_count

    def _didl(self, info) -> str:
        m = self._metadata or {}
        dur_s = (self._duration_ms or 0) // 1000
        dur = f"{dur_s // 3600}:{dur_s // 60 % 60:02d}:{dur_s % 60:02d}"
        return (
            '<DIDL-Lite xmlns:dc="http://purl.org/dc/elements/1.1/" '
            'xmlns:upnp="urn:schemas-upnp-org:metadata-1-0/upnp/" '
            'xmlns="urn:schemas-upnp-org:metadata-1-0/DIDL-Lite/">'
            '<item id="" parentID="" restricted="True">'
            f'<dc:title>{m.get("track", "")}</dc:title>'
            f'<upnp:artist>{m.get("artist", "")}</upnp:artist>'
            f'<upnp:album>{m.get("album", "")}</upnp:album>'
            f'<upnp:genre>{m.get("genre", "")}</upnp:genre>'
            f'<upnp:albumArtURI>{m.get("artwork_uri", "")}'
            '</upnp:albumArtURI>'
            f'<res duration="{dur}">{self._track_uri}</res>'
            '<upnp:class>object.item.audioItem.musicTrack</upnp:class>'
            '</item></DIDL-Lite>')


class SampleReporter(Element):
    """Sample-counting reporter (kept for mode-agnostic callers): counts
    decoded samples per stream so out-of-band sources can map their own
    timeline onto pipeline time, and swaps in out-of-band track
    metadata.  The full reference semantics (start-offset correction,
    stream regeneration, playback eventing) live in SpotifyReporter /
    AirplayReporter above."""

    def __init__(self, upstream, name=""):
        super().__init__(upstream, name)
        self.sample_count = 0
        self._rate = 0
        self._lock = threading.Lock()
        self._pending_track: Optional[ev.TrackEvent] = None

    def track_changed(self, uri: str, metadata: str = "") -> None:
        with self._lock:
            self._pending_track = ev.TrackEvent(ev.Track(uri, metadata))

    @property
    def track_position_ms(self) -> int:
        with self._lock:
            return (self.sample_count * 1000 // self._rate) if self._rate \
                else 0

    def flush_sample_count(self) -> None:
        with self._lock:
            self.sample_count = 0

    def pull(self) -> ev.Event:
        with self._lock:
            if self._pending_track is not None:
                t, self._pending_track = self._pending_track, None
                return t
        e = self._next()
        if e.kind == "decoded_stream":
            with self._lock:
                self._rate = e.info.sample_rate
                self.sample_count = 0
        elif isinstance(e, ev.AudioPcmEvent):
            with self._lock:
                self.sample_count += e.num_samples
        return e


class AudioDumper(Element):
    """Debug tap writing encoded audio to a file (AudioDumper.cpp,
    enabled via EPipelineSupportElementsAudioDumper)."""

    def __init__(self, upstream, path: str, name=""):
        super().__init__(upstream, name)
        self._f = open(path, "wb")

    def pull(self) -> ev.Event:
        e = self._next()
        if e.kind == "encoded_audio":
            self._f.write(e.data)
        elif e.kind in ("halt", "quit"):
            self._f.flush()
        return e

    def close(self) -> None:
        self._f.close()
