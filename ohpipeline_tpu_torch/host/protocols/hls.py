"""HLS streaming protocol.

Parity target: OpenHome/Media/Protocol/ProtocolHls.h:29-315 — master/media
m3u8 parsing, variant selection, segment provider with sequence tracking,
live playlist reload at target-duration cadence, discontinuity handling
(StreamSegmentEvent), and ICY-free segment pass-through into the pipeline
(segments are usually ADTS-AAC or TS; the container layer demuxes).
HTTP is injectable for loopback tests (reference TestProtocolHls uses
scripted local servers, SURVEY.md §4.6).
"""

from __future__ import annotations

import time
import urllib.parse
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..core.streaminfo import EncodedStreamInfo
from .base import Protocol, ProtocolStreamResult


def default_fetch(url: str) -> bytes:
    import urllib.request
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read()


@dataclass(slots=True)
class Segment:
    uri: str
    duration: float
    sequence: int
    discontinuity: bool = False


@dataclass(slots=True)
class MediaPlaylist:
    segments: list[Segment] = field(default_factory=list)
    target_duration: float = 6.0
    media_sequence: int = 0
    ended: bool = False


def parse_master(text: str, base_url: str) -> list[tuple[int, str]]:
    """Master playlist -> [(bandwidth, absolute_uri)], best first."""
    variants = []
    bandwidth = 0
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("#EXT-X-STREAM-INF"):
            bandwidth = 0
            for attr in line.split(":", 1)[-1].split(","):
                if attr.strip().upper().startswith("BANDWIDTH="):
                    try:
                        bandwidth = int(attr.split("=")[1])
                    except ValueError:
                        pass
        elif line and not line.startswith("#"):
            variants.append((bandwidth, urllib.parse.urljoin(base_url,
                                                             line)))
            bandwidth = 0
    variants.sort(key=lambda v: -v[0])
    return variants


def parse_media(text: str, base_url: str) -> MediaPlaylist:
    pl = MediaPlaylist()
    duration = 0.0
    disc = False
    seq = 0
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("#EXT-X-TARGETDURATION"):
            try:
                pl.target_duration = float(line.split(":", 1)[1])
            except ValueError:
                pass
        elif line.startswith("#EXT-X-MEDIA-SEQUENCE"):
            try:
                pl.media_sequence = int(line.split(":", 1)[1])
                seq = pl.media_sequence
            except ValueError:
                pass
        elif line.startswith("#EXTINF"):
            try:
                duration = float(line.split(":", 1)[1].split(",")[0])
            except ValueError:
                duration = 0.0
        elif line.startswith("#EXT-X-DISCONTINUITY"):
            disc = True
        elif line.startswith("#EXT-X-ENDLIST"):
            pl.ended = True
        elif line and not line.startswith("#"):
            pl.segments.append(Segment(
                urllib.parse.urljoin(base_url, line), duration, seq, disc))
            seq += 1
            duration, disc = 0.0, False
    return pl


def is_master(text: str) -> bool:
    return "#EXT-X-STREAM-INF" in text


class ProtocolHls(Protocol):
    name = "HLS"
    MAX_STALE_RELOADS = 5       # playlist not advancing -> stalled
    MAX_RELOAD_ERRORS = 3       # consecutive reload fetch failures

    def __init__(self, fetch: Callable[[str], bytes] = default_fetch,
                 sleep: Callable[[float], None] = time.sleep,
                 max_reloads: Optional[int] = None):
        super().__init__()
        self._fetch = fetch
        self._sleep = sleep
        self._max_reloads = max_reloads     # tests bound live streams

    def recognise(self, uri: str) -> bool:
        return uri.startswith(("hls://", "hlss://")) \
            or uri.endswith(".m3u8")

    @staticmethod
    def _http_uri(uri: str) -> str:
        # the reference registers hls:// and rewrites to http(s)
        if uri.startswith("hls://"):
            return "http://" + uri[len("hls://"):]
        if uri.startswith("hlss://"):
            return "https://" + uri[len("hlss://"):]
        return uri

    def stream(self, uri: str) -> ProtocolStreamResult:
        url = self._http_uri(uri)
        self.interrupt(False)
        try:
            text = self._fetch(url).decode("utf-8", "replace")
        except OSError:
            return ProtocolStreamResult.ERROR_RECOVERABLE
        if is_master(text):
            variants = parse_master(text, url)
            if not variants:
                return ProtocolStreamResult.ERROR_UNRECOVERABLE
            url = variants[0][1]
            try:
                text = self._fetch(url).decode("utf-8", "replace")
            except OSError:
                return ProtocolStreamResult.ERROR_RECOVERABLE
        playlist = parse_media(text, url)
        sid = self.next_stream_id()
        self.supply.output_stream(
            EncodedStreamInfo(uri=uri, total_bytes=0, stream_id=sid,
                              seekable=False, live=not playlist.ended),
            stream_handler=self)
        next_seq = playlist.media_sequence
        reloads = 0
        stale = 0
        fetch_errors = 0
        while True:
            if playlist.segments \
                    and next_seq < playlist.media_sequence:
                # live-edge drift: we fell behind the server's window;
                # skip forward to what it still serves
                # (ProtocolHls.h drift handling)
                next_seq = playlist.media_sequence
                self.supply.output_stream_interrupted()
            progressed = False
            for seg in playlist.segments:
                if seg.sequence < next_seq:
                    continue
                if self.interrupted:
                    return ProtocolStreamResult.STOPPED
                if seg.discontinuity:
                    self.supply.output_segment(str(seg.sequence))
                try:
                    data = self._fetch(seg.uri)
                except OSError:
                    # skip the broken segment rather than spinning on it
                    self.supply.output_stream_interrupted()
                    next_seq = seg.sequence + 1
                    continue
                self.supply.output_data(data)
                next_seq = seg.sequence + 1
                progressed = True
            if playlist.ended:
                break
            if self._max_reloads is not None:
                reloads += 1
                if reloads > self._max_reloads:
                    break
            stale = 0 if progressed else stale + 1
            if stale > self.MAX_STALE_RELOADS:
                # server stopped advancing its playlist (stale live
                # stream): give up so the filler can restart the track
                return ProtocolStreamResult.ERROR_RECOVERABLE
            # live: reload at target-duration cadence (half if stale,
            # ProtocolHls.h reload timing)
            self._sleep(playlist.target_duration
                        * (1.0 if progressed else 0.5))
            if self.interrupted:
                return ProtocolStreamResult.STOPPED
            try:
                text = self._fetch(url).decode("utf-8", "replace")
                fetch_errors = 0
            except OSError:
                # transient playlist-reload failures are retried before
                # declaring the stream broken
                fetch_errors += 1
                if fetch_errors > self.MAX_RELOAD_ERRORS:
                    return ProtocolStreamResult.ERROR_RECOVERABLE
                continue
            playlist = parse_media(text, url)
        if hasattr(self.supply, "flush_pending"):
            self.supply.flush_pending()
        return ProtocolStreamResult.SUCCESS
