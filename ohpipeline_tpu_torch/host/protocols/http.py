"""HTTP(S) streaming protocol.

Parity target: OpenHome/Media/Protocol/ProtocolHttp.cpp (817 LoC) —
GET with redirects, live-stream detection (no Content-Length), ICY
(Shoutcast) metadata interleaving via `icy-metaint`, seek by Range re-GET
(TrySeek at 394), live re-fetch retry ladder (287-321).

Implemented over urllib (host control plane; zero hot-loop cost) with the
ICY stripper as a separate reusable class (reference Icy.cpp).

The port's copy of the JAX package's ``protocols/http.py``; it differs in
one value, the default User-Agent, which names this package.
"""

from __future__ import annotations

import threading
import urllib.error
import urllib.request
from typing import Optional

from ..core import events as ev
from ..core.streaminfo import EncodedStreamInfo
from .base import Protocol, ProtocolStreamResult

CHUNK = 64 * 1024
MAX_REDIRECTS = 5
LIVE_RETRIES = 3


class IcyStripper:
    """De-interleaves Shoutcast `icy-metaint` metadata from an audio byte
    stream (reference Icy.cpp): every `metaint` bytes of audio, one length
    byte (x16) of metadata follows."""

    def __init__(self, metaint: int, on_metadata):
        self.metaint = metaint
        self._until_meta = metaint
        self._meta_need = -1
        self._meta_buf = bytearray()
        self._on_metadata = on_metadata

    def feed(self, data: bytes) -> bytes:
        out = bytearray()
        i = 0
        while i < len(data):
            if self._meta_need == -1 and self._until_meta == 0:
                self._meta_need = data[i] * 16
                self._meta_buf.clear()
                i += 1
                if self._meta_need == 0:
                    self._meta_need = -1
                    self._until_meta = self.metaint
                continue
            if self._meta_need > 0:
                take = min(self._meta_need, len(data) - i)
                self._meta_buf += data[i:i + take]
                self._meta_need -= take
                i += take
                if self._meta_need == 0:
                    self._emit_meta()
                    self._meta_need = -1
                    self._until_meta = self.metaint
                continue
            take = min(self._until_meta, len(data) - i)
            out += data[i:i + take]
            self._until_meta -= take
            i += take
        return bytes(out)

    def _emit_meta(self):
        text = self._meta_buf.rstrip(b"\x00").decode("utf-8", "replace")
        # typical payload: StreamTitle='...';StreamUrl='...'
        for part in text.split(";"):
            if part.startswith("StreamTitle='"):
                self._on_metadata(part[len("StreamTitle='"):].rstrip("'"))
                return
        if text:
            self._on_metadata(text)


class ProtocolHttp(Protocol):
    name = "HTTP"

    def __init__(self, user_agent: str = "ohpipeline_tpu_torch"):
        super().__init__()
        self._ua = user_agent
        self._lock = threading.Lock()
        self._stream_id = 0
        self._seek_pos: Optional[int] = None
        self._stop = False
        self._flush_id = 0
        self._next_flush = 1000

    def recognise(self, uri: str) -> bool:
        return uri.startswith(("http://", "https://"))

    # -- IStreamHandler ----------------------------------------------------
    def try_seek(self, stream_id: int, byte_pos: int) -> int:
        with self._lock:
            if stream_id != self._stream_id or not self._seekable:
                return ev.FlushEvent.ID_INVALID
            self._seek_pos = byte_pos
            self._flush_id = self._next_flush
            self._next_flush += 1
            return self._flush_id

    def try_stop(self, stream_id: int) -> int:
        with self._lock:
            if stream_id != self._stream_id:
                return ev.FlushEvent.ID_INVALID
            self._stop = True
            self._flush_id = self._next_flush
            self._next_flush += 1
            return self._flush_id

    # -- streaming ---------------------------------------------------------
    def _open(self, uri: str, start: int = 0):
        headers = {"User-Agent": self._ua, "Icy-MetaData": "1"}
        if start:
            headers["Range"] = f"bytes={start}-"
        req = urllib.request.Request(uri, headers=headers)
        return urllib.request.urlopen(req, timeout=30)

    def stream(self, uri: str) -> ProtocolStreamResult:
        self._stop = False
        self._seek_pos = None
        self.interrupt(False)
        try:
            resp = self._open(uri)
        except (urllib.error.URLError, OSError):
            return ProtocolStreamResult.ERROR_RECOVERABLE
        headers = resp.headers
        total = int(headers.get("Content-Length") or 0)
        live = total == 0
        self._seekable = (not live and
                          "bytes" in (headers.get("Accept-Ranges") or ""))
        metaint = int(headers.get("icy-metaint") or 0)
        icy_name = headers.get("icy-name")
        with self._lock:
            self._stream_id = self.next_stream_id()
        self.supply.output_stream(
            EncodedStreamInfo(uri=uri, total_bytes=total,
                              stream_id=self._stream_id,
                              seekable=self._seekable, live=live,
                              metatext=icy_name or ""),
            stream_handler=self)
        if icy_name:
            self.supply.output_metadata(icy_name)
        stripper = (IcyStripper(metaint, self.supply.output_metadata)
                    if metaint > 0 else None)
        retries = LIVE_RETRIES
        while True:
            try:
                data = resp.read(CHUNK)
            except (urllib.error.URLError, OSError, TimeoutError):
                data = b""
            if self.interrupted:
                resp.close()
                return ProtocolStreamResult.STOPPED
            with self._lock:
                if self._stop:
                    resp.close()
                    self.supply.output_flush(self._flush_id)
                    return ProtocolStreamResult.STOPPED
                seek = self._seek_pos
                self._seek_pos = None
            if seek is not None:
                resp.close()
                try:
                    resp = self._open(uri, start=seek)
                except (urllib.error.URLError, OSError):
                    return ProtocolStreamResult.ERROR_RECOVERABLE
                # A server that ignores Range answers 200 from byte 0;
                # treating that as the seek offset desyncs decode.  Accept
                # only 206 whose Content-Range starts at the requested byte
                # (a 200 at seek==0 is equivalent and fine).
                if seek > 0:
                    status = getattr(resp, "status", None) or resp.getcode()
                    crange = resp.headers.get("Content-Range") or ""
                    ok = status == 206 and crange.startswith("bytes ") \
                        and crange[6:].split("-")[0].strip() == str(seek)
                    if not ok:
                        resp.close()
                        return ProtocolStreamResult.ERROR_RECOVERABLE
                self.supply.output_flush(self._flush_id)
                continue
            if not data:
                if live and retries > 0:
                    # live stream dropped: re-fetch (ProtocolHttp.cpp:287)
                    retries -= 1
                    self.supply.output_stream_interrupted()
                    try:
                        resp = self._open(uri)
                        continue
                    except (urllib.error.URLError, OSError):
                        return ProtocolStreamResult.ERROR_RECOVERABLE
                break
            retries = LIVE_RETRIES
            self.supply.output_data(stripper.feed(data) if stripper else data)
        if hasattr(self.supply, "flush_pending"):
            self.supply.flush_pending()
        return ProtocolStreamResult.SUCCESS
