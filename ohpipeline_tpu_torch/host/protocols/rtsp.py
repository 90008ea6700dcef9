"""Generic RTSP/RTP streaming protocol for rtsp:// URIs.

Parity target: OpenHome/Media/Protocol/Rtsp.cpp + RtspClient (the
reference serves rtsp:// radio streams; RAOP's RTSP lives separately in
net/raop.py).  Flow: DESCRIBE (SDP) -> SETUP (interleaved TCP transport)
-> PLAY -> RTP depacketise -> ISupply, with TEARDOWN on stop and the
standard retry ladder on network errors.
"""

from __future__ import annotations

import socket
import threading
import urllib.parse
from typing import Optional

from ..core import events as ev
from .base import Protocol, ProtocolStreamResult


class RtspError(Exception):
    pass


class RtspClient:
    """Minimal RTSP/1.0 client over one TCP connection (RtspClient in
    the reference's Rtsp.cpp)."""

    def __init__(self, host: str, port: int, timeout: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.rfile = self.sock.makefile("rb")
        self.cseq = 0
        self.session: Optional[str] = None

    def close(self) -> None:
        try:
            self.rfile.close()
            self.sock.close()
        except OSError:
            pass

    def request(self, method: str, uri: str,
                headers: Optional[dict] = None) -> tuple[int, dict, bytes]:
        self.cseq += 1
        lines = [f"{method} {uri} RTSP/1.0", f"CSeq: {self.cseq}"]
        if self.session:
            lines.append(f"Session: {self.session}")
        for k, v in (headers or {}).items():
            lines.append(f"{k}: {v}")
        data = ("\r\n".join(lines) + "\r\n\r\n").encode()
        self.sock.sendall(data)
        return self._read_response()

    def _read_response(self) -> tuple[int, dict, bytes]:
        status_line = self.rfile.readline()
        if not status_line:
            raise RtspError("connection closed")
        parts = status_line.decode("latin-1").split()
        if len(parts) < 2 or not parts[0].startswith("RTSP"):
            raise RtspError(f"bad status line {status_line!r}")
        code = int(parts[1])
        hdrs: dict = {}
        while True:
            line = self.rfile.readline()
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode("latin-1").partition(":")
            hdrs[k.strip().lower()] = v.strip()
        body = b""
        n = int(hdrs.get("content-length", 0))
        if n:
            body = self.rfile.read(n)
        if "session" in hdrs:
            self.session = hdrs["session"].split(";")[0]
        return code, hdrs, body

    def read_interleaved(self) -> tuple[int, bytes]:
        """One interleaved frame: returns (channel, payload)."""
        hdr = self.rfile.read(4)
        if len(hdr) < 4:
            raise RtspError("eof")
        if hdr[0] != 0x24:          # '$'
            raise RtspError(f"lost interleave sync ({hdr[0]:#x})")
        channel = hdr[1]
        ln = int.from_bytes(hdr[2:4], "big")
        payload = self.rfile.read(ln)
        if len(payload) < ln:
            raise RtspError("short interleaved frame")
        return channel, payload


def parse_sdp(text: str) -> dict:
    """The bits of SDP the audio path needs: first audio media's payload
    type, encoding and control URL."""
    out = {"media": None, "payload_type": None, "encoding": "",
           "rate": 0, "channels": 0, "control": ""}
    in_audio = False
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("m="):
            in_audio = line.startswith("m=audio")
            if in_audio:
                fields = line.split()
                out["media"] = "audio"
                if len(fields) >= 4:
                    out["payload_type"] = int(fields[3])
        elif in_audio and line.startswith("a=rtpmap:"):
            body = line[len("a=rtpmap:"):]
            pt, _, enc = body.partition(" ")
            if out["payload_type"] in (None, int(pt)):
                out["payload_type"] = int(pt)
                parts = enc.split("/")
                out["encoding"] = parts[0].lower()
                if len(parts) > 1 and parts[1].isdigit():
                    out["rate"] = int(parts[1])
                if len(parts) > 2 and parts[2].isdigit():
                    out["channels"] = int(parts[2])
        elif in_audio and line.startswith("a=control:"):
            out["control"] = line[len("a=control:"):]
    return out


def strip_rtp(packet: bytes) -> tuple[int, bytes]:
    """RTP header strip (RFC 3550): returns (sequence, payload)."""
    if len(packet) < 12 or (packet[0] >> 6) != 2:
        raise RtspError("bad RTP packet")
    cc = packet[0] & 0xF
    ext = packet[0] & 0x10
    seq = int.from_bytes(packet[2:4], "big")
    off = 12 + 4 * cc
    if ext:
        if len(packet) < off + 4:
            raise RtspError("bad RTP extension")
        xlen = int.from_bytes(packet[off + 2:off + 4], "big")
        off += 4 + 4 * xlen
    end = len(packet)
    if packet[0] & 0x20:            # padding bit
        end -= packet[-1]
    return seq, packet[off:end]


#: rtpmap encoding -> (mime pushed downstream for codec recognition)
_ENCODING_MIME = {
    "mpeg4-generic": "audio/aac",
    "mp4a-latm": "audio/aac",
    "mpa": "audio/mpeg",
    "l16": "audio/l16",
    "opus": "audio/opus",
}


class ProtocolRtsp(Protocol):
    """rtsp:// streaming (reference ProtocolRtsp, Rtsp.cpp)."""

    name = "RTSP"

    def __init__(self, client_factory=RtspClient):
        super().__init__()
        self._factory = client_factory
        self._stream_id = 0
        self._stop = False
        self._flush_id = 0
        self._next_flush = 2000

    def recognise(self, uri: str) -> bool:
        return uri.startswith("rtsp://")

    def try_stop(self, stream_id: int) -> int:
        with self._lock:
            if stream_id != self._stream_id:
                return ev.FlushEvent.ID_INVALID
            self._stop = True
            self._flush_id = self._next_flush
            self._next_flush += 1
            return self._flush_id

    def stream(self, uri: str) -> ProtocolStreamResult:
        self._stop = False
        self.interrupt(False)
        u = urllib.parse.urlparse(uri)
        host = u.hostname or ""
        port = u.port or 554
        try:
            client = self._factory(host, port)
        except OSError:
            return ProtocolStreamResult.ERROR_RECOVERABLE
        try:
            return self._run(client, uri)
        except (RtspError, OSError):
            return ProtocolStreamResult.ERROR_RECOVERABLE
        finally:
            try:
                if client.session:
                    client.request("TEARDOWN", uri)
            except (RtspError, OSError):
                pass
            client.close()

    def _run(self, client: RtspClient, uri: str) -> ProtocolStreamResult:
        code, _h, _b = client.request("OPTIONS", uri)
        if code != 200:
            return ProtocolStreamResult.ERROR_UNRECOVERABLE
        code, hdrs, body = client.request(
            "DESCRIBE", uri, {"Accept": "application/sdp"})
        if code != 200:
            return ProtocolStreamResult.ERROR_UNRECOVERABLE
        sdp = parse_sdp(body.decode("utf-8", "replace"))
        if sdp["media"] != "audio":
            return ProtocolStreamResult.ERROR_UNRECOVERABLE
        control = sdp["control"] or uri
        if control and not control.startswith("rtsp://"):
            control = uri.rstrip("/") + "/" + control
        code, hdrs, _ = client.request(
            "SETUP", control,
            {"Transport": "RTP/AVP/TCP;unicast;interleaved=0-1"})
        if code != 200:
            return ProtocolStreamResult.ERROR_UNRECOVERABLE
        code, _h, _b = client.request("PLAY", uri, {"Range": "npt=0-"})
        if code != 200:
            return ProtocolStreamResult.ERROR_UNRECOVERABLE

        with self._lock:
            self._stream_id = self.next_stream_id()
        from ..core.streaminfo import EncodedStreamInfo
        self.supply.output_stream(
            EncodedStreamInfo(uri=uri, total_bytes=0,
                              stream_id=self._stream_id, seekable=False,
                              live=True), stream_handler=self)
        expected_seq: Optional[int] = None
        while True:
            if self.interrupted:
                return ProtocolStreamResult.STOPPED
            with self._lock:
                if self._stop:
                    self.supply.output_flush(self._flush_id)
                    return ProtocolStreamResult.STOPPED
            try:
                channel, frame = client.read_interleaved()
            except RtspError:
                break
            if channel != 0:        # RTCP or other interleave channel
                continue
            try:
                seq, payload = strip_rtp(frame)
            except RtspError:
                continue
            if expected_seq is not None and seq != (expected_seq & 0xFFFF):
                self.supply.output_stream_interrupted()
            expected_seq = seq + 1
            if payload:
                self.supply.output_data(payload)
        if hasattr(self.supply, "flush_pending"):
            self.supply.flush_pending()
        return ProtocolStreamResult.SUCCESS
