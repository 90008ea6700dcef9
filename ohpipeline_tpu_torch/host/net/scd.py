"""SCD ("Songcast direct"): reliable TCP point-to-point PCM/DSD streaming.

Parity target: Av/Scd/ScdMsg.h:24-48 message family (Ready, MetadataDidl/
Oh, Format, FormatDsd, Audio, MetatextDidl/Oh, Halt, Disconnect, Seek,
Skip), the receiver source and the demo sender (Av/Scd/Sender/
ScdServer.cpp).  Framing: 'Scd ' + type + payload-length, payloads
big-endian — semantically equivalent to the reference's ScdHeader.
"""

from __future__ import annotations

import socket
import struct
import threading
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

MAGIC = b"Scd "
(TYPE_READY, TYPE_METADATA_DIDL, TYPE_METADATA_OH, TYPE_FORMAT,
 TYPE_FORMAT_DSD, TYPE_AUDIO, TYPE_METATEXT_DIDL, TYPE_METATEXT_OH,
 TYPE_HALT, TYPE_DISCONNECT, TYPE_SEEK, TYPE_SKIP) = range(12)


def frame(msg_type: int, payload: bytes = b"") -> bytes:
    return MAGIC + struct.pack(">BI", msg_type, len(payload)) + payload


def read_frame(sock_file) -> Optional[tuple[int, bytes]]:
    hdr = sock_file.read(9)
    if len(hdr) < 9 or hdr[:4] != MAGIC:
        return None
    msg_type, length = struct.unpack(">BI", hdr[4:9])
    payload = sock_file.read(length) if length else b""
    if len(payload) < length:
        return None
    return msg_type, payload


@dataclass(slots=True)
class ScdFormat:
    sample_rate: int
    bit_depth: int
    channels: int
    bitrate: int = 0
    sample_start: int = 0
    samples_total: int = 0
    seekable: bool = False
    lossless: bool = True
    live: bool = False

    def encode(self) -> bytes:
        return struct.pack(">IIIIQQBB", self.sample_rate, self.bit_depth,
                           self.channels, self.bitrate, self.sample_start,
                           self.samples_total,
                           (1 if self.seekable else 0)
                           | (2 if self.lossless else 0)
                           | (4 if self.live else 0), 0)

    @staticmethod
    def decode(p: bytes) -> "ScdFormat":
        rate, depth, ch, br, start, total, flags, _ = struct.unpack(
            ">IIIIQQBB", p[:34])
        return ScdFormat(rate, depth, ch, br, start, total,
                         bool(flags & 1), bool(flags & 2), bool(flags & 4))


class ScdSender:
    """TCP server streaming PCM to connected receivers (demo WavSender
    equivalent)."""

    def __init__(self, port: int = 0):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", port))
        self._srv.listen(4)
        self._clients: list[socket.socket] = []
        self._lock = threading.Lock()
        self._running = True
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True, name="ScdSender")
        self._thread.start()

    @property
    def port(self) -> int:
        return self._srv.getsockname()[1]

    def _accept_loop(self):
        while self._running:
            try:
                c, _ = self._srv.accept()
            except OSError:
                break
            c.sendall(frame(TYPE_READY))
            with self._lock:
                self._clients.append(c)

    def _broadcast(self, data: bytes) -> None:
        with self._lock:
            dead = []
            for c in self._clients:
                try:
                    c.sendall(data)
                except OSError:
                    dead.append(c)
            for c in dead:
                self._clients.remove(c)

    def send_format(self, fmt: ScdFormat) -> None:
        self._broadcast(frame(TYPE_FORMAT, fmt.encode()))

    def send_metadata(self, didl: str) -> None:
        self._broadcast(frame(TYPE_METADATA_DIDL, didl.encode()))

    def send_audio(self, samples: np.ndarray, bit_depth: int) -> None:
        from ..ops.pcm import pack_pcm_bytes
        self._broadcast(frame(TYPE_AUDIO,
                              pack_pcm_bytes(samples, bit_depth,
                                             big_endian=True)))

    def send_halt(self) -> None:
        self._broadcast(frame(TYPE_HALT))

    def close(self) -> None:
        self._running = False
        self._srv.close()
        with self._lock:
            for c in self._clients:
                try:
                    c.sendall(frame(TYPE_DISCONNECT))
                    c.close()
                except OSError:
                    pass


class ScdReceiver:
    """TCP client consuming an SCD stream (reference SourceScd/
    ProtocolScd): surfaces format/audio/metadata callbacks."""

    def __init__(self, host: str, port: int,
                 on_audio: Callable[[np.ndarray, ScdFormat], None],
                 on_metadata=None, on_halt=None):
        self.host, self.port = host, port
        self.on_audio = on_audio
        self.on_metadata = on_metadata or (lambda md: None)
        self.on_halt = on_halt or (lambda: None)
        self.format: Optional[ScdFormat] = None
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._sock: Optional[socket.socket] = None

    def start(self) -> None:
        self._sock = socket.create_connection((self.host, self.port),
                                              timeout=5)
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="ScdReceiver")
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        if self._sock:
            self._sock.close()
        if self._thread:
            self._thread.join(1.0)

    def _loop(self) -> None:
        f = self._sock.makefile("rb")
        from ..ops.pcm import unpack_pcm_bytes
        while self._running:
            try:
                r = read_frame(f)
            except OSError:
                break
            if r is None:
                break
            msg_type, payload = r
            if msg_type == TYPE_FORMAT:
                self.format = ScdFormat.decode(payload)
            elif msg_type == TYPE_AUDIO and self.format is not None:
                samples = unpack_pcm_bytes(payload, self.format.bit_depth,
                                           self.format.channels,
                                           big_endian=True)
                self.on_audio(samples, self.format)
            elif msg_type in (TYPE_METADATA_DIDL, TYPE_METADATA_OH,
                              TYPE_METATEXT_DIDL, TYPE_METATEXT_OH):
                self.on_metadata(payload.decode("utf-8", "replace"))
            elif msg_type == TYPE_HALT:
                self.on_halt()
            elif msg_type == TYPE_DISCONNECT:
                break
