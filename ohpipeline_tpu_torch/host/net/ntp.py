"""SNTP client + Unix timestamp service.

Parity targets: OpenHome/NtpClient.cpp (48-byte SNTP v4 client over UDP
port 123 with a rotating server list and read timeout) and
OpenHome/UnixTimestamp.cpp (epoch conversion with periodic resync).
These feed StarterTimed's absolute-time starts so several rooms can
begin playback at the same wall-clock instant
(pipeline/latency.StarterTimed; reference StarterTimed.cpp IAudioTime).
"""

from __future__ import annotations

import socket
import struct
import threading
import time
from dataclasses import dataclass
from typing import Optional, Sequence

#: seconds between the NTP epoch (1900) and the Unix epoch (1970)
NTP_UNIX_EPOCH_DELTA = 2_208_988_800

DEFAULT_SERVERS = (
    "0.pool.ntp.org", "1.pool.ntp.org", "2.pool.ntp.org", "3.pool.ntp.org",
)


@dataclass
class NtpTimestamp:
    """Transmit timestamp of the server reply (NTP epoch)."""
    seconds: int
    fraction: int

    def as_float(self) -> float:
        return self.seconds + self.fraction / 2.0 ** 32

    def as_unix(self) -> float:
        return self.as_float() - NTP_UNIX_EPOCH_DELTA


class NtpClient:
    """Minimal SNTP v4 client (RFC 4330), one 48-byte request per server
    with timeout, rotating through the server list like the reference
    (NtpClient.cpp kReadTimeoutMs / iNextServerIndex)."""

    FRAME_BYTES = 48
    NTP_PORT = 123
    READ_TIMEOUT_S = 5.0

    def __init__(self, servers: Sequence[str] = DEFAULT_SERVERS,
                 port: int = NTP_PORT,
                 timeout_s: float = READ_TIMEOUT_S):
        self._servers = list(servers)
        self._port = port
        self._timeout = timeout_s
        self._next_index = 0

    def try_get_network_time(self) -> Optional[tuple[NtpTimestamp, float]]:
        """(transmit timestamp, network delay ms) from the first server
        that answers; None when all fail."""
        for _ in range(len(self._servers)):
            server = self._servers[self._next_index]
            self._next_index = (self._next_index + 1) % len(self._servers)
            got = self._query(server)
            if got is not None:
                return got
        return None

    def _query(self, server: str) -> Optional[tuple[NtpTimestamp, float]]:
        # leap 0, version 4, mode 3 (client); remaining fields zero
        packet = bytearray(self.FRAME_BYTES)
        packet[0] = (0 << 6) | (4 << 3) | 3
        try:
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                s.settimeout(self._timeout)
                t0 = time.monotonic()
                s.sendto(bytes(packet), (server, self._port))
                data, _addr = s.recvfrom(self.FRAME_BYTES)
                delay_ms = (time.monotonic() - t0) * 1000.0
        except OSError:
            return None
        if len(data) < self.FRAME_BYTES:
            return None
        mode = data[0] & 0x7
        if mode != 4:                      # server reply
            return None
        # transmit timestamp = bytes 40..47
        secs, frac = struct.unpack(">II", data[40:48])
        if secs == 0:
            return None
        return NtpTimestamp(secs, frac), delay_ms


class UnixTimestamp:
    """Unix epoch seconds, synced over SNTP and advanced by the local
    monotonic clock between resyncs (UnixTimestamp.cpp: Now/Reset +
    periodic resync)."""

    RESYNC_INTERVAL_S = 24 * 60 * 60

    def __init__(self, client: Optional[NtpClient] = None,
                 resync_interval_s: float = RESYNC_INTERVAL_S):
        self._client = client or NtpClient()
        self._interval = resync_interval_s
        self._lock = threading.Lock()
        self._offset: Optional[float] = None    # unix - monotonic
        self._synced_at = 0.0

    def reset(self) -> None:
        with self._lock:
            self._offset = None

    def _sync_locked(self) -> None:
        got = self._client.try_get_network_time()
        if got is None:
            raise RuntimeError("NTP time unavailable")
        ts, delay_ms = got
        now_mono = time.monotonic()
        self._offset = (ts.as_unix() + delay_ms / 2000.0) - now_mono
        self._synced_at = now_mono

    def now(self) -> float:
        """Current Unix time (seconds, float)."""
        with self._lock:
            mono = time.monotonic()
            if self._offset is None or \
                    mono - self._synced_at > self._interval:
                self._sync_locked()
            return mono + self._offset

    def unix_to_monotonic(self, unix_time: float) -> float:
        """Map an absolute Unix time onto the local monotonic clock —
        the form StarterTimed.start_at consumes for synchronised
        multi-room starts."""
        with self._lock:
            if self._offset is None:
                self._sync_locked()
            return unix_time - self._offset
