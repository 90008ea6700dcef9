"""Minimal multicast-DNS responder: advertise services (_raop._tcp,
_openhome._tcp) for discovery.

Parity target: Av/DeviceAnnouncerMdns.* (the reference announces via
ohNet's mDNS).  Implements enough of RFC 6762/6763: PTR/SRV/TXT/A record
answers for registered services, announce-on-start, goodbye-on-close.
Unicast responses to the querier keep loopback tests self-contained.
"""

from __future__ import annotations

import socket
import struct
import threading
from dataclasses import dataclass, field
from typing import Optional

MDNS_ADDR = "224.0.0.251"
MDNS_PORT = 5353

TYPE_A, TYPE_PTR, TYPE_TXT, TYPE_SRV = 1, 12, 16, 33
CLASS_IN = 1
CACHE_FLUSH = 0x8001


def encode_name(name: str) -> bytes:
    out = b""
    for label in name.strip(".").split("."):
        raw = label.encode()
        out += bytes([len(raw)]) + raw
    return out + b"\x00"


def decode_name(data: bytes, pos: int) -> tuple[str, int]:
    labels = []
    jumped = False
    end = pos
    for _ in range(64):
        if pos >= len(data):
            break
        length = data[pos]
        if length == 0:
            if not jumped:
                end = pos + 1
            break
        if length & 0xC0 == 0xC0:      # compression pointer
            if not jumped:
                end = pos + 2
            pos = ((length & 0x3F) << 8) | data[pos + 1]
            jumped = True
            continue
        labels.append(data[pos + 1:pos + 1 + length].decode("utf-8",
                                                            "replace"))
        pos += 1 + length
    return ".".join(labels), end


def _record(name: str, rtype: int, rdata: bytes, ttl: int = 120) -> bytes:
    return (encode_name(name) + struct.pack(">HHIH", rtype, CACHE_FLUSH,
                                            ttl, len(rdata)) + rdata)


@dataclass(slots=True)
class MdnsService:
    service_type: str          # "_raop._tcp.local"
    instance: str              # "AABB@Room:Name"
    port: int
    txt: dict = field(default_factory=dict)
    host: str = "ohpipeline.local"
    address: str = "127.0.0.1"

    @property
    def full_name(self) -> str:
        return f"{self.instance}.{self.service_type}"

    def records(self, ttl: int = 120) -> bytes:
        txt_data = b"".join(
            bytes([len(f"{k}={v}")]) + f"{k}={v}".encode()
            for k, v in self.txt.items()) or b"\x00"
        srv = struct.pack(">HHH", 0, 0, self.port) + encode_name(self.host)
        a = socket.inet_aton(self.address)
        return (_record(self.service_type, TYPE_PTR,
                        encode_name(self.full_name), ttl)
                + _record(self.full_name, TYPE_SRV, srv, ttl)
                + _record(self.full_name, TYPE_TXT, txt_data, ttl)
                + _record(self.host, TYPE_A, a, ttl))


class MdnsResponder:
    def __init__(self, port: int = MDNS_PORT, multicast: bool = True):
        self._services: list[MdnsService] = []
        self.multicast = multicast
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("", port if multicast else 0))
        if multicast:
            try:
                mreq = socket.inet_aton(MDNS_ADDR) \
                    + socket.inet_aton("0.0.0.0")
                self._sock.setsockopt(socket.IPPROTO_IP,
                                      socket.IP_ADD_MEMBERSHIP, mreq)
            except OSError:
                pass
        self._sock.settimeout(0.2)
        self._running = True
        threading.Thread(target=self._loop, daemon=True,
                         name="MdnsResponder").start()

    @property
    def port(self) -> int:
        return self._sock.getsockname()[1]

    def register(self, service: MdnsService) -> None:
        self._services.append(service)
        self._announce(service)

    def _announce(self, service: MdnsService) -> None:
        msg = struct.pack(">HHHHHH", 0, 0x8400, 0, 4, 0, 0) \
            + service.records()
        try:
            dest = (MDNS_ADDR, MDNS_PORT) if self.multicast else None
            if dest:
                self._sock.sendto(msg, dest)
        except OSError:
            pass

    def close(self) -> None:
        # goodbye packets (ttl 0)
        for s in self._services:
            msg = struct.pack(">HHHHHH", 0, 0x8400, 0, 4, 0, 0) \
                + s.records(ttl=0)
            try:
                if self.multicast:
                    self._sock.sendto(msg, (MDNS_ADDR, MDNS_PORT))
            except OSError:
                pass
        self._running = False
        self._sock.close()

    def _loop(self) -> None:
        while self._running:
            try:
                data, src = self._sock.recvfrom(4096)
            except socket.timeout:
                continue
            except OSError:
                break
            resp = self._respond(data)
            if resp:
                try:
                    self._sock.sendto(resp, src)
                except OSError:
                    pass

    def _respond(self, data: bytes) -> Optional[bytes]:
        if len(data) < 12:
            return None
        (tid, flags, qdcount, _an, _ns, _ar) = struct.unpack(">HHHHHH",
                                                             data[:12])
        if flags & 0x8000:             # a response, not a query
            return None
        pos = 12
        answers = b""
        count = 0
        for _ in range(qdcount):
            name, pos = decode_name(data, pos)
            if pos + 4 > len(data):
                break
            qtype, _qclass = struct.unpack(">HH", data[pos:pos + 4])
            pos += 4
            for svc in self._services:
                if name.lower() == svc.service_type.lower() \
                        and qtype in (TYPE_PTR, 255):
                    answers += svc.records()
                    count += 4
                elif name.lower() == svc.full_name.lower() \
                        and qtype in (TYPE_SRV, TYPE_TXT, 255):
                    answers += svc.records()
                    count += 4
        if not count:
            return None
        return struct.pack(">HHHHHH", tid, 0x8400, 0, count, 0, 0) + answers


def announce_media_player(responder: MdnsResponder, friendly_name: str,
                          raop_port: int = 0, odp_port: int = 0,
                          web_port: int = 0,
                          mac: str = "000000000001") -> list[MdnsService]:
    """Register the device's services (DeviceAnnouncerMdns role)."""
    out = []
    if raop_port:
        svc = MdnsService(
            "_raop._tcp.local", f"{mac}@{friendly_name}", raop_port,
            txt={"txtvers": "1", "ch": "2", "cn": "0,1", "et": "0,1",
                 "sv": "false", "da": "true", "sr": "44100", "ss": "16",
                 "pw": "false", "vn": "3", "tp": "UDP", "md": "0,1,2",
                 "vs": "105.1", "am": "ohpipeline-tpu"})
        responder.register(svc)
        out.append(svc)
    if odp_port:
        svc = MdnsService("_odp._tcp.local", friendly_name, odp_port)
        responder.register(svc)
        out.append(svc)
    if web_port:
        svc = MdnsService("_http._tcp.local", friendly_name, web_port,
                          txt={"path": "/config/"})
        responder.register(svc)
        out.append(svc)
    return out
