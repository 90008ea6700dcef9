"""RAOP (AirPlay 1) receiver: RTSP session + RTP audio with AES-CBC
decryption and ALAC payloads.

Parity target: Av/Raop/ (5.5k LoC): mDNS-advertised endpoint, RTSP
handshake (ANNOUNCE carries the AES session key RSA-encrypted to Apple's
key + SDP fmtp ALAC config), SETUP negotiating audio/control/timing UDP
ports, RECORD/FLUSH/TEARDOWN, RTP receive with sequence tracking and
resend requests on the control port, and CodecRaopApple (ALAC frames
without MP4 framing).

The Apple RSA private key is not shipped here; inject it (PEM) to decrypt
real iTunes sessions, or supply the raw AES key/iv directly (tests, and
senders that negotiate in the clear).  SURVEY.md §2.5 / §5.8.
"""

from __future__ import annotations

import base64
import re
import socket
import struct
import threading
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from ..codecs.alac import AlacConfig, decode_packet


def parse_sdp(text: str) -> dict:
    """Extract the RAOP-relevant SDP fields (fmtp ALAC params,
    rsaaeskey, aesiv)."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("a=fmtp:"):
            nums = []
            for p in line.split(":", 1)[1].split():
                try:
                    nums.append(int(p))
                except ValueError:
                    pass
            out["fmtp"] = nums
        elif line.startswith("a=rsaaeskey:"):
            out["rsaaeskey"] = line.split(":", 1)[1]
        elif line.startswith("a=aesiv:"):
            out["aesiv"] = line.split(":", 1)[1]
        elif line.startswith("a=rtpmap:"):
            out["rtpmap"] = line.split(":", 1)[1]
    return out


def alac_config_from_fmtp(fmtp: list[int]) -> AlacConfig:
    """SDP fmtp -> ALAC magic-cookie fields (the RAOP fmtp carries the
    cookie values in order: payload frameLength compatVersion bitDepth
    pb mb kb channels maxRun maxFrameBytes avgBitRate sampleRate)."""
    if len(fmtp) < 12:
        raise ValueError("short fmtp")
    (_pt, frame_length, _compat, bit_depth, pb, mb, kb, channels, max_run,
     max_frame_bytes, avg_bit_rate, rate) = fmtp[:12]
    return AlacConfig(frame_length, bit_depth, pb, mb, kb, channels,
                      max_run, max_frame_bytes, avg_bit_rate, rate)


def _b64pad(s: str) -> bytes:
    return base64.b64decode(s + "=" * (-len(s) % 4))


@dataclass(slots=True)
class RaopSession:
    alac: Optional[AlacConfig] = None
    aes_key: Optional[bytes] = None
    aes_iv: Optional[bytes] = None
    audio_port: int = 0
    control_port: int = 0
    timing_port: int = 0
    recording: bool = False
    volume_db: float = 0.0


class RaopReceiver:
    """The RTSP + RTP endpoint.  on_audio(samples (ch, n) int32) is called
    in sequence order; on_session/on_volume surface state."""

    def __init__(self, on_audio: Callable[[np.ndarray], None],
                 on_session: Optional[Callable[[RaopSession, str], None]] = None,
                 rsa_private_pem: Optional[bytes] = None,
                 port: int = 0, host: str = "127.0.0.1"):
        self.on_audio = on_audio
        self.on_session = on_session or (lambda s, ev: None)
        self._rsa_key = None
        if rsa_private_pem:
            from cryptography.hazmat.primitives import serialization
            self._rsa_key = serialization.load_pem_private_key(
                rsa_private_pem, password=None)
        self.session = RaopSession()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(2)
        self._running = True
        self._audio_sock: Optional[socket.socket] = None
        self._control_sock: Optional[socket.socket] = None
        self._expected_seq: Optional[int] = None
        self._pending: dict[int, bytes] = {}
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="RaopRtsp").start()

    @property
    def rtsp_port(self) -> int:
        return self._srv.getsockname()[1]

    def set_aes(self, key: bytes, iv: bytes) -> None:
        """Direct AES key injection (tests / pre-shared-key senders)."""
        self.session.aes_key = key
        self.session.aes_iv = iv

    def close(self) -> None:
        self._running = False
        for s in (self._srv, self._audio_sock, self._control_sock):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass

    # -- RTSP ---------------------------------------------------------------
    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                break
            threading.Thread(target=self._rtsp_session, args=(conn,),
                             daemon=True).start()

    def _rtsp_session(self, conn: socket.socket) -> None:
        f = conn.makefile("rwb")
        while self._running:
            request = f.readline().decode("latin1")
            if not request:
                break
            headers = {}
            while True:
                line = f.readline().decode("latin1").strip()
                if not line:
                    break
                k, _, v = line.partition(":")
                headers[k.strip().lower()] = v.strip()
            body = b""
            if headers.get("content-length"):
                body = f.read(int(headers["content-length"]))
            method = request.split()[0].upper()
            resp_headers, status = self._handle(method, headers, body)
            out = [f"RTSP/1.0 {status}"]
            out.append(f"CSeq: {headers.get('cseq', '0')}")
            for k, v in resp_headers.items():
                out.append(f"{k}: {v}")
            out.append("")
            out.append("")
            f.write("\r\n".join(out).encode())
            f.flush()
            if method == "TEARDOWN":
                break
        conn.close()

    def _handle(self, method: str, headers: dict,
                body: bytes) -> tuple[dict, str]:
        s = self.session
        if method == "OPTIONS":
            return ({"Public": "ANNOUNCE, SETUP, RECORD, FLUSH, TEARDOWN, "
                               "OPTIONS, GET_PARAMETER, SET_PARAMETER"},
                    "200 OK")
        if method == "ANNOUNCE":
            sdp = parse_sdp(body.decode("utf-8", "replace"))
            if "fmtp" in sdp:
                s.alac = alac_config_from_fmtp(sdp["fmtp"])
            if "aesiv" in sdp:
                s.aes_iv = _b64pad(sdp["aesiv"])
            if "rsaaeskey" in sdp and self._rsa_key is not None:
                from cryptography.hazmat.primitives.asymmetric import padding
                from cryptography.hazmat.primitives import hashes
                s.aes_key = self._rsa_key.decrypt(
                    _b64pad(sdp["rsaaeskey"]),
                    padding.OAEP(mgf=padding.MGF1(hashes.SHA1()),
                                 algorithm=hashes.SHA1(), label=None))
            self.on_session(s, "announce")
            return {}, "200 OK"
        if method == "SETUP":
            self._open_rtp()
            transport = (f"RTP/AVP/UDP;unicast;mode=record;"
                         f"server_port={s.audio_port};"
                         f"control_port={s.control_port};"
                         f"timing_port={s.timing_port}")
            self.on_session(s, "setup")
            return {"Transport": transport, "Session": "1"}, "200 OK"
        if method == "RECORD":
            s.recording = True
            self._expected_seq = None
            self._pending.clear()
            self.on_session(s, "record")
            return {"Audio-Latency": "11025"}, "200 OK"
        if method == "FLUSH":
            self._expected_seq = None
            self._pending.clear()
            self.on_session(s, "flush")
            return {}, "200 OK"
        if method == "SET_PARAMETER":
            m = re.search(rb"volume:\s*(-?\d+(?:\.\d+)?)", body)
            if m:
                s.volume_db = float(m.group(1))
                self.on_session(s, "volume")
            return {}, "200 OK"
        if method == "TEARDOWN":
            s.recording = False
            self.on_session(s, "teardown")
            return {}, "200 OK"
        return {}, "200 OK"

    # -- RTP ------------------------------------------------------------------
    def _open_rtp(self) -> None:
        if self._audio_sock is not None:
            return
        self._audio_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._audio_sock.bind(("", 0))
        self._audio_sock.settimeout(0.2)
        self._control_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._control_sock.bind(("", 0))
        self._control_sock.settimeout(0.2)
        timing = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        timing.bind(("", 0))
        self.session.audio_port = self._audio_sock.getsockname()[1]
        self.session.control_port = self._control_sock.getsockname()[1]
        self.session.timing_port = timing.getsockname()[1]
        threading.Thread(target=self._audio_loop, daemon=True,
                         name="RaopRtp").start()
        threading.Thread(target=self._control_loop, daemon=True,
                         name="RaopControl").start()

    def _decrypt(self, payload: bytes) -> bytes:
        s = self.session
        if not s.aes_key:
            return payload
        from cryptography.hazmat.primitives.ciphers import (Cipher,
                                                            algorithms,
                                                            modes)
        enc_len = len(payload) & ~0xF
        dec = Cipher(algorithms.AES(s.aes_key),
                     modes.CBC(s.aes_iv)).decryptor()
        return dec.update(payload[:enc_len]) + payload[enc_len:]

    def _audio_loop(self) -> None:
        while self._running:
            try:
                data, src = self._audio_sock.recvfrom(65536)
            except socket.timeout:
                continue
            except OSError:
                break
            if len(data) < 12:
                continue
            ptype = data[1] & 0x7F
            seq = struct.unpack(">H", data[2:4])[0]
            if ptype not in (96, 86):   # audio / retransmitted audio
                continue
            payload = data[16:] if ptype == 86 else data[12:]
            self._sender_addr = src
            self._handle_audio(seq, payload)

    def _control_loop(self) -> None:
        while self._running:
            try:
                self._control_sock.recvfrom(65536)   # sync packets ignored
            except socket.timeout:
                continue
            except OSError:
                break

    def _request_resend(self, first: int, count: int) -> None:
        if self._control_sock is None or not hasattr(self, "_sender_addr"):
            return
        pkt = struct.pack(">BBHHH", 0x80, 0x55 | 0x80, 1, first, count)
        try:
            self._control_sock.sendto(
                pkt, (self._sender_addr[0], self._sender_addr[1]))
        except OSError:
            pass

    def _handle_audio(self, seq: int, payload: bytes) -> None:
        if self._expected_seq is None:
            self._expected_seq = seq
        delta = (seq - self._expected_seq) & 0xFFFF
        if delta > 0x8000:
            return                      # late duplicate
        if delta > 0:
            self._pending[seq] = payload
            self._request_resend(self._expected_seq, delta)
            if len(self._pending) > 128:
                self._expected_seq = min(self._pending)
            else:
                return
            payload = self._pending.pop(self._expected_seq, None)
            if payload is None:
                return
            seq = self._expected_seq
        self._deliver(seq, payload)

    def _deliver(self, seq: int, payload: Optional[bytes]) -> None:
        while payload is not None:
            plain = self._decrypt(payload)
            if self.session.alac is not None:
                try:
                    pcm, _n = decode_packet(plain, self.session.alac)
                    self.on_audio(pcm)
                except Exception:                          # noqa: BLE001
                    pass
            self._expected_seq = (seq + 1) & 0xFFFF
            seq = self._expected_seq
            payload = self._pending.pop(seq, None)
