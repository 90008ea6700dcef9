"""Artwork server: HTTP endpoint re-serving embedded track art.

Parity target: OpenHome/Media/ArtworkServer.* — track art extracted from
containers (ID3v2 APIC etc.) is cached and exposed over HTTP so UIs can
fetch `http://<device>/artwork/current`; observers learn the URI.
"""

from __future__ import annotations

import hashlib
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional


class ArtworkServer:
    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 max_bytes: int = 5 * 1024 * 1024):
        self._art: Optional[tuple[str, bytes]] = None   # (mime, data)
        self._etag = ""
        self._lock = threading.Lock()
        self._observers: list[Callable[[str], None]] = []
        self.max_bytes = max_bytes
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                with server._lock:
                    art = server._art
                if not self.path.startswith("/artwork") or art is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                mime, data = art
                self.send_response(200)
                self.send_header("Content-Type", mime)
                self.send_header("Content-Length", str(len(data)))
                self.send_header("Cache-Control", "max-age=10")
                self.end_headers()
                self.wfile.write(data)

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True, name="ArtworkServer")
        self._thread.start()

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def uri(self) -> str:
        return (f"http://127.0.0.1:{self.port}/artwork/{self._etag}"
                if self._art else "")

    def add_observer(self, cb: Callable[[str], None]) -> None:
        self._observers.append(cb)

    def set_artwork(self, mime: str, data: bytes) -> None:
        if len(data) > self.max_bytes:
            return
        with self._lock:
            self._art = (mime, data)
            self._etag = hashlib.md5(data).hexdigest()[:12]
        uri = self.uri()
        for cb in self._observers:
            cb(uri)

    def clear(self) -> None:
        with self._lock:
            self._art = None
        for cb in self._observers:
            cb("")

    def close(self) -> None:
        self._server.shutdown()
