"""Streaming-service integrations: Tidal, Qobuz, CalmRadio, TuneIn.

Parity targets: Av/Tidal/ (OAuth device flow + stream-URL fetch +
ProtocolTidal), Av/Qobuz/ (credential login + signed requests),
Av/CalmRadio/ (token login), Av/Radio/TuneIn.cpp (OPML preset refresh).
All HTTP goes through an injectable `http` callable so the logic is fully
testable in this zero-egress environment (the reference's live-API tests
skip the same way, SURVEY.md §4.8).

Each service contributes a `<svc>://track?...` protocol: the pipeline's
ProtocolManager resolves it to a real audio URL at stream time (matching
the reference's Protocol* classes that look up stream URLs on demand).
"""

from __future__ import annotations

import hashlib
import json
import threading
import time
import urllib.parse
from typing import Callable, Optional

from ..protocols.base import Protocol, ProtocolStreamResult
from .credentials import Credentials
from .oauth import OAuthDeviceFlow, TokenManager


def default_http(method: str, url: str, headers: dict,
                 body: bytes = b"") -> tuple[int, bytes]:
    import urllib.request
    req = urllib.request.Request(url, data=body or None, headers=headers,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:                   # noqa: F821
        return e.code, e.read()


class ServiceError(Exception):
    pass


class TidalService:
    """OAuth-based catalogue/stream client (Av/Tidal/Tidal.cpp)."""

    ID = "tidalhifi.com"
    API = "https://api.tidal.com/v1"
    AUTH = "https://auth.tidal.com/v1/oauth2"

    def __init__(self, store, client_id: str, client_secret: str = "",
                 http: Callable = default_http,
                 http_post: Optional[Callable] = None,
                 quality: str = "LOSSLESS"):
        self._http = http
        self.quality = quality
        self.oauth = OAuthDeviceFlow(
            self.ID, f"{self.AUTH}/device_authorization",
            f"{self.AUTH}/token", client_id,
            scope="r_usr w_usr", client_secret=client_secret,
            http_post=http_post or (lambda url, data, hdrs: json.loads(
                http("POST", url,
                     {"Content-Type": "application/x-www-form-urlencoded",
                      **hdrs},
                     urllib.parse.urlencode(data).encode())[1])))
        self.tokens = TokenManager(self.ID, store, self.oauth.refresh)

    def stream_url(self, track_id: str, token_id: str) -> str:
        """Resolve a track to its playback URL (ProtocolTidal's
        GetStreamUrl)."""
        access = self.tokens.access_token(token_id)
        if not access:
            raise ServiceError("tidal: no valid token")
        status, body = self._http(
            "GET",
            f"{self.API}/tracks/{track_id}/playbackinfopostpaywall"
            f"?audioquality={self.quality}&playbackmode=STREAM"
            f"&assetpresentation=FULL",
            {"Authorization": f"Bearer {access}"})
        if status != 200:
            raise ServiceError(f"tidal: {status}")
        info = json.loads(body)
        if "manifest" in info:
            import base64
            manifest = json.loads(base64.b64decode(info["manifest"]))
            return manifest["urls"][0]
        return info["urls"][0]


class QobuzService:
    """Credential-login client with signed requests (Av/Qobuz/Qobuz.cpp)."""

    ID = "qobuz.com"
    API = "https://www.qobuz.com/api.json/0.2"

    def __init__(self, credentials: Credentials, app_id: str, secret: str,
                 http: Callable = default_http, format_id: int = 27):
        self._creds = credentials
        self._http = http
        self.app_id = app_id
        self.secret = secret
        self.format_id = format_id
        self._auth_token = ""
        credentials.add(self.ID)

    def login(self) -> bool:
        user, password = self._creds.get(self.ID)
        if not user:
            self._creds.set_status(self.ID, "no credentials")
            return False
        md5pw = hashlib.md5(password).hexdigest()
        status, body = self._http(
            "GET",
            f"{self.API}/user/login?username={urllib.parse.quote(user)}"
            f"&password={md5pw}&app_id={self.app_id}", {})
        if status != 200:
            self._creds.set_status(self.ID, f"login failed ({status})")
            return False
        self._auth_token = json.loads(body).get("user_auth_token", "")
        self._creds.set_status(self.ID, "")
        return bool(self._auth_token)

    def stream_url(self, track_id: str) -> str:
        """Signed file-url request (the reference signs with
        md5(request+ts+secret))."""
        if not self._auth_token and not self.login():
            raise ServiceError("qobuz: not logged in")
        ts = str(int(time.time()))
        sig = hashlib.md5(
            (f"trackgetFileUrlformat_id{self.format_id}"
             f"intentstreamtrack_id{track_id}{ts}{self.secret}")
            .encode()).hexdigest()
        status, body = self._http(
            "GET",
            f"{self.API}/track/getFileUrl?track_id={track_id}"
            f"&format_id={self.format_id}&intent=stream"
            f"&request_ts={ts}&request_sig={sig}&app_id={self.app_id}",
            {"X-User-Auth-Token": self._auth_token})
        if status != 200:
            raise ServiceError(f"qobuz: {status}")
        return json.loads(body)["url"]


class CalmRadioService:
    """Token-login client (Av/CalmRadio/CalmRadio.cpp)."""

    ID = "calmradio.com"
    API = "https://api.calmradio.com"

    def __init__(self, credentials: Credentials,
                 http: Callable = default_http):
        self._creds = credentials
        self._http = http
        self.token = ""
        credentials.add(self.ID)

    def login(self) -> bool:
        user, password = self._creds.get(self.ID)
        if not user:
            return False
        status, body = self._http(
            "GET", f"{self.API}/get_token?user={urllib.parse.quote(user)}"
            f"&pass={urllib.parse.quote(password.decode())}", {})
        if status != 200:
            self._creds.set_status(self.ID, f"login failed ({status})")
            return False
        self.token = json.loads(body).get("token", "")
        return bool(self.token)

    def stream_url(self, channel_url: str) -> str:
        if not self.token and not self.login():
            raise ServiceError("calmradio: not logged in")
        user, _ = self._creds.get(self.ID)
        sep = "&" if "?" in channel_url else "?"
        return f"{channel_url}{sep}user={urllib.parse.quote(user)}" \
               f"&token={self.token}"


class TuneInService:
    """OPML radio directory (Av/Radio/TuneIn.cpp): refreshes the preset
    database from the user's TuneIn favourites."""

    OPML = "https://opml.radiotime.com/Browse.ashx"

    def __init__(self, partner_id: str, username: str = "",
                 http: Callable = default_http):
        self.partner_id = partner_id
        self.username = username
        self._http = http

    def fetch_presets(self) -> list[tuple[str, str]]:
        """Returns [(stream_url, title)] from the favourites OPML feed."""
        url = (f"{self.OPML}?c=presets&partnerId={self.partner_id}"
               f"&username={urllib.parse.quote(self.username)}&formats=mp3,aac")
        status, body = self._http("GET", url, {})
        if status != 200:
            raise ServiceError(f"tunein: {status}")
        return parse_opml(body.decode("utf-8", "replace"))

    def refresh_into(self, preset_db) -> int:
        presets = self.fetch_presets()
        for i, (stream, title) in enumerate(presets[:preset_db.max_presets]):
            preset_db.set_preset(i, stream, title)
        return len(presets)


def parse_opml(text: str) -> list[tuple[str, str]]:
    """Minimal OPML outline parser (audio outlines only)."""
    import xml.etree.ElementTree as ET
    out = []
    try:
        root = ET.fromstring(text)
    except ET.ParseError:
        return out
    for outline in root.iter("outline"):
        if outline.get("type") == "audio" and outline.get("URL"):
            out.append((outline.get("URL"), outline.get("text", "")))
    return out


class ServiceProtocol(Protocol):
    """Protocol that resolves service URIs (tidal://track/123,
    qobuz://track/9, calmradio://channel?url=...) to audio URLs and
    delegates streaming to ProtocolHttp (the reference's per-service
    Protocol* classes share this shape)."""

    def __init__(self, scheme: str, resolver: Callable[[str], str],
                 http_protocol=None):
        super().__init__()
        self.name = scheme
        self.scheme = scheme
        self._resolve = resolver
        self._http = http_protocol

    def initialise(self, supply, id_provider) -> None:
        super().initialise(supply, id_provider)
        if self._http is None:
            from ..protocols.http import ProtocolHttp
            self._http = ProtocolHttp()
        self._http.initialise(supply, id_provider)

    def recognise(self, uri: str) -> bool:
        return uri.startswith(f"{self.scheme}://")

    def stream(self, uri: str) -> ProtocolStreamResult:
        try:
            real = self._resolve(uri)
        except ServiceError:
            return ProtocolStreamResult.ERROR_UNRECOVERABLE
        return self._http.stream(real)


# ---------------------------------------------------------------------------
# catalogue / metadata layers (Av/Tidal/TidalMetadata.cpp + TidalPins.cpp,
# Av/Qobuz/Qobuz.cpp catalogue requests)
# ---------------------------------------------------------------------------

from .misc import TrackMetadata, didl_lite  # noqa: E402


class TidalCatalogue:
    """Catalogue/metadata client over TidalService's token manager:
    tracks, albums, playlists, artists, favourites and search, with the
    reference's paged loading (TidalPins::LoadTracksById) and
    refresh-on-401 token lifecycle."""

    PAGE = 50
    ART = "https://resources.tidal.com/images/{path}/320x320.jpg"

    def __init__(self, service: TidalService, max_tracks: int = 1000):
        self.svc = service
        self.max_tracks = max_tracks

    def _get(self, path: str, token_id: str, params: dict) -> dict:
        access = self.svc.tokens.access_token(token_id)
        if not access:
            raise ServiceError("tidal: no valid token")
        qs = urllib.parse.urlencode({"countryCode": "US", **params})
        url = f"{self.svc.API}{path}?{qs}"
        status, body = self.svc._http(
            "GET", url, {"Authorization": f"Bearer {access}"})
        if status == 401:
            # expired access token: force one refresh and retry
            access = self.svc.tokens.refresh_token_now(token_id) \
                if hasattr(self.svc.tokens, "refresh_token_now") \
                else self.svc.tokens.access_token(token_id)
            status, body = self.svc._http(
                "GET", url, {"Authorization": f"Bearer {access}"})
        if status != 200:
            raise ServiceError(f"tidal: {status} for {path}")
        return json.loads(body)

    def _meta(self, t: dict) -> TrackMetadata:
        art = ""
        album = t.get("album") or {}
        cover = album.get("cover") or t.get("cover")
        if cover:
            art = self.ART.format(path=cover.replace("-", "/"))
        artists = t.get("artists") or ([t["artist"]] if t.get("artist")
                                       else [])
        return TrackMetadata(
            title=t.get("title", ""),
            artist=artists[0].get("name", "") if artists else "",
            album=album.get("title", ""),
            duration_s=int(t.get("duration", 0)),
            artwork_uri=art,
            uri=f"tidal://track/{t.get('id')}")

    def _paged(self, path: str, token_id: str,
               params: dict = None) -> list[TrackMetadata]:
        out: list[TrackMetadata] = []
        offset = 0
        while len(out) < self.max_tracks:
            page = self._get(path, token_id,
                             {"limit": self.PAGE, "offset": offset,
                              **(params or {})})
            items = page.get("items", [])
            for it in items:
                # favourites wrap the track in an "item" envelope
                t = it.get("item", it)
                if t.get("id") is not None:
                    out.append(self._meta(t))
            total = page.get("totalNumberOfItems", len(out))
            offset += len(items)
            if not items or offset >= total:
                break
        return out[:self.max_tracks]

    def track(self, track_id: str, token_id: str) -> TrackMetadata:
        return self._meta(self._get(f"/tracks/{track_id}", token_id, {}))

    def album_tracks(self, album_id: str, token_id: str):
        return self._paged(f"/albums/{album_id}/tracks", token_id)

    def playlist_tracks(self, uuid: str, token_id: str):
        return self._paged(f"/playlists/{uuid}/tracks", token_id)

    def artist_top_tracks(self, artist_id: str, token_id: str):
        return self._paged(f"/artists/{artist_id}/toptracks", token_id)

    def favorite_tracks(self, user_id: str, token_id: str):
        return self._paged(f"/users/{user_id}/favorites/tracks", token_id)

    def genre_tracks(self, genre: str, token_id: str):
        return self._paged(f"/genres/{genre}/tracks", token_id)

    def search(self, query: str, token_id: str, kind: str = "tracks"):
        page = self._get(f"/search/{kind}", token_id,
                         {"query": query, "limit": self.PAGE})
        return [self._meta(t) for t in page.get("items", [])]


class QobuzCatalogue:
    """Catalogue client over QobuzService: track/album/playlist metadata,
    favourites and search, re-logging-in once on auth expiry
    (Av/Qobuz/Qobuz.cpp TryGetResponse re-login ladder)."""

    PAGE = 50

    def __init__(self, service: QobuzService, max_tracks: int = 1000):
        self.svc = service
        self.max_tracks = max_tracks

    def _get(self, path: str, params: dict) -> dict:
        if not self.svc._auth_token and not self.svc.login():
            raise ServiceError("qobuz: not logged in")
        qs = urllib.parse.urlencode({"app_id": self.svc.app_id, **params})
        url = f"{self.svc.API}{path}?{qs}"
        status, body = self.svc._http(
            "GET", url, {"X-User-Auth-Token": self.svc._auth_token})
        if status == 401 and self.svc.login():
            status, body = self.svc._http(
                "GET", url, {"X-User-Auth-Token": self.svc._auth_token})
        if status != 200:
            raise ServiceError(f"qobuz: {status} for {path}")
        return json.loads(body)

    def _meta(self, t: dict, album: dict = None) -> TrackMetadata:
        album = t.get("album") or album or {}
        image = (album.get("image") or {})
        return TrackMetadata(
            title=t.get("title", ""),
            artist=(t.get("performer") or {}).get("name", "")
            or (album.get("artist") or {}).get("name", ""),
            album=album.get("title", ""),
            duration_s=int(t.get("duration", 0)),
            artwork_uri=image.get("large", "") or image.get("small", ""),
            uri=f"qobuz://track/{t.get('id')}")

    def track(self, track_id: str) -> TrackMetadata:
        return self._meta(self._get("/track/get", {"track_id": track_id}))

    def album_tracks(self, album_id: str):
        data = self._get("/album/get", {"album_id": album_id})
        items = (data.get("tracks") or {}).get("items", [])
        return [self._meta(t, data) for t in items][:self.max_tracks]

    def playlist_tracks(self, playlist_id: str):
        out = []
        offset = 0
        while len(out) < self.max_tracks:
            data = self._get("/playlist/get",
                             {"playlist_id": playlist_id,
                              "extra": "tracks", "limit": self.PAGE,
                              "offset": offset})
            tracks = (data.get("tracks") or {})
            items = tracks.get("items", [])
            out.extend(self._meta(t) for t in items)
            offset += len(items)
            if not items or offset >= tracks.get("total", 0):
                break
        return out[:self.max_tracks]

    def favorite_tracks(self):
        out = []
        offset = 0
        while len(out) < self.max_tracks:
            data = self._get("/favorite/getUserFavorites",
                             {"type": "tracks", "limit": self.PAGE,
                              "offset": offset})
            tracks = (data.get("tracks") or {})
            items = tracks.get("items", [])
            out.extend(self._meta(t) for t in items)
            offset += len(items)
            if not items or offset >= tracks.get("total", 0):
                break
        return out[:self.max_tracks]

    def search(self, query: str, kind: str = "tracks"):
        data = self._get("/catalog/search", {"query": query,
                                             "limit": self.PAGE})
        items = (data.get(kind) or {}).get("items", [])
        return [self._meta(t) for t in items]


class TokenRefreshLoop:
    """Background refresh of OAuth tokens before expiry (the reference's
    TokenManager polling via ThreadPool, OAuth.h:349-625)."""

    def __init__(self, token_manager, interval_s: float = 1800.0):
        self._tm = token_manager
        self._interval = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="token-refresh")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                for token_id in list(getattr(self._tm, "_tokens", {})):
                    self._tm.access_token(token_id)
            except Exception:
                pass                       # next cycle retries

