"""Podcast pins: iTunes search/episodes and TuneIn podcast browse.

Parity targets: Av/Pins/PodcastPinsITunes.* (pin modes "itunes" = latest
episode, "ituneslist" = episode playlist; iTunes search/lookup JSON +
feed RSS; per-podcast last-listened dates persisted in the store for
new-episode polling, PodcastPinsITunes.h:134-185) and
Av/Pins/PodcastPinsTuneIn.* (opml.radiotime.com Tune.ashx pbrowse
episode lists).  HTTP is injectable for tests, like av.services.
"""

from __future__ import annotations

import json
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Callable, Optional

from .pins import Pin, PinInvoker

MAX_LISTENED = 26                        # reference kMaxEntries


def _default_get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=15) as r:
        return r.read()


@dataclass(slots=True)
class Podcast:
    id: str
    name: str
    feed_url: str
    artwork_url: str = ""


@dataclass(slots=True)
class PodcastEpisode:
    title: str
    url: str
    published: str = ""
    duration_s: int = 0
    artwork_url: str = ""


class ListenedDates:
    """Bounded per-podcast last-listened dates (ListenedDatePooled with
    LRU priority, PodcastPins.h:49-63), persisted via the kvp store."""

    def __init__(self, store, key: str = "Pins.PodcastLastListened"):
        self._store = store
        self._key = key
        try:
            raw = store.read(key) if store else None
        except Exception:                 # noqa: BLE001 (StoreKeyNotFound)
            raw = None
        self._entries: list[list] = json.loads(raw.decode()) if raw else []

    def date(self, podcast_id: str) -> Optional[str]:
        for pid, date in self._entries:
            if pid == podcast_id:
                return date
        return None

    def set(self, podcast_id: str, date: str) -> None:
        self._entries = [[p, d] for p, d in self._entries
                         if p != podcast_id]
        self._entries.insert(0, [podcast_id, date])
        del self._entries[MAX_LISTENED:]
        if self._store:
            self._store.write(self._key,
                              json.dumps(self._entries).encode())


class ITunesPodcasts:
    """iTunes podcast directory client (PodcastPinsITunes.cpp:800+)."""

    HOST = "https://itunes.apple.com"

    def __init__(self, http_get: Callable[[str], bytes] = _default_get):
        self._get = http_get

    def search(self, term: str, limit: int = 1) -> list[Podcast]:
        q = urllib.parse.urlencode({"term": term, "media": "podcast",
                                    "entity": "podcast", "limit": limit})
        return self._results(f"{self.HOST}/search?{q}")

    def lookup(self, podcast_id: str) -> Optional[Podcast]:
        r = self._results(f"{self.HOST}/lookup?id={podcast_id}")
        return r[0] if r else None

    def _results(self, url: str) -> list[Podcast]:
        doc = json.loads(self._get(url).decode("utf-8", "replace"))
        out = []
        for it in doc.get("results", []):
            if not it.get("feedUrl"):
                continue
            out.append(Podcast(str(it.get("collectionId", "")),
                               it.get("collectionName", ""),
                               it["feedUrl"],
                               it.get("artworkUrl600", "")))
        return out

    def resolve(self, query: str) -> Optional[Podcast]:
        """Pin query: numeric iTunes id or free-text search."""
        if query.isdigit():
            return self.lookup(query)
        r = self.search(query)
        return r[0] if r else None

    def episodes(self, feed_url: str,
                 limit: int = 20) -> list[PodcastEpisode]:
        """Parse the podcast RSS feed's enclosure items, newest first."""
        root = ET.fromstring(self._get(feed_url).decode("utf-8", "replace"))
        out = []
        for item in root.iter("item"):
            enc = item.find("enclosure")
            if enc is None or not enc.get("url"):
                continue
            title = item.findtext("title", "")
            pub = item.findtext("pubDate", "")
            dur = item.findtext(
                "{http://www.itunes.com/dtds/podcast-1.0.dtd}duration", "")
            out.append(PodcastEpisode(title, enc.get("url"), pub,
                                      _parse_duration(dur)))
            if len(out) >= limit:
                break
        return out

    def latest(self, query: str) \
            -> tuple[Optional[Podcast], Optional[PodcastEpisode]]:
        pod = self.resolve(query)
        if pod is None:
            return None, None
        eps = self.episodes(pod.feed_url, limit=1)
        return pod, (eps[0] if eps else None)

    def check_for_new_episode(self, query: str,
                              dates: ListenedDates) -> bool:
        """True when the newest episode postdates the stored
        last-listened date (CheckForNewEpisode,
        PodcastPinsITunes.h:149)."""
        pod, ep = self.latest(query)
        if pod is None or ep is None:
            return False
        return dates.date(pod.id) != ep.published


def _parse_duration(text: str) -> int:
    if not text:
        return 0
    try:
        parts = [int(p) for p in text.strip().split(":")]
    except ValueError:
        return 0
    s = 0
    for p in parts:
        s = s * 60 + p
    return s


class TuneInPodcasts:
    """TuneIn podcast episode browse (PodcastPinsTuneIn.cpp:862+:
    Tune.ashx?c=pbrowse&id=<program>)."""

    HOST = "http://opml.radiotime.com"
    PARTNER_ID = "ah2rjr68"

    def __init__(self, http_get: Callable[[str], bytes] = _default_get,
                 username: str = ""):
        self._get = http_get
        self._username = username

    def episodes(self, program_id: str,
                 limit: int = 20) -> list[PodcastEpisode]:
        q = urllib.parse.urlencode(
            {"c": "pbrowse", "id": program_id,
             "partnerId": self.PARTNER_ID, "username": self._username})
        root = ET.fromstring(
            self._get(f"{self.HOST}/Tune.ashx?{q}")
            .decode("utf-8", "replace"))
        out = []
        for node in root.iter("outline"):
            if node.get("type") != "audio":
                continue
            out.append(PodcastEpisode(
                node.get("text", ""), node.get("URL", ""),
                node.get("subtext", ""),
                int(node.get("duration", "0") or 0),
                node.get("image", "")))
            if len(out) >= limit:
                break
        return out


class ITunesLatestPinInvoker(PinInvoker):
    """Pin mode "itunes": play the newest episode (single shot)."""

    mode = "itunes"

    def __init__(self, pipeline_manager, itunes: ITunesPodcasts,
                 dates: Optional[ListenedDates] = None):
        self._pm = pipeline_manager
        self._itunes = itunes
        self._dates = dates

    def invoke(self, pin: Pin) -> None:
        query = pin.uri or pin.title
        pod, ep = self._itunes.latest(query)
        if ep is None:
            raise LookupError(f"no episode for {query!r}")
        if self._dates is not None and pod is not None:
            self._dates.set(pod.id, ep.published)
        self._pm.play_uri(ep.url, metadata=ep.title)


class ITunesListPinInvoker(PinInvoker):
    """Pin mode "ituneslist": queue the episode list as a playlist."""

    mode = "ituneslist"

    def __init__(self, source_playlist, itunes: ITunesPodcasts,
                 shuffle: bool = False):
        self._playlist = source_playlist
        self._itunes = itunes
        self.shuffle = shuffle

    def invoke(self, pin: Pin) -> None:
        query = pin.uri or pin.title
        pod = self._itunes.resolve(query)
        if pod is None:
            raise LookupError(f"no podcast for {query!r}")
        eps = self._itunes.episodes(pod.feed_url)
        if not eps:
            raise LookupError("empty feed")
        self._playlist.db.delete_all()
        after = 0
        for ep in eps:
            after = self._playlist.db.insert(after, ep.url, ep.title)
        self._playlist.provider.set_shuffle(self.shuffle or pin.shuffle)
        self._playlist.activate(auto_play=True)


class TuneInPodcastPinInvoker(PinInvoker):
    """Pin mode "tunein" type "podcast": episode list via OPML."""

    mode = "tunein"

    def __init__(self, source_playlist, tunein: TuneInPodcasts):
        self._playlist = source_playlist
        self._tunein = tunein

    def invoke(self, pin: Pin) -> None:
        eps = self._tunein.episodes(pin.uri or pin.title)
        if not eps:
            raise LookupError("no episodes")
        self._playlist.db.delete_all()
        after = 0
        for ep in eps:
            after = self._playlist.db.insert(after, ep.url, ep.title)
        self._playlist.activate(auto_play=True)
