"""MPEG-DASH protocol: MPD parsing and segment streaming.

Parity target: OpenHome/Media/Protocol/MPEGDash.h:29-343 — MPD documents
(periods / adaptation sets / representations), ISO-8601 duration parsing,
SegmentTemplate with $RepresentationID$/$Number$/$Time$ substitution,
SegmentList and single-segment BaseURL forms, audio adaptation-set
selection by mime/codec, bandwidth-sorted representation choice.  DRM
hooks surface as a provider callback like the reference's
IDashDrmProvider.
"""

from __future__ import annotations

import re
import urllib.parse
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..core.streaminfo import EncodedStreamInfo
from .base import Protocol, ProtocolStreamResult
from .hls import default_fetch


def parse_iso8601_duration(text: str) -> float:
    """ISO-8601 duration -> seconds (MPEGDash.cpp's duration parser):
    handles years/months (calendar convention 365/30 days), weeks, and
    fractional values in any component."""
    m = re.match(r"^(-)?P(?:(\d+(?:\.\d+)?)Y)?(?:(\d+(?:\.\d+)?)M)?"
                 r"(?:(\d+(?:\.\d+)?)W)?(?:(\d+(?:\.\d+)?)D)?"
                 r"(?:T(?:(\d+(?:\.\d+)?)H)?(?:(\d+(?:\.\d+)?)M)?"
                 r"(?:(\d+(?:\.\d+)?)S)?)?$", text or "")
    if not m or (text or "") in ("P", "PT", ""):
        return 0.0
    neg, y, mo, w, d, h, mi, s = m.groups()
    y, mo, w, d, h, mi, s = (float(x) if x else 0.0
                             for x in (y, mo, w, d, h, mi, s))
    days = y * 365 + mo * 30 + w * 7 + d
    total = ((days * 24 + h) * 60 + mi) * 60 + s
    return -total if neg else total


def _strip_ns(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


@dataclass(slots=True)
class Representation:
    rep_id: str = ""
    bandwidth: int = 0
    codecs: str = ""
    base_url: str = ""
    init_url: str = ""
    media_template: str = ""
    start_number: int = 1
    timescale: int = 1
    segment_duration: float = 0.0
    segment_urls: list = field(default_factory=list)
    timeline: list = field(default_factory=list)   # (t, d, repeat)

    def segment_uri(self, number: int, time: int = 0) -> str:
        uri = self.media_template
        uri = uri.replace("$RepresentationID$", self.rep_id)
        uri = re.sub(r"\$Number(%0\d+d)?\$",
                     lambda m: (m.group(1) or "%d") % number, uri)
        uri = re.sub(r"\$Time(%0\d+d)?\$",
                     lambda m: (m.group(1) or "%d") % time, uri)
        return urllib.parse.urljoin(self.base_url, uri)


@dataclass(slots=True)
class Period:
    period_id: str = ""
    start: float = 0.0
    duration: float = 0.0
    representations: list = field(default_factory=list)

    def best_audio(self) -> Optional[Representation]:
        reps = sorted(self.representations, key=lambda r: -r.bandwidth)
        return reps[0] if reps else None


@dataclass(slots=True)
class Mpd:
    duration: float = 0.0
    is_live: bool = False
    min_update_period: float = 0.0
    periods: list = field(default_factory=list)
    protection_schemes: list = field(default_factory=list)

    @property
    def representations(self) -> list:
        return [r for p in self.periods for r in p.representations]

    def best_audio(self) -> Optional[Representation]:
        return self.periods[0].best_audio() if self.periods else None


def parse_mpd(text: str, base_url: str) -> Mpd:
    root = ET.fromstring(text)
    mpd = Mpd(duration=parse_iso8601_duration(
        root.get("mediaPresentationDuration", "")),
        is_live=root.get("type", "static") == "dynamic",
        min_update_period=parse_iso8601_duration(
            root.get("minimumUpdatePeriod", "")))
    doc_base = base_url
    for child in root:
        if _strip_ns(child.tag) == "BaseURL" and child.text:
            doc_base = urllib.parse.urljoin(base_url, child.text.strip())
    prev_end = 0.0
    for period in (c for c in root if _strip_ns(c.tag) == "Period"):
        p = Period(period_id=period.get("id", ""),
                   start=parse_iso8601_duration(period.get("start", ""))
                   or prev_end,
                   duration=parse_iso8601_duration(
                       period.get("duration", "")))
        prev_end = p.start + p.duration
        period_base = doc_base
        pb = _find(period, "BaseURL")
        if pb is not None and pb.text:
            period_base = urllib.parse.urljoin(doc_base, pb.text.strip())
        for aset in (c for c in period
                     if _strip_ns(c.tag) == "AdaptationSet"):
            mime = aset.get("mimeType", "") or ""
            ctype = aset.get("contentType", "") or ""
            if not (mime.startswith("audio") or ctype == "audio"
                    or (not mime and not ctype)):
                continue
            for cp in (c for c in aset
                       if _strip_ns(c.tag) == "ContentProtection"):
                mpd.protection_schemes.append(
                    cp.get("schemeIdUri", ""))
            aset_tmpl = _find(aset, "SegmentTemplate")
            for rep in (c for c in aset
                        if _strip_ns(c.tag) == "Representation"):
                r = Representation(
                    rep_id=rep.get("id", ""),
                    bandwidth=int(rep.get("bandwidth", 0) or 0),
                    codecs=rep.get("codecs", aset.get("codecs", "")),
                    base_url=period_base)
                rb = _find(rep, "BaseURL")
                if rb is not None and rb.text:
                    r.base_url = urllib.parse.urljoin(period_base,
                                                      rb.text.strip())
                tmpl = _find(rep, "SegmentTemplate") or aset_tmpl
                if tmpl is not None:
                    r.media_template = tmpl.get("media", "")
                    r.init_url = tmpl.get("initialization", "").replace(
                        "$RepresentationID$", r.rep_id)
                    r.start_number = int(tmpl.get("startNumber", 1) or 1)
                    r.timescale = int(tmpl.get("timescale", 1) or 1)
                    if tmpl.get("duration"):
                        r.segment_duration = (int(tmpl.get("duration"))
                                              / r.timescale)
                    tl = _find(tmpl, "SegmentTimeline")
                    if tl is not None:
                        t = 0
                        for s in (c for c in tl if _strip_ns(c.tag) == "S"):
                            t = int(s.get("t", t))
                            d = int(s.get("d", 0))
                            rpt = int(s.get("r", 0))
                            r.timeline.append((t, d, rpt))
                            t += d * (rpt + 1)
                slist = _find(rep, "SegmentList")
                if slist is not None:
                    for su in (c for c in slist
                               if _strip_ns(c.tag) == "SegmentURL"):
                        r.segment_urls.append(urllib.parse.urljoin(
                            r.base_url, su.get("media", "")))
                    init = _find(slist, "Initialization")
                    if init is not None:
                        r.init_url = init.get("sourceURL", "")
                p.representations.append(r)
        mpd.periods.append(p)
    return mpd


def _segment_uris(rep: Representation,
                  duration_hint: float = 0.0) -> list[tuple[str, int]]:
    """Enumerate (uri, time) pairs: SegmentList > SegmentTimeline >
    duration-derived count."""
    out: list[tuple[str, int]] = []
    if rep.segment_urls:
        return [(u, 0) for u in rep.segment_urls]
    if rep.timeline:
        n = rep.start_number
        for (t, d, rpt) in rep.timeline:
            for i in range(rpt + 1):
                out.append((rep.segment_uri(n, t + i * d), t + i * d))
                n += 1
        return out
    if rep.segment_duration and duration_hint:
        count = int(duration_hint / rep.segment_duration + 0.999)
        return [(rep.segment_uri(rep.start_number + i), 0)
                for i in range(count)]
    return out


def _find(node, name: str):
    for c in node:
        if _strip_ns(c.tag) == name:
            return c
    return None


class ProtocolDash(Protocol):
    name = "DASH"

    def __init__(self, fetch: Callable[[str], bytes] = default_fetch,
                 drm_provider: Optional[Callable] = None,
                 max_segments: Optional[int] = None,
                 sleep: Callable[[float], None] = None):
        super().__init__()
        import time as _time
        self._fetch = fetch
        self._drm = drm_provider
        self._max_segments = max_segments
        self._sleep = sleep or _time.sleep

    def recognise(self, uri: str) -> bool:
        return uri.startswith("dash://") or uri.endswith(".mpd")

    @staticmethod
    def _http_uri(uri: str) -> str:
        return "http://" + uri[len("dash://"):] \
            if uri.startswith("dash://") else uri

    MAX_STALE_RELOADS = 5

    def stream(self, uri: str) -> ProtocolStreamResult:
        url = self._http_uri(uri)
        self.interrupt(False)
        try:
            mpd = parse_mpd(self._fetch(url).decode("utf-8", "replace"),
                            url)
        except (OSError, ET.ParseError):
            return ProtocolStreamResult.ERROR_RECOVERABLE
        if not mpd.periods or mpd.best_audio() is None:
            return ProtocolStreamResult.ERROR_UNRECOVERABLE
        if mpd.protection_schemes:
            # DRM'd content needs a provider (the reference's
            # IDashDrmProvider hook); without one the stream is refused
            if self._drm is None or \
                    not self._drm(mpd.protection_schemes):
                return ProtocolStreamResult.ERROR_UNRECOVERABLE
        sid = self.next_stream_id()
        self.supply.output_stream(
            EncodedStreamInfo(uri=uri, stream_id=sid, seekable=False,
                              live=mpd.is_live),
            stream_handler=self)
        sent = 0
        delivered: set = set()
        init_sent: set = set()
        stale = 0
        while True:
            progressed = False
            for pi, period in enumerate(mpd.periods):
                rep = period.best_audio()
                if rep is None:
                    continue
                if pi not in init_sent:
                    if pi > 0:
                        # period boundary: expected discontinuity
                        self.supply.output_segment(period.period_id
                                                   or str(pi))
                    if rep.init_url:
                        try:
                            self.supply.output_data(self._fetch(
                                urllib.parse.urljoin(rep.base_url,
                                                     rep.init_url)))
                        except OSError:
                            return ProtocolStreamResult.ERROR_RECOVERABLE
                    init_sent.add(pi)
                for seg, _t in _segment_uris(rep, period.duration
                                             or mpd.duration):
                    if (pi, seg) in delivered:
                        continue
                    if self._max_segments is not None \
                            and sent >= self._max_segments:
                        return self._finish()
                    if self.interrupted:
                        return ProtocolStreamResult.STOPPED
                    delivered.add((pi, seg))
                    try:
                        self.supply.output_data(self._fetch(seg))
                    except OSError:
                        self.supply.output_stream_interrupted()
                        continue
                    sent += 1
                    progressed = True
            if not mpd.is_live:
                break
            # dynamic MPD: reload at minimumUpdatePeriod cadence and pick
            # up newly published segments/periods (MPEGDash.h live flow)
            stale = 0 if progressed else stale + 1
            if stale > self.MAX_STALE_RELOADS:
                return ProtocolStreamResult.ERROR_RECOVERABLE
            self._sleep(max(mpd.min_update_period, 0.5))
            if self.interrupted:
                return ProtocolStreamResult.STOPPED
            try:
                mpd = parse_mpd(
                    self._fetch(url).decode("utf-8", "replace"), url)
            except (OSError, ET.ParseError):
                return ProtocolStreamResult.ERROR_RECOVERABLE
        return self._finish()

    def _finish(self) -> ProtocolStreamResult:
        if hasattr(self.supply, "flush_pending"):
            self.supply.flush_pending()
        return ProtocolStreamResult.SUCCESS
