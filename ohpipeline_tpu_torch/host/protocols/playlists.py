"""Playlist-format content processors: M3U/M3U8(simple)/PLS/ASX/OPML.

Parity target: Av/Radio/Content{M3u,M3uX,Pls,Asx,Opml}.cpp — when a radio
URI fetches a playlist document instead of audio, extract the stream URIs
so the protocol can restream the real target (ContentProcessor model,
Protocol.h:206).
"""

from __future__ import annotations

import re
import urllib.parse
from typing import Optional


def parse_m3u(text: str, base_url: str = "") -> list[str]:
    out = []
    for line in text.splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            out.append(urllib.parse.urljoin(base_url, line))
    return out


def parse_pls(text: str, base_url: str = "") -> list[str]:
    out = []
    for line in text.splitlines():
        m = re.match(r"\s*File\d+\s*=\s*(\S+)", line, re.I)
        if m:
            out.append(urllib.parse.urljoin(base_url, m.group(1)))
    return out


def parse_asx(text: str, base_url: str = "") -> list[str]:
    # ASX is loose XML; accept attribute case variants (ContentAsx.cpp)
    out = re.findall(r"<ref\s+href\s*=\s*[\"']([^\"']+)[\"']", text, re.I)
    if not out:   # old-style [Reference] format
        out = [m.group(1) for m in
               re.finditer(r"Ref\d+\s*=\s*(\S+)", text, re.I)]
    return [urllib.parse.urljoin(base_url, u) for u in out]


def parse_opml(text: str, base_url: str = "") -> list[str]:
    from ..av.services import parse_opml as _po
    return [urllib.parse.urljoin(base_url, u) for u, _t in _po(text)]


_SNIFFERS = (
    (lambda t: "[playlist]" in t.lower(), parse_pls),
    (lambda t: "<asx" in t.lower() or "[reference]" in t.lower(), parse_asx),
    (lambda t: "<opml" in t.lower(), parse_opml),
    (lambda t: t.lstrip().startswith("#EXTM3U") or ("://" in t), parse_m3u),
)


def extract_stream_uris(content: bytes, base_url: str = "",
                        content_type: str = "") -> Optional[list[str]]:
    """If `content` looks like a playlist document, return its stream URIs
    (None when it is audio / unrecognised)."""
    if len(content) > 512 * 1024:
        return None
    head = content[:64]
    if head[:3] == b"ID3" or head[:4] in (b"fLaC", b"RIFF", b"FORM", b"OggS"):
        return None
    if head[:1] == b"\xff":       # mp3/adts sync
        return None
    try:
        text = content.decode("utf-8")
    except UnicodeDecodeError:
        return None
    ct = content_type.lower()
    if "mpegurl" in ct:
        uris = parse_m3u(text, base_url)
        return uris or None
    if "scpls" in ct or "pls" in ct:
        return parse_pls(text, base_url) or None
    if "asx" in ct or "ms-asf" in ct:
        return parse_asx(text, base_url) or None
    for sniff, parser in _SNIFFERS:
        if sniff(text):
            uris = parser(text, base_url)
            if uris:
                return uris
    return None
