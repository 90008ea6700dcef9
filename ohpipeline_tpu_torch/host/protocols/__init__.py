"""Stream protocols: how URIs become byte streams entering the pipeline.

Parity targets: OpenHome/Media/Protocol/ (SURVEY.md §2.2) — Protocol base
with TrySetActive/Interrupt/IStreamHandler (Protocol.h:71-203),
ProtocolManager's ordered try-each dispatch (Protocol.cpp:532-560),
ProtocolFile, ProtocolTone (tone:// generated test tones), ProtocolHttp
(live/ICY detection, range seek).
"""

from .base import (Protocol, ProtocolManager, ProtocolStreamResult,
                   StreamHandler)
from .file import ProtocolFile
from .tone import ProtocolTone

__all__ = ["Protocol", "ProtocolManager", "ProtocolStreamResult",
           "StreamHandler", "ProtocolFile", "ProtocolTone",
           "make_default_manager"]


def make_default_manager(supply, id_provider=None) -> ProtocolManager:
    """The default protocol stack (reference MediaPlayer registers
    ProtocolFactory::NewHttp/File/Tone/Hls...)."""
    from .dash import ProtocolDash
    from .hls import ProtocolHls
    from .http import ProtocolHttp
    from .rtsp import ProtocolRtsp
    pm = ProtocolManager(supply, id_provider)
    pm.add(ProtocolHls())
    pm.add(ProtocolDash())
    pm.add(ProtocolHttp())
    pm.add(ProtocolRtsp())
    pm.add(ProtocolFile())
    pm.add(ProtocolTone())
    return pm
