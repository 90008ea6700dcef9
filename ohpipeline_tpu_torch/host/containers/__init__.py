"""Container parsers: sniff & strip framing around codec bitstreams.

Parity targets: OpenHome/Media/Codec/Container.cpp (ContainerController +
Rewinder retry, SURVEY.md §2.3), Id3v2.cpp, Mpeg4.cpp (ISO-BMFF),
MpegTs.cpp, plus libogg's page/packet framing (used for ogg-FLAC and
Vorbis).

Design: a container is a byte-stream transform `ContainerBase` with
`recognise(header)` and `unwrap(reader) -> iterator of (payload_bytes,
events)`; `ContainerController` sniffs the stream head against registered
containers and splices the chosen transform in front of the codec layer.
"""

from .base import ContainerBase, ContainerController, ContainerRegistry
from .id3v2 import ContainerId3v2
from .ogg import OggPage, OggReader

__all__ = ["ContainerBase", "ContainerController", "ContainerRegistry",
           "ContainerId3v2", "OggPage", "OggReader", "default_containers"]


def default_containers() -> ContainerRegistry:
    from .mpeg4 import ContainerMpeg4
    from .mpegts import ContainerMpegTs
    reg = ContainerRegistry()
    reg.add(ContainerId3v2)
    reg.add(ContainerMpeg4)
    reg.add(ContainerMpegTs)
    return reg
