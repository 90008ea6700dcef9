"""Container plug-in model (reference Container.h:73-181)."""

from __future__ import annotations

from typing import Callable, Optional

from ..codecs.base import StreamReader


class ContainerBase:
    """A container transform over a StreamReader.

    Subclasses implement `recognise` (sniff the head) and either
    `strip_prefix` (simple skip-N containers like ID3v2) or a full
    `wrap(reader)` returning a transformed StreamReader.
    """

    name = "?"

    def recognise(self, header: bytes) -> bool:
        raise NotImplementedError

    def wrap(self, reader: StreamReader) -> StreamReader:
        return reader

    #: metadata extracted during recognition/unwrap ({title, artist, ...})
    metadata: dict


class ContainerRegistry:
    def __init__(self):
        self._containers: list[Callable[[], ContainerBase]] = []

    def add(self, factory: Callable[[], ContainerBase]) -> None:
        self._containers.append(factory)

    def recognise(self, header: bytes) -> Optional[ContainerBase]:
        for f in self._containers:
            c = f()
            if c.recognise(header):
                return c
        return None


class ContainerController:
    """Sniffs the stream head and splices the recognised container's
    transform in front of the codec (reference ContainerController with its
    Rewinder: recognition happens on a buffered window so failure rewinds
    for free, Container.cpp:441-538)."""

    def __init__(self, registry: ContainerRegistry,
                 sniff_bytes: int = 16 * 1024):
        self._registry = registry
        self.sniff_bytes = sniff_bytes

    def process(self, reader: StreamReader) -> tuple[StreamReader, dict]:
        """Returns (possibly wrapped reader, metadata dict)."""
        header = reader.peek(self.sniff_bytes)
        meta: dict = {}
        # containers can nest (ID3v2 in front of anything); loop until no
        # more containers recognise the head
        for _ in range(4):
            c = self._registry.recognise(header)
            if c is None:
                break
            reader = c.wrap(reader)
            meta.update(getattr(c, "metadata", {}) or {})
            header = reader.peek(self.sniff_bytes)
        return reader, meta
