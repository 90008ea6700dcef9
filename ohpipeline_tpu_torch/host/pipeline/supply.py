"""Supply: how protocols create pipeline events (ISupply, Msg.h:1540-1670;
Supply.cpp / SupplyAggregator.cpp).

Protocols call these helpers to push Mode/Track/Stream/Audio events into the
encoded reservoir; the aggregator coalesces small reads into larger encoded
chunks before pushing (SupplyAggregator.cpp's byte aggregation).
"""

from __future__ import annotations

from typing import Optional

from ..core import events as ev
from ..core.streaminfo import EncodedStreamInfo, PcmStreamInfo
from .elements import Pushable


class Supply:
    """Direct ISupply implementation over a downstream Pushable."""

    def __init__(self, downstream: Pushable):
        self._down = downstream

    def output_mode(self, mode: str, info: Optional[ev.ModeInfo] = None,
                    clock_puller=None) -> None:
        self._down.push(ev.ModeEvent(mode, info or ev.ModeInfo(),
                                     clock_puller))

    def output_track(self, track: ev.Track, start_of_stream=True) -> None:
        self._down.push(ev.TrackEvent(track, start_of_stream))

    def output_drain(self, callback=None) -> None:
        self._down.push(ev.DrainEvent(callback))

    def output_delay(self, jiffies: int) -> None:
        self._down.push(ev.DelayEvent(jiffies))

    def output_stream(self, info: EncodedStreamInfo,
                      stream_handler=None) -> None:
        self._down.push(ev.EncodedStreamEvent(info, stream_handler))

    def output_pcm_stream(self, info: EncodedStreamInfo,
                          pcm: PcmStreamInfo, stream_handler=None) -> None:
        from dataclasses import replace
        self._down.push(ev.EncodedStreamEvent(replace(info, pcm_format=pcm),
                                              stream_handler))

    def output_segment(self, segment_id: str) -> None:
        self._down.push(ev.StreamSegmentEvent(segment_id))

    def output_data(self, data: bytes) -> None:
        if data:
            self._down.push(ev.EncodedAudioEvent(data))

    def output_metadata(self, text: str) -> None:
        self._down.push(ev.MetaTextEvent(text))

    def output_halt(self, callback=None) -> None:
        self._down.push(ev.HaltEvent(callback=callback))

    def output_flush(self, flush_id: int) -> None:
        self._down.push(ev.FlushEvent(flush_id))

    def output_wait(self) -> None:
        self._down.push(ev.WaitEvent())

    def output_stream_interrupted(self) -> None:
        self._down.push(ev.StreamInterruptedEvent())

    def output_quit(self) -> None:
        self._down.push(ev.QuitEvent())


class SupplyAggregator(Supply):
    """Coalesces output_data bytes before pushing (SupplyAggregator.cpp);
    control events flush the aggregation first to preserve ordering."""

    def __init__(self, downstream: Pushable, chunk_bytes: int = 64 * 1024):
        super().__init__(downstream)
        self.chunk_bytes = chunk_bytes
        self._buf = bytearray()

    def output_data(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= self.chunk_bytes:
            chunk = bytes(self._buf[: self.chunk_bytes])
            del self._buf[: self.chunk_bytes]
            self._down.push(ev.EncodedAudioEvent(chunk))

    def flush_pending(self) -> None:
        if self._buf:
            self._down.push(ev.EncodedAudioEvent(bytes(self._buf)))
            self._buf.clear()

    def _control(self, fn, *a, **kw):
        self.flush_pending()
        fn(*a, **kw)

    def output_stream(self, *a, **kw):
        self._control(super().output_stream, *a, **kw)

    def output_pcm_stream(self, *a, **kw):
        self._control(super().output_pcm_stream, *a, **kw)

    def output_track(self, *a, **kw):
        self._control(super().output_track, *a, **kw)

    def output_mode(self, *a, **kw):
        self._control(super().output_mode, *a, **kw)

    def output_halt(self, *a, **kw):
        self._control(super().output_halt, *a, **kw)

    def output_flush(self, *a, **kw):
        self._control(super().output_flush, *a, **kw)

    def output_wait(self):
        self._control(super().output_wait)

    def output_segment(self, *a, **kw):
        self._control(super().output_segment, *a, **kw)

    def output_metadata(self, *a, **kw):
        self._control(super().output_metadata, *a, **kw)

    def output_stream_interrupted(self):
        self._control(super().output_stream_interrupted)

    def output_quit(self):
        self._control(super().output_quit)
