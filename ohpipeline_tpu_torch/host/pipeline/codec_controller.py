"""CodecController: pulls encoded events, recognises a codec, runs its
decode loop, emits decoded events downstream.

Parity target: OpenHome/Media/Codec/CodecController.cpp — recognition over
a rewindable window (306-431: pull loop, recognition 362-388 with Rewinder
rewind between attempts, StreamInitialise 412, Process loop 431), seek
brokering (ISeeker), EOS handling.

TPU-first deltas: the controller is pull-driven (no dedicated codec thread;
the render chain's demand drives decode) and each `process()` call may
yield a *deferred device batch* (DecodedBatch.defer) that the controller
resolves — many frames per device dispatch (the batching the reference
cannot do).

The port's copy of the JAX package's ``pipeline/codec_controller.py``, with
one change: a device fault is not stream corruption.  A ``KernelError`` of
the port's kernels, or an error torch raises for an operation on the card
(``_kernels.is_device_fault``), out of ``stream_initialise()``,
``process()`` or a batch's ``resolve()`` propagates to the caller of
``pull()``; every other error still ends the stream with a
``StreamInterruptedEvent``, as the reference's contract for hostile input
says.
"""

from __future__ import annotations

from typing import Optional

from ... import _kernels
from ..codecs.base import (CodecBase, CodecRegistry, CodecStreamCorrupt,
                           DecodedBatch, EndOfStream, StreamReader)
from ..core import events as ev
from ..core.streaminfo import AudioFormat
from .elements import Element

RECOGNITION_BYTES = 64 * 1024


class _PulledStreamReader(StreamReader):
    """StreamReader over the event stream: consumes EncodedAudioEvents,
    queues any control event encountered for the controller (the
    reference's CodecController does the same interleaving)."""

    def __init__(self, controller: "CodecController"):
        self._c = controller
        self._buf = bytearray()
        self._eos = False

    def reset(self):
        self._buf.clear()
        self._eos = False

    def _fill(self, want: int) -> bool:
        while len(self._buf) < want and not self._eos:
            e = self._c._pull_upstream()
            if e is None or e.kind in ("halt", "quit"):
                if e is not None:
                    self._c._queue_control(e)
                self._eos = True
                return False
            if e.kind == "encoded_audio":
                self._buf += e.data
            elif e.kind in ("encoded_stream", "track", "mode", "flush",
                            "wait", "stream_interrupted"):
                # stream boundary/control: stop filling, hand to controller
                self._c._queue_control(e)
                self._eos = True
            elif e.kind == "metatext":
                self._c._emit(ev.MetaTextEvent(e.text))
            # drain/delay/segment pass through
            elif e.kind in ("drain", "delay", "stream_segment"):
                self._c._emit(e)
        return len(self._buf) >= want

    def read(self, nbytes: int) -> bytes:
        self._fill(nbytes)
        out = bytes(self._buf[:nbytes])
        del self._buf[:nbytes]
        return out

    def peek(self, nbytes: int) -> bytes:
        self._fill(nbytes)
        return bytes(self._buf[:nbytes])

    @property
    def stream_bytes(self) -> Optional[int]:
        info = self._c._stream_info
        return info.total_bytes if info and info.total_bytes else None

    def try_seek_bytes(self, pos: int) -> bool:
        handler = self._c._stream_handler
        if handler is None:
            return False
        fid = handler.try_seek(self._c._stream_id, pos)
        if fid == ev.FlushEvent.ID_INVALID:
            return False
        self.reset()
        return True


class CodecController(Element):
    """Recognise + decode loop as a pull-model element."""

    def __init__(self, upstream, registry: CodecRegistry, containers=None,
                 name: str = ""):
        super().__init__(upstream, name)
        self._registry = registry
        if containers is None:
            from ..containers import ContainerController, default_containers
            containers = ContainerController(default_containers())
        self._containers = containers
        self._reader = _PulledStreamReader(self)
        self._active_reader: StreamReader = self._reader
        self._active: Optional[CodecBase] = None
        self._stream_info = None
        self._stream_handler = None
        self._stream_id = 0
        self._next_stream_id = 1
        self._control: list[ev.Event] = []
        self._pcm_info = None
        self._emitted: list[ev.Event] = []

    # -- plumbing used by the reader --------------------------------------
    def _pull_upstream(self) -> Optional[ev.Event]:
        return self.upstream.pull()

    def _queue_control(self, e: ev.Event) -> None:
        self._control.append(e)

    def _emit(self, e: ev.Event) -> None:
        self._emitted.append(e)

    # -- seek API (ISeeker) ------------------------------------------------
    def start_seek(self, stream_id: int, sample: int) -> int:
        """Returns the flush id that will follow, or ID_INVALID."""
        if self._active is None or stream_id != self._stream_id:
            return ev.FlushEvent.ID_INVALID
        byte_pos = self._active.try_seek(sample)
        if byte_pos is None or self._stream_handler is None:
            return ev.FlushEvent.ID_INVALID
        fid = self._stream_handler.try_seek(self._stream_id, byte_pos)
        if fid != ev.FlushEvent.ID_INVALID:
            self._reader.reset()
            if hasattr(self._active, "notify_seek_done"):
                self._active.notify_seek_done(byte_pos)
        return fid

    # -- pull --------------------------------------------------------------
    def pull(self) -> ev.Event:
        while True:
            if self._emitted:
                return self._emitted.pop(0)
            # control events queued during reads are handled only once the
            # active codec has drained its buffered bytes (the reference's
            # CodecController interleaves identically: a Halt mid-read
            # doesn't abort decode of already-buffered audio)
            if self._control and self._active is None:
                e = self._control.pop(0)
                if e.kind == "encoded_stream":
                    self._begin_stream(e)
                    continue
                return e
            if self._active is None:
                e = self.upstream.pull()
                if e.kind == "encoded_stream":
                    self._begin_stream(e)
                    continue
                if e.kind == "encoded_audio":
                    continue  # no active stream: discard stray bytes
                return e
            try:
                batch = self._active.process(self._active_reader)
                self._emit_batch(batch)
            except EndOfStream:
                self._active = None
                self._reader._eos = False
                continue
            except CodecStreamCorrupt:
                self._active = None
                self._reader.reset()
                self._emit(ev.StreamInterruptedEvent())
                continue
            except Exception as exc:                   # noqa: BLE001
                # hostile/corrupt input must never take the pipeline
                # down (reference contract: invalid codec files are
                # rejected without crash, TestCodecInit.cpp:81-82, under
                # valgrind on every commit) — an unexpected decoder
                # error is stream corruption, not a pipeline fault; a
                # fault of the card is not the stream's and goes up
                if _kernels.is_device_fault(exc):
                    raise
                self._active = None
                self._reader.reset()
                self._emit(ev.StreamInterruptedEvent())
                continue

    def _begin_stream(self, e: ev.EncodedStreamEvent) -> None:
        self._stream_info = e.info
        self._stream_handler = e.stream_handler
        self._stream_id = e.info.stream_id or self._next_stream_id
        self._next_stream_id += 1
        self._reader.reset()
        self._active_reader = self._reader
        self._pcm_info = None
        # raw PCM/DSD streams skip recognition (format announced inline)
        if e.info.pcm_format is not None:
            from ..codecs.pcm_raw import CodecPcm
            from ..codecs.dsd import CodecDsdRaw
            fmt = e.info.pcm_format
            codec = (CodecDsdRaw(fmt)
                     if fmt.audio_format is AudioFormat.DSD else
                     CodecPcm(fmt))
            self._active = codec
        else:
            # container sniff first (ContainerController, Container.cpp:441)
            if self._containers is not None:
                self._active_reader, meta = self._containers.process(
                    self._reader)
                if meta.get("title"):
                    text = meta["title"]
                    if meta.get("artist"):
                        text = f"{meta['artist']} - {text}"
                    self._emit(ev.MetaTextEvent(text))
            header = self._active_reader.peek(RECOGNITION_BYTES)
            self._active = self._registry.recognise(header)
        if self._active is None:
            self._emit(ev.StreamInterruptedEvent())
            return
        try:
            info = self._active.stream_initialise(self._active_reader)
        except Exception as exc:                       # noqa: BLE001
            # CodecStreamCorrupt, EndOfStream, or any unexpected parser
            # error on hostile input: reject the stream without crash
            if _kernels.is_device_fault(exc):
                raise
            self._active = None
            self._emit(ev.StreamInterruptedEvent())
            return
        self._pcm_info = info.with_(
            seekable=info.seekable and self._stream_info.seekable,
            live=self._stream_info.live)
        self._emit(ev.DecodedStreamEvent(self._stream_id, self._pcm_info,
                                         self._stream_handler))

    def _emit_batch(self, batch: DecodedBatch) -> None:
        samples = batch.resolve()
        if samples.shape[1] == 0:
            return
        info = self._pcm_info or batch.info
        if info.audio_format is AudioFormat.DSD:
            self._emit(ev.AudioDsdEvent(samples, info,
                                        batch.track_offset_samples
                                        * info.jiffies_per_sample))
        else:
            self._emit(ev.AudioPcmEvent(
                samples, info,
                batch.track_offset_samples * info.jiffies_per_sample))
