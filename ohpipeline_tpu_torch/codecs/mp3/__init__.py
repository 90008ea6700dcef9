"""MP3 (MPEG-1/2/2.5 Layer III): the filterbank's group decode and the
multi-stream serving call, on tensors.

Port of the device half of ``ohpipeline_tpu.codecs.mp3``: the parallel path
of ``decode_frames_lazy`` (``mp3/__init__.py:115-134``) and
``decode_frames``.  The host entropy decode (headers, side info, bit
reservoir, scalefactors, the native Huffman core) and the numpy prep
(requantize, stereo, alias reduction: ``prepare_granules``) are the port's
copies under ``host/codecs/mp3``; the hybrid filterbank runs on the device
(``synthesis``), with its overlap and V-FIFO state kept there between
groups.  ``serving.decode_mp3_streams_device`` is the serving call, and
:class:`CodecMp3` the pipeline's plug-in (``mp3/__init__.py:197-326``):
recognition, the Xing/VBRI duration and TOC seek, and groups of
:data:`GROUP_FRAMES` frames with one group in flight, each one
``mp3_window`` launch on the plug-in's device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...host.codecs.base import (BufferReader, CodecBase, CodecStreamCorrupt,
                                 DecodedBatch, EndOfStream, StreamReader)
from ...host.codecs.mp3 import bitstream as BS
from ...host.codecs.mp3.prep import parse_vbr_header, prepare_granules
from ...host.core.jiffies import Jiffies
from ...host.core.streaminfo import PcmStreamInfo
from . import synthesis as SYN

__all__ = ["CodecMp3", "GROUP_FRAMES", "StreamState", "decode_frames",
           "decode_frames_lazy", "decode_mp3", "parse_vbr_header",
           "prepare_granules"]

GROUP_FRAMES = 16    # 2 granules each -> 32 granules a launch


class StreamState:
    """One stream's filterbank state on ``device``: overlap (C, 576) and
    vfifo (C, 16, 64)."""

    def __init__(self, channels: int, device="cuda"):
        self.device = torch.device(device)
        self.overlap, self.vfifo = SYN.init_state(channels, self.device)


def decode_frames_lazy(frames: list[BS.Mp3Frame], state: StreamState,
                       channels: int, bit_depth: int = 16):
    """Host prep of a group of parsed frames and the filterbank's launch on
    the state's device, now (the state advances at once); returns a
    zero-argument function that copies the PCM back as (channels, n) int32
    in the bit_depth range.  Unlike the JAX path, which pads a group to a
    granule bucket (32, 64, ...) so that jit compiles few shapes, the group
    runs at its own length: nothing here compiles per shape, and the PCM of
    a granule does not depend on the padding after it."""
    xr_t, bt_t = prepare_granules(frames, channels)
    n_real = xr_t.shape[0]
    if not n_real:
        return lambda: np.zeros((channels, 0), np.int32)
    dev = state.device
    pcm, state.overlap, state.vfifo = SYN.hybrid_synthesis_parallel(
        torch.from_numpy(xr_t).to(dev), torch.from_numpy(bt_t).to(dev),
        state.overlap, state.vfifo, n_real, bit_depth)
    return lambda: pcm.cpu().numpy().transpose(1, 0, 2).reshape(channels, -1)


def decode_frames(frames: list[BS.Mp3Frame], state: StreamState,
                  channels: int, bit_depth: int = 16) -> np.ndarray:
    """Decode parsed frames -> (channels, n) int32 in the bit_depth range."""
    return decode_frames_lazy(frames, state, channels, bit_depth)()


class CodecMp3(CodecBase):
    """MP3 (reference CodecMp3, Mp3.cpp) decoding its filterbank on
    ``device``: the JAX plug-in's recognition, duration, seek and one-group
    software pipeline, with the stream's overlap and V-FIFO state kept on
    the device (:class:`StreamState`)."""

    name = "MP3"
    recognition_cost = 40
    mime_types = ("audio/mpeg", "audio/mp3", "audio/x-mp3")

    def __init__(self, group_frames: int = GROUP_FRAMES, *, device="cuda"):
        self._info: Optional[PcmStreamInfo] = None
        self._stream: Optional[BS.Mp3Stream] = None
        self._state: Optional[StreamState] = None
        self._buf = b""
        self._sample_pos = 0
        self._pending: Optional[tuple] = None
        self._seek_to: Optional[int] = None
        #: frames decoded per launch: the pipeline default (16, ~0.4 s)
        #: keeps streaming latency low; a whole-buffer decode takes larger
        #: groups
        self._group_frames = group_frames
        self._device = torch.device(device)

    def recognise(self, header: bytes) -> bool:
        hdr = BS.parse_frame_header(header)
        if hdr is None:
            return False
        nxt = BS.parse_frame_header(header, hdr.frame_bytes)
        return nxt is not None and nxt.sample_rate == hdr.sample_rate

    def stream_initialise(self, reader: StreamReader) -> PcmStreamInfo:
        self._buf = reader.read(64 * 1024)
        self._reader = reader
        hdr = BS.parse_frame_header(self._buf)
        if hdr is None:
            raise CodecStreamCorrupt("no MP3 sync")
        self._hdr = hdr
        self._stream = BS.Mp3Stream(self._buf)
        self._state = StreamState(hdr.channels, self._device)
        self._sample_pos = 0
        total = reader.stream_bytes or 0
        self._vbr = parse_vbr_header(self._buf, hdr)
        if self._vbr:
            frames = self._vbr["frames"]
            if not total:
                total = self._vbr["bytes"]
            # the Xing/VBRI frame itself carries no audio: skip it
            self._stream.pos = hdr.frame_bytes
        else:
            frames = total // hdr.frame_bytes if total else 0
        self._stream_bytes = total
        self._info = PcmStreamInfo(
            sample_rate=hdr.sample_rate, bit_depth=16,
            num_channels=hdr.channels, codec_name="MP3", lossless=False,
            seekable=bool(total), bitrate=hdr.bitrate,
            track_length_jiffies=frames * hdr.samples_per_frame
            * Jiffies.per_sample(hdr.sample_rate))
        return self._info

    def _fill(self) -> None:
        want = self._hdr.frame_bytes * (self._group_frames + 2)
        while len(self._buf) - self._stream.pos < want:
            chunk = self._reader.read(128 * 1024)
            if not chunk:
                return
            self._buf += chunk
            self._stream.data = self._buf

    def try_seek(self, sample: int) -> Optional[int]:
        """The byte to restart at for ``sample``: with a Xing/VBRI TOC an
        interpolation of its 100-percentile byte map, else the CBR frame
        position (reference Mp3.cpp:331).  Only the target is recorded: the
        next process() replaces the stream and its device state, and drops
        the group in flight (the seek flush discards it)."""
        if self._info is None or not self._info.seekable:
            return None
        frame = sample // self._hdr.samples_per_frame
        self._seek_to = frame * self._hdr.samples_per_frame
        if self._vbr and self._vbr.get("toc") and self._vbr["frames"]:
            total_samples = self._vbr["frames"] * self._hdr.samples_per_frame
            pct = min(99.999, max(0.0, 100.0 * sample / total_samples))
            toc = self._vbr["toc"]
            i = int(pct)
            lo = toc[i]
            hi = toc[i + 1] if i + 1 < 100 else 1.0
            frac = pct - i
            nbytes = self._vbr["bytes"] or self._stream_bytes
            return int((lo + (hi - lo) * frac) * nbytes)
        return frame * self._hdr.frame_bytes

    def _reinit_after_seek(self, reader: StreamReader) -> None:
        self._buf = reader.read(64 * 1024)
        self._reader = reader
        self._stream = BS.Mp3Stream(self._buf)
        self._state = StreamState(self._hdr.channels, self._device)
        self._sample_pos = self._seek_to
        self._seek_to = None
        self._pending = None            # seek flush discards in-flight

    def _parse_dispatch_group(self) -> Optional[tuple]:
        """Parse one group and queue its filterbank on the device.  Returns
        (resolve, track offset), or None at the end of the stream."""
        self._fill()
        frames = []
        while len(frames) < self._group_frames:
            fr = self._stream.next_frame()
            if fr is None:
                break
            frames.append(fr)
        if not frames:
            return None
        first = self._sample_pos
        self._sample_pos += len(frames) * self._hdr.samples_per_frame
        resolve = decode_frames_lazy(frames, self._state, self._hdr.channels)
        return resolve, first

    def process(self, reader: StreamReader) -> DecodedBatch:
        """One group in flight: group k's filterbank runs on the device
        while this call parses and queues group k+1; returns the oldest
        group queued."""
        if self._seek_to is not None:     # post-seek restart
            self._reinit_after_seek(reader)
        if self._pending is None:
            self._pending = self._parse_dispatch_group()
            if self._pending is None:
                raise EndOfStream
        nxt = self._parse_dispatch_group()
        resolve, first = self._pending
        self._pending = nxt
        return DecodedBatch(self._info, samples=resolve(),
                            track_offset_samples=first)


def decode_mp3(data: bytes, *, device="cuda") -> tuple:
    """Whole-buffer decode through :class:`CodecMp3` (256 frames a group) on
    ``device``: returns (PcmStreamInfo, (channels, n) int32 PCM)."""
    codec = CodecMp3(group_frames=256, device=device)
    r = BufferReader(data)
    info = codec.stream_initialise(r)
    parts = []
    while True:
        try:
            parts.append(codec.process(r).resolve())
        except EndOfStream:
            break
    return info, (np.concatenate(parts, axis=1) if parts
                  else np.zeros((info.num_channels, 0), np.int32))
