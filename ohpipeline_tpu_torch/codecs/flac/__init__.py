"""FLAC device synthesis on tensors, and the FLAC codec plug-in.

Port of ``ohpipeline_tpu.codecs.flac``: the host parser
(``native.flac_parse_group`` / ``flac_parse_group_rice``) yields numpy wire
planes, :func:`to_device` puts them on a device, and one pass per group of
frames runs rice decode (rice wire only) -> escape and warm-up patch -> LPC
recurrence -> wasted-bit shift -> inter-channel decorrelation.  On the card
the rice decode and the LPC recurrence are the hand-written kernels in
``csrc/``; on the CPU their plain PyTorch versions.

:class:`CodecFlac` is the pipeline's plug-in (``recognise``,
``stream_initialise``, ``process``, ``try_seek``): groups of
:data:`GROUP_FRAMES` frames, parsed on the host (rice included, as the JAX
plug-in does, by ``native.flac_parse_group`` or the Python frame parser) and
synthesised by :func:`synthesise_batch` on its ``device`` when the
controller resolves the batch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..._host import frames as FF
from ..._host import native
from ...host.codecs.base import (BufferReader, CodecBase, CodecStreamCorrupt,
                                 DecodedBatch, EndOfStream, StreamReader)
from ...host.codecs.flac.bitreader import BitReader
from ...host.core.jiffies import Jiffies
from ...host.core.streaminfo import PcmStreamInfo
from ...ops import lpc as lpc_ops
from ...ops import pcm as pcm_ops
from . import rice

#: Frames per device pass of one stream (~16 x 4096 = 1.5 s at 44.1 kHz).
GROUP_FRAMES = 16

#: Argument order of :func:`synthesise_group_rice` (before num_channels).
RICE_PLANES = ("bits", "gcur", "gk", "ocur", "okk", "omode", "ocnt", "orow",
               "opos", "cfrow", "cfval", "cfn", "warm", "esc_row", "esc_pos",
               "esc_val", "coeffs", "shift", "order", "wasted", "assign")

#: Per-frame metadata the host keeps; :func:`to_device` leaves it out.
HOST_KEYS = ("blocksize", "sample_number")


def to_device(batch: dict, device) -> dict:
    """Numpy wire planes -> tensors on ``device``: the uint8 byte slab
    ``bits`` stays uint8, every other plane becomes int32 (the parser's
    int8 planes such as ``gk`` included).  Host-only keys are left out."""
    out = {}
    for key, arr in batch.items():
        if key in HOST_KEYS:
            continue
        arr = np.ascontiguousarray(arr)
        if arr.dtype != np.uint8:
            arr = arr.astype(np.int32, copy=False)
        out[key] = torch.from_numpy(arr).to(device)
    return out


def channel_modes(assign):
    """Frame-header assignment codes (F,) -> ``ops.pcm`` CH_* modes."""
    return torch.where(
        assign == FF.ASSIGN_LEFT_SIDE, pcm_ops.CH_LEFT_SIDE,
        torch.where(assign == FF.ASSIGN_RIGHT_SIDE, pcm_ops.CH_RIGHT_SIDE,
                    torch.where(assign == FF.ASSIGN_MID_SIDE,
                                pcm_ops.CH_MID_SIDE,
                                pcm_ops.CH_INDEPENDENT)))


def synthesise_group(data, coeffs, shift, order, wasted, assign,
                     num_channels: int):
    """One device pass over a group of FLAC frames.

    data (B, N) int32 with B = nframes * num_channels (rows frame-major);
    coeffs (B, 32), shift/order/wasted (B,), assign (nframes,) raw channel
    assignment codes.  Returns (nframes, num_channels, N) int32 PCM.
    """
    synth = lpc_ops.lpc_synthesize(data, coeffs, shift, order)
    synth = synth << wasted[:, None]
    B, N = data.shape
    chans = synth.reshape(B // num_channels, num_channels, N)
    if num_channels != 2:
        return chans
    left, right = pcm_ops.stereo_decorrelate(chans[:, 0], chans[:, 1],
                                             channel_modes(assign))
    return torch.stack([left, right], dim=1)


def synthesise_group_rice(bits, gcur, gk, ocur, okk, omode, ocnt, orow,
                          opos, cfrow, cfval, cfn, warm,
                          esc_row, esc_pos, esc_val,
                          coeffs, shift, order, wasted, assign,
                          num_channels: int):
    """:func:`synthesise_group` fed by the rice wire: decode the rice codes
    (``rice.decode_units``), write the host's escape triples and warm-up
    samples over the residual plane, then synthesise."""
    d = rice.decode_units(bits, gcur, gk, ocur, okk, omode, ocnt, orow, opos,
                          cfrow, cfval, cfn)
    B, stride = d.shape
    flat = torch.cat([d.reshape(-1), d.new_zeros(1)])
    # padding triples (row -1) land on the extra slot, which is dropped
    eidx = torch.where(esc_row >= 0, esc_row * stride + esc_pos, B * stride)
    flat[eidx.to(torch.int64)] = esc_val
    d = flat[:B * stride].reshape(B, stride)
    pos = torch.arange(lpc_ops.MAX_ORDER, device=d.device)[None, :]
    d[:, :lpc_ops.MAX_ORDER] = torch.where(pos < order[:, None], warm,
                                           d[:, :lpc_ops.MAX_ORDER])
    return synthesise_group(d, coeffs, shift, order, wasted, assign,
                            num_channels)


def synthesise_batch(batch: dict, num_channels: int, nframes: int, *,
                     device) -> np.ndarray:
    """Run one device pass over a parsed batch dict (layout of
    ``native.flac_parse_group``) and reassemble (channels, samples) int32
    PCM as numpy."""
    if nframes == 0:
        return np.zeros((num_channels, 0), np.int32)
    B = nframes * num_channels
    rows = {k: batch[k][:B] for k in ("data", "coeffs", "shift", "order",
                                      "wasted")}
    rows["assign"] = batch["assign"][:nframes]
    t = to_device(rows, device)
    out = synthesise_group(t["data"], t["coeffs"], t["shift"], t["order"],
                           t["wasted"], t["assign"], num_channels).cpu()
    out = out.numpy()
    bs = batch["blocksize"]
    if all(bs[i] == out.shape[2] for i in range(nframes)):
        return out.transpose(1, 0, 2).reshape(num_channels, -1)
    return np.concatenate([out[fi, :, :bs[fi]] for fi in range(nframes)],
                          axis=1)


def frames_to_batch(parsed: list, num_channels: int) -> dict:
    """Pack Python-parsed frames into the dense batch-dict layout."""
    maxn = max(f.header.blocksize for f in parsed)
    B = len(parsed) * num_channels
    batch = dict(
        data=np.zeros((B, maxn), np.int32),
        coeffs=np.zeros((B, lpc_ops.MAX_ORDER), np.int32),
        shift=np.zeros(B, np.int32), order=np.zeros(B, np.int32),
        wasted=np.zeros(B, np.int32),
        assign=np.zeros(len(parsed), np.int32),
        blocksize=np.zeros(len(parsed), np.int32),
        sample_number=np.zeros(len(parsed), np.int64))
    for fi, fr in enumerate(parsed):
        batch["assign"][fi] = fr.header.assignment
        batch["blocksize"][fi] = fr.header.blocksize
        batch["sample_number"][fi] = fr.header.sample_number
        for ci, sub in enumerate(fr.subframes):
            b = fi * num_channels + ci
            batch["data"][b, :len(sub.data)] = sub.data
            batch["coeffs"][b, :len(sub.coeffs)] = sub.coeffs
            batch["shift"][b] = sub.shift
            batch["order"][b] = sub.order
            batch["wasted"][b] = sub.wasted_bits
    return batch


def synthesise_frames(parsed: list, num_channels: int, *,
                      device) -> np.ndarray:
    """Synthesise a list of parsed frames in one pass on ``device``; returns
    (channels, total_samples) int32 PCM (frames concatenated in order)."""
    if not parsed:
        return np.zeros((num_channels, 0), np.int32)
    return synthesise_batch(frames_to_batch(parsed, num_channels),
                            num_channels, len(parsed), device=device)


class CodecFlac(CodecBase):
    """Native FLAC (reference CodecFlac over libFLAC), synthesising on
    ``device``.  ``use_native`` None or True parses with the port's native
    unpacker (built here on first use; a failed build raises), False with
    the Python frame parser."""

    name = "FLAC"
    recognition_cost = 20
    mime_types = ("audio/flac", "audio/x-flac")

    def __init__(self, use_native: Optional[bool] = None, *, device="cuda"):
        self._meta: Optional[FF.Metadata] = None
        self._info: Optional[PcmStreamInfo] = None
        self._buf = b""
        self._bit_pos = 0
        self._sample_pos = 0
        self._use_native = use_native is None or use_native
        if self._use_native:
            native.have_flac_unpack()
        self._device = torch.device(device)

    def recognise(self, header: bytes) -> bool:
        return header[:4] == b"fLaC"

    def stream_initialise(self, reader: StreamReader) -> PcmStreamInfo:
        # Buffer the whole metadata prefix, then stream frames.
        head = reader.read(64 * 1024)
        try:
            self._meta = FF.parse_metadata(head)
        except FF.FlacError as e:
            raise CodecStreamCorrupt(str(e)) from e
        si = self._meta.streaminfo
        self._buf = head
        self._bit_pos = self._meta.header_bytes * 8
        self._reader = reader
        self._sample_pos = 0
        self._info = PcmStreamInfo(
            sample_rate=si.sample_rate, bit_depth=si.bits_per_sample,
            num_channels=si.channels, codec_name="FLAC", lossless=True,
            seekable=True,
            bitrate=(si.sample_rate * si.channels * si.bits_per_sample) // 2,
            track_length_jiffies=si.total_samples
            * Jiffies.per_sample(si.sample_rate))
        return self._info

    def _fill(self, want: int) -> None:
        while len(self._buf) * 8 - self._bit_pos < want * 8:
            chunk = self._reader.read(256 * 1024)
            if not chunk:
                return
            # drop consumed whole bytes to bound the buffer
            consumed = self._bit_pos // 8
            if consumed > 128 * 1024:
                self._buf = self._buf[consumed:]
                self._bit_pos -= consumed * 8
            self._buf += chunk

    def process(self, reader: StreamReader) -> DecodedBatch:
        si = self._meta.streaminfo
        max_frame = si.max_framesize or (
            si.max_blocksize * si.channels * 5 + 1024)
        if self._use_native:
            return self._process_native(max_frame)
        parsed: list = []
        first_sample = self._sample_pos
        while len(parsed) < GROUP_FRAMES:
            self._fill(max_frame * 2)
            br = BitReader(self._buf, self._bit_pos)
            if br.bits_left < 16:
                break
            try:
                fr = FF.parse_frame(br, si)
            except (EOFError, ValueError):
                break
            except FF.FlacError:
                # lost sync: scan forward (stream_decoder.c resync)
                nxt = FF.resync(self._buf, (self._bit_pos // 8) + 1, si)
                if nxt is None:
                    break
                self._bit_pos = nxt * 8
                continue
            self._bit_pos = br.pos
            parsed.append(fr)
            self._sample_pos = fr.header.sample_number + fr.header.blocksize
        if not parsed:
            raise EndOfStream
        nch, dev = si.channels, self._device
        return DecodedBatch(
            self._info,
            defer=lambda: synthesise_frames(parsed, nch, device=dev),
            track_offset_samples=first_sample)

    def _process_native(self, max_frame: int) -> DecodedBatch:
        si = self._meta.streaminfo
        self._fill(max_frame * (GROUP_FRAMES + 1))
        nframes, pos, _status, batch = native.flac_parse_group(
            self._buf, self._bit_pos, sample_rate=si.sample_rate,
            bits_per_sample=si.bits_per_sample,
            max_blocksize=si.max_blocksize, channels=si.channels,
            max_frames=GROUP_FRAMES)
        if nframes == 0:
            raise EndOfStream
        self._bit_pos = pos
        first_sample = int(batch["sample_number"][0])
        self._sample_pos = (int(batch["sample_number"][nframes - 1])
                            + int(batch["blocksize"][nframes - 1]))
        nch, dev = si.channels, self._device
        return DecodedBatch(
            self._info,
            defer=lambda: synthesise_batch(batch, nch, nframes, device=dev),
            track_offset_samples=first_sample)

    def try_seek(self, sample: int) -> Optional[int]:
        """Sample -> byte via seek table, else proportional guess + resync
        (the reference's libFLAC does binary search; proportional + resync
        reaches the same frame for CBR-ish streams)."""
        if self._meta is None:
            return None
        si = self._meta.streaminfo
        base = self._meta.header_bytes
        best = None
        for s, off, _n in self._meta.seek_points:
            if s <= sample:
                best = (s, off)
        if best is not None:
            self._sample_pos = best[0]
            return base + best[1]
        if si.total_samples and self._reader.stream_bytes:
            frac = sample / si.total_samples
            pos = base + int(frac * (self._reader.stream_bytes - base))
            self._sample_pos = sample  # refined by next frame header
            return pos
        return None

    def notify_seek_done(self, byte_pos: int) -> None:
        """Reset internal buffering after the upstream repositioned."""
        self._buf = b""
        self._bit_pos = 0


def decode_flac(data: bytes, use_native: Optional[bool] = None, *,
                device="cuda") -> tuple:
    """Whole-buffer decode through :class:`CodecFlac` on ``device``:
    returns (PcmStreamInfo, (channels, n) int32 PCM), bit-exact."""
    codec = CodecFlac(use_native=use_native, device=device)
    r = BufferReader(data)
    info = codec.stream_initialise(r)
    parts = []
    while True:
        try:
            parts.append(codec.process(r).resolve())
        except EndOfStream:
            break
    pcm = (np.concatenate(parts, axis=1) if parts
           else np.zeros((info.num_channels, 0), np.int32))
    return info, pcm
