"""Vorbis codec (Ogg framing).

Parity target: OpenHome/Media/Codec/Vorbis.cpp (adapter over Tremor) —
validated against the compiled Tremor oracle.  Split: header/floor
entropy in Python (LSB-first bitstream, spec-exact integer floor math),
the per-symbol residue/codebook walk in the native helper
(native/vorbis_core.cc, Python fallback bit-for-bit identical), batched
O(n log n) host IMDCT per block size (synthesis.imdct_many), host
lapped overlap-add (synthesis.Lapper).  The matmul IMDCT operator
remains for the sharded device pipeline (parallel/), and the
multi-stream serving shape has a full batched device synthesis path
(vorbis_jax.py: IMDCT+window as per-config MXU matmuls, overlap-add
as one scatter, vmapped over streams) with this host path as oracle.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ...core.jiffies import Jiffies
from ...core.streaminfo import PcmStreamInfo
from ..base import (CodecBase, CodecStreamCorrupt, DecodedBatch, EndOfStream,
                    StreamReader)
from ...containers.ogg import OggReader
from .codebook import VorbisError
from .headers import parse_comment, parse_identification, parse_setup
from .synthesis import Lapper, PacketDecoder, imdct_many

GROUP_PACKETS = 64


def _last_granule(reader, nbytes: int, chunk: int = 65536) -> int:
    """Backward scan for the stream's final OggS page granule (the
    reference's FindSync, Vorbis.cpp:269).  Restores the read position;
    returns 0 when the reader can't seek."""
    if not getattr(reader, "random_access", False):
        return 0                    # upstream seeks have flush semantics
    here = getattr(reader, "pos", None)
    start = max(0, nbytes - chunk)
    if not reader.try_seek_bytes(start):
        return 0
    tail = reader.read(nbytes - start)
    granule = 0
    i = tail.rfind(b"OggS")
    while i != -1:
        if i + 14 <= len(tail):
            g = int.from_bytes(tail[i + 6:i + 14], "little", signed=True)
            if g > 0:
                granule = g
                break
        i = tail.rfind(b"OggS", 0, i)
    if here is not None:
        reader.try_seek_bytes(here)
    return max(0, granule)


def _to_int16_range(x: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(x * 32768.0), -32768, 32767).astype(np.int32)


class _VorbisStream:
    def __init__(self, info, setup):
        self.info = info
        self.decoder = PacketDecoder(info, setup)
        self.lapper = Lapper(info.channels, info.blocksize[0])

    def decode_packets(self, packets: list[bytes]) -> np.ndarray:
        """Decode a group: host entropy first, then one device IMDCT
        batch per block size, then ordered overlap-add."""
        blocks = []
        for p in packets:
            try:
                r = self.decoder.decode_spectrum(p)
            except VorbisError:
                r = None
            if r is not None:
                blocks.append(r)
        if not blocks:
            return np.zeros((self.info.channels, 0), np.int32)
        # batch per block size, keeping packet order
        by_n: dict[int, list[int]] = {}
        for i, (n, _pf, _nf, _s) in enumerate(blocks):
            by_n.setdefault(n, []).append(i)
        times: dict[int, np.ndarray] = {}
        for n, idxs in by_n.items():
            spec = np.stack([blocks[i][3] for i in idxs])   # (T, ch, n/2)
            T, ch, half = spec.shape
            t = imdct_many(spec.reshape(T * ch, half), n)
            times[n] = t.reshape(T, ch, n)
        pos_in_group = {n: 0 for n in by_n}
        outs = []
        for i, (n, pf, nf, _s) in enumerate(blocks):
            t = times[n][pos_in_group[n]]
            pos_in_group[n] += 1
            outs.append(self.lapper.add_block(t, n, pf, nf))
        return _to_int16_range(np.concatenate(outs, axis=1))


class CodecVorbis(CodecBase):
    name = "Vorbis"
    recognition_cost = 45
    mime_types = ("audio/ogg", "application/ogg", "audio/x-ogg")

    def __init__(self):
        self._info: Optional[PcmStreamInfo] = None

    def recognise(self, header: bytes) -> bool:
        if header[:4] != b"OggS":
            return False
        # first page's first packet must be the Vorbis id header
        return b"\x01vorbis" in header[:128]

    def stream_initialise(self, reader: StreamReader) -> PcmStreamInfo:
        self._ogg = OggReader(reader)
        self._packets = self._ogg.packets()
        try:
            ident = parse_identification(next(self._packets))
            _vendor, self.tags = parse_comment(next(self._packets))
            setup = parse_setup(next(self._packets), ident.channels)
        except (StopIteration, VorbisError, IndexError) as e:
            raise CodecStreamCorrupt(f"vorbis headers: {e}")
        self._vs = _VorbisStream(ident, setup)
        self._done = False
        self._sample_pos = 0
        nbytes = reader.stream_bytes or 0
        # exact duration from the final page granule, like the reference
        # (Vorbis.cpp FindSync scans backwards for the last OggS page);
        # fall back to the nominal-bitrate estimate on non-seekable input
        self._samples_total = 0
        if nbytes:
            self._samples_total = _last_granule(reader, nbytes)
        total_jiffies = 0
        if self._samples_total:
            total_jiffies = self._samples_total \
                * Jiffies.per_sample(ident.sample_rate)
        elif nbytes and ident.bitrate_nominal:
            seconds = nbytes * 8 / ident.bitrate_nominal
            total_jiffies = int(seconds * Jiffies.kPerSecond)
        self._ident = ident
        self._setup = setup
        self._stream_bytes = nbytes
        self._pending_seek: Optional[int] = None
        self._info = PcmStreamInfo(
            sample_rate=ident.sample_rate, bit_depth=16,
            num_channels=ident.channels, codec_name="Vorbis",
            lossless=False,
            seekable=bool(nbytes and (self._samples_total
                                      or ident.bitrate_nominal)),
            bitrate=ident.bitrate_nominal or 0,
            track_length_jiffies=total_jiffies)
        return self._info

    def try_seek(self, sample: int) -> Optional[int]:
        """Stream-position-proportional byte estimate, the reference's
        strategy (Vorbis.cpp TrySeek: aSample * StreamLength /
        iSamplesTotal); decode restarts at the next Ogg page boundary.
        The reset is deferred to the decode thread's process()."""
        if self._info is None or not self._info.seekable:
            return None
        if self._samples_total:
            byte = sample * self._stream_bytes // self._samples_total
        else:
            seconds = sample / self._ident.sample_rate
            byte = int(seconds * self._ident.bitrate_nominal / 8)
        byte = max(0, min(byte, self._stream_bytes - 1))
        self._pending_seek = sample
        return byte

    def _reinit_after_seek(self, reader: StreamReader) -> None:
        self._ogg = OggReader(reader, serial=self._ogg.serial)
        self._packets = self._ogg.packets()
        self._vs = _VorbisStream(self._ident, self._setup)
        self._sample_pos = self._pending_seek
        self._done = False
        self._pending_seek = None

    def process(self, reader: StreamReader) -> DecodedBatch:
        if self._pending_seek is not None:   # post-seek restart
            self._reinit_after_seek(reader)
        if self._done:
            raise EndOfStream
        packets = []
        for p in self._packets:
            packets.append(p)
            if len(packets) >= GROUP_PACKETS:
                break
        if not packets:
            raise EndOfStream
        if len(packets) < GROUP_PACKETS:
            self._done = True
        vs = self._vs
        first = self._sample_pos
        granule = self._ogg.last_granule

        def run():
            out = vs.decode_packets(packets)
            if self._done and granule >= 0:
                # truncate the tail to the stream's granule count
                keep = max(0, int(granule) - first)
                if out.shape[1] > keep:
                    out = out[:, :keep]
            self._sample_pos = first + out.shape[1]
            return out

        return DecodedBatch(self._info, defer=run,
                            track_offset_samples=first)


def decode_vorbis(data: bytes) -> tuple[PcmStreamInfo, np.ndarray]:
    """Whole-buffer decode (tests/tools)."""
    from ..base import BufferReader
    codec = CodecVorbis()
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
