"""The port's FLAC codec plug-in (ohpipeline_tpu_torch.codecs.flac.CodecFlac
and decode_flac) against the JAX package's on the same streams, on the CPU:
16- and 24-bit, mono and stereo, block sizes 1024 and 4096 with a short last
frame, through the native and the Python frame parser.  Every batch, its
track offset and the stream info are equal, the PCM bit for bit, and equal
to the encoder's input; try_seek gives the same byte with and without a
seek table, and decoding from there gives the same samples."""

import struct

import numpy as np
import pytest

from ohpipeline_tpu_torch import _host
from ohpipeline_tpu_torch.codecs import flac
from ohpipeline_tpu_torch.host.codecs import base
from ohpipeline_tpu_torch.host.codecs.flac.bitreader import BitReader


def _track(seed: int, bits: int, channels: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100
    amp = 0.6 * (1 << (bits - 1))
    x = np.stack([np.sin(2 * np.pi * (300 + 170 * c) * t + rng.random())
                  for c in range(channels)]) * amp
    x += rng.normal(0, amp * 1e-3, x.shape)
    return np.clip(np.rint(x), -(1 << (bits - 1)),
                   (1 << (bits - 1)) - 1).astype(np.int32)


def _batches(codec, data: bytes, base) -> tuple:
    """(info, [(track offset, PCM) of each batch]) of ``codec`` over
    ``data``, read through ``base`` (the port's or the JAX package's
    codecs/base.py)."""
    r = base.BufferReader(data)
    info = codec.stream_initialise(r)
    out = []
    while True:
        try:
            b = codec.process(r)
        except base.EndOfStream:
            return info, out
        out.append((b.track_offset_samples, np.asarray(b.resolve())))


def _jax():
    from ohpipeline_tpu.codecs import base as jbase
    from ohpipeline_tpu.codecs import flac as jflac
    return jflac, jbase


def _fields(info) -> tuple:
    return (info.sample_rate, info.bit_depth, info.num_channels,
            info.codec_name, info.lossless, info.seekable, info.bitrate,
            info.track_length_jiffies)


CASES = [(bits, ch, bs, True) for bits in (16, 24) for ch in (1, 2)
         for bs in (1024, 4096)] + [(16, 2, 1024, False), (24, 1, 4096, False)]


@pytest.mark.parametrize("bits,channels,blocksize,use_native", CASES)
def test_codec_matches_jax(bits, channels, blocksize, use_native):
    jflac, jbase = _jax()
    n = 22050 + 333                       # a short last frame
    x = _track(bits + channels, bits, channels, n)
    data = _host.encode_flac(x, 44100, bits, blocksize=blocksize)
    info, got = _batches(flac.CodecFlac(use_native, device="cpu"), data,
                         base)
    jinfo, want = _batches(jflac.CodecFlac(use_native), data, jbase)
    assert _fields(info) == _fields(jinfo)
    assert len(got) == len(want) == -(-n // (blocksize
                                             * flac.GROUP_FRAMES))
    for (go, gp), (wo, wp) in zip(got, want):
        assert go == wo
        assert gp.dtype == wp.dtype == np.int32
        np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(np.concatenate([p for _, p in got], 1), x)


@pytest.mark.parametrize("use_native", [True, False])
def test_decode_flac_matches_jax(use_native):
    jflac, _ = _jax()
    x = _track(5, 16, 2, 30000)
    data = _host.encode_flac(x, 44100, 16, blocksize=1024)
    info, pcm = flac.decode_flac(data, use_native, device="cpu")
    jinfo, jpcm = jflac.decode_flac(data, use_native)
    assert _fields(info) == _fields(jinfo)
    np.testing.assert_array_equal(pcm, jpcm)
    np.testing.assert_array_equal(pcm, x)


def _with_seek_table(data: bytes, every: int) -> bytes:
    """``data`` with a SEEKTABLE block after STREAMINFO holding a point at
    every ``every``-th frame (its first sample, its byte offset from the
    first frame, its sample count)."""
    meta = _host.parse_metadata(data)
    si, head_bytes = meta.streaminfo, meta.header_bytes
    br = BitReader(data, head_bytes * 8)
    points, f = [], 0
    while br.bits_left >= 16:
        start = br.pos // 8
        fr = _host.frames.parse_frame(br, si)
        if f % every == 0:
            points.append(struct.pack(">QQH", fr.header.sample_number,
                                      start - head_bytes,
                                      fr.header.blocksize))
        f += 1
    table = b"".join(points)
    head = bytearray(data[:head_bytes])
    head[4] &= 0x7F                          # STREAMINFO is no longer last
    block = bytes([0x80 | 3]) + len(table).to_bytes(3, "big") + table
    return bytes(head) + block + data[head_bytes:]


@pytest.mark.parametrize("seek_table", [True, False])
@pytest.mark.parametrize("use_native", [True, False])
def test_try_seek_matches_jax(seek_table, use_native):
    jflac, jbase = _jax()
    x = _track(9, 16, 2, 44100)
    data = _host.encode_flac(x, 44100, 16, blocksize=1024)
    if seek_table:
        data = _with_seek_table(data, 8)
        assert len(_host.parse_metadata(data).seek_points) == 6
    target = 20000
    runs = []
    for codec, reader_cls in (
            (flac.CodecFlac(use_native, device="cpu"), base.BufferReader),
            (jflac.CodecFlac(use_native), jbase.BufferReader)):
        r = reader_cls(data)
        codec.stream_initialise(r)
        pos = codec.try_seek(target)
        assert pos is not None and r.try_seek_bytes(pos)
        codec.notify_seek_done(pos)
        b = codec.process(r)
        runs.append((pos, b.track_offset_samples, np.asarray(b.resolve())))
    (pos, off, pcm), (jpos, joff, jpcm) = runs
    assert (pos, off) == (jpos, joff)
    np.testing.assert_array_equal(pcm, jpcm)
    if seek_table:
        # the last point at or before the target: frame 16, sample 16384
        assert off == 16 * 1024
        np.testing.assert_array_equal(pcm, x[:, off:off + pcm.shape[1]])
