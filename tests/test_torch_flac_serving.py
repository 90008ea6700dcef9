"""The port's multi-stream FLAC serving API
(ohpipeline_tpu_torch.codecs.flac.serving.decode_flac_streams_device)
against the JAX package's serving call, its host ``decode_flac`` and the
encoder input, across mixed bit depths, lengths, blocksize tails and group
boundaries, bit-exact.  The ``gpu`` test runs the same call on the card."""

import numpy as np
import pytest
import torch

from ohpipeline_tpu_torch import _host, _kernels
from ohpipeline_tpu_torch.codecs import flac
from ohpipeline_tpu_torch.codecs.flac.serving import (
    decode_flac_streams_device)

RATE = 44100


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _track(seed, seconds, rate=RATE, amp=20000):
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    f1 = 200 + 1500 * rng.random()
    x = np.sin(2 * np.pi * f1 * t) * 0.7 + 0.05 * rng.standard_normal(n)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 0.7 * t)
    return np.stack([np.rint(x * env * amp),
                     np.rint(np.roll(x, 17) * amp * 0.8)]).astype(np.int32)


def _mixed():
    tracks, streams = [], []
    for seed, secs, bits in ((1, 0.5, 16), (2, 0.8, 16), (3, 0.3, 24)):
        tone = _track(seed, secs, amp=20000 if bits == 16 else 5_000_000)
        tracks.append(tone)
        streams.append(_host.encode_flac(tone, RATE, bits, blocksize=1024))
    return tracks, streams


def test_mixed_streams_match_jax_host_and_input():
    from ohpipeline_tpu.codecs.flac import decode_flac
    from ohpipeline_tpu.codecs.flac.serving import (
        decode_flac_streams_device as jax_serving)

    tracks, streams = _mixed()
    outs = decode_flac_streams_device(streams, frames_per_group=8,
                                      device="cpu")
    jax_outs = jax_serving(streams, frames_per_group=8)
    assert len(outs) == len(streams)
    for got, want_jax, data, track in zip(outs, jax_outs, streams, tracks):
        assert got.dtype == np.int32 and got.shape == track.shape
        np.testing.assert_array_equal(got, want_jax)
        np.testing.assert_array_equal(got, decode_flac(data)[1])
        np.testing.assert_array_equal(got, track)


def test_single_stream_single_group():
    tone = _track(9, 0.3)
    data = _host.encode_flac(tone, RATE, 16, blocksize=1024)
    out, = decode_flac_streams_device([data], frames_per_group=64,
                                      device="cpu")
    np.testing.assert_array_equal(out, tone)


def test_synthesise_batch_matches_jax():
    from ohpipeline_tpu.codecs.flac import synthesise_batch as jax_batch

    tone = _track(4, 0.2)
    data = _host.encode_flac(tone, RATE, 16, blocksize=1024)
    si = _host.parse_metadata(data).streaminfo
    n, _pos, status, batch = _host.native.flac_parse_group(
        data, _host.parse_metadata(data).header_bytes * 8,
        sample_rate=si.sample_rate, bits_per_sample=si.bits_per_sample,
        max_blocksize=si.max_blocksize, channels=2, max_frames=16)
    assert status >= 0 and n == 9
    got = flac.synthesise_batch(batch, 2, n, device="cpu")
    np.testing.assert_array_equal(got, jax_batch(batch, 2, n))
    np.testing.assert_array_equal(got, tone)


def test_mixed_channel_counts_raise():
    _tracks, streams = _mixed()
    mono = _host.encode_flac(_track(5, 0.1)[:1], RATE, 16, blocksize=1024)
    with pytest.raises(ValueError, match="uniform channel count"):
        decode_flac_streams_device([streams[0], mono], device="cpu")


@pytest.mark.gpu
def test_serving_on_card_matches_input(cuda):
    tracks, streams = _mixed()
    _kernels.reset_launches()
    outs = decode_flac_streams_device(streams, frames_per_group=8,
                                      device=cuda)
    assert _kernels.launches["rice"] > 0 and _kernels.launches["lpc"] > 0
    for got, track in zip(outs, tracks):
        np.testing.assert_array_equal(got, track)
