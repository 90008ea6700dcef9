"""The port's MP3 serving call
(ohpipeline_tpu_torch.codecs.mp3.serving.decode_mp3_streams_device) against
the JAX package's ``decode_mp3_streams_device``, against its host-path
``decode_mp3`` and against chip_smoke.py's float64 numpy run of the scan form
of the filterbank, on streams made with the port's encoder copy: varied
stereo MPEG-1 frames of ragged lengths (tests/test_mp3_serving.py's
content), frames cycling through every block type, and MPEG-2 LSF frames
(one granule a frame).

Tolerances, and why: <= 1 LSB with equal shapes against the JAX serving
call (the same int16 spectrum wire and float32 program, sums in another
order; 1 LSB measured).  <= 6 LSB and >= 80 dB against ``decode_mp3`` and
the float64 scan, the repo's own bound for the int16 spectrum wire
(``tests/test_mp3_serving.py``: ~3e-5 granule-relative error; 4 LSB, ~90 dB
measured).  The ``gpu`` test runs the call on the card against the CPU (<= 1
LSB) and counts the window kernel's launches."""

import numpy as np
import pytest
import torch

import chip_smoke
from ohpipeline_tpu_torch import _host, _kernels
from ohpipeline_tpu_torch.codecs.mp3.serving import decode_mp3_streams_device


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _stream(seed: int, nframes: int) -> bytes:
    """tests/test_mp3_serving.py's content: varied stereo MP3, per-frame
    random sparse spectra and gains."""
    rng = np.random.default_rng(seed)
    frames = []
    for _ in range(nframes):
        spec = np.zeros((2, 576), np.int32)
        m = rng.random((2, 576)) < 0.22
        spec[m] = rng.integers(1, 12, m.sum())
        spec[rng.random((2, 576)) < 0.5] *= -1
        frames.append(_host.mp3_encoder.build_frame(
            [spec[0], spec[1]], global_gain=int(rng.integers(172, 186))))
    return b"".join(frames)


def _lsb(got, want) -> int:
    assert got.shape == want.shape
    return int(np.abs(got.astype(np.int64) - want).max())


def _host_gate(got, ref):
    assert got.shape == ref.shape
    assert np.abs(got.astype(np.float64) - ref).max() <= 6.0
    assert chip_smoke.snr_db(ref, got) >= 80.0


def test_serving_matches_jax_serving_and_the_host_decode():
    from ohpipeline_tpu.codecs.mp3 import decode_mp3
    from ohpipeline_tpu.codecs.mp3.serving import (
        decode_mp3_streams_device as jax_serving)

    streams = [_stream(i, 12 + 7 * i) for i in range(3)]   # ragged lengths
    got = decode_mp3_streams_device(streams, frames_per_group=8,
                                    device="cpu")
    want = jax_serving(streams, frames_per_group=8)
    assert len(got) == 3
    for g, w, s in zip(got, want, streams):
        assert g.dtype == np.int32
        assert _lsb(g, w) <= 1
        _host_gate(g, decode_mp3(s)[1])


@pytest.mark.parametrize("group", [4, 16])
def test_single_stream_group_boundaries(group):
    from ohpipeline_tpu.codecs.mp3 import decode_mp3
    from ohpipeline_tpu.codecs.mp3.serving import (
        decode_mp3_streams_device as jax_serving)

    data = _stream(9, 21)
    got = decode_mp3_streams_device([data], frames_per_group=group,
                                    device="cpu")[0]
    assert _lsb(got, jax_serving([data], frames_per_group=group)[0]) <= 1
    _host_gate(got, decode_mp3(data)[1])


@pytest.mark.parametrize("lsf", [False, True])
def test_every_block_type_matches_jax_and_float64(lsf):
    """Frames cycling through long, start, short and stop blocks; with
    ``lsf`` MPEG-2 at 22.05 kHz, one granule a frame."""
    from ohpipeline_tpu.codecs.mp3.serving import (
        decode_mp3_streams_device as jax_serving)

    streams = [chip_smoke.mp3_block_stream(20 + s, 15 + 4 * s, lsf)
               for s in range(2)]
    got = decode_mp3_streams_device(streams, 8, device="cpu")
    want = jax_serving(streams, 8)
    for s, (g, w, data) in enumerate(zip(got, want, streams)):
        assert g.shape == (2, (15 + 4 * s) * (576 if lsf else 1152))
        assert _lsb(g, w) <= 1
        _host_gate(g, chip_smoke.mp3_host_reference(data))


def test_mismatched_batch_rejected():
    a = _stream(1, 6)
    mono = _host.mp3_encoder.build_frame(
        [_host.mp3_encoder.tone_spectrum(30)]) * 6
    with pytest.raises(ValueError, match="uniform"):
        decode_mp3_streams_device([a, mono], device="cpu")
    lsf = chip_smoke.mp3_block_stream(3, 4, lsf=True)
    with pytest.raises(ValueError, match="uniform"):
        decode_mp3_streams_device([a, lsf], device="cpu")


def test_group_that_is_not_a_power_of_two_rejected():
    with pytest.raises(ValueError, match="power"):
        decode_mp3_streams_device([_stream(1, 6)], frames_per_group=3,
                                  device="cpu")


def test_not_an_mp3_stream_rejected():
    with pytest.raises(ValueError, match="not an MP3"):
        decode_mp3_streams_device([b"\x00" * 64], device="cpu")


@pytest.mark.gpu
def test_serving_card_matches_cpu(cuda):
    streams = [_stream(i, 12 + 7 * i) for i in range(3)]
    _kernels.reset_launches()
    got = decode_mp3_streams_device(streams, 8, device=cuda)
    assert _kernels.launches["mp3_window"] == 4        # 33 frames, 8 a group
    want = decode_mp3_streams_device(streams, 8, device="cpu")
    for g, w in zip(got, want):
        assert _lsb(g, w) <= 1
