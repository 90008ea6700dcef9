"""The port's rice decode and rice-wire synthesis
(ohpipeline_tpu_torch.codecs.flac) against the JAX package's
``rice_jax.decode_units`` and ``_synthesise_group_rice``, on wire planes
from ``native.flac_parse_group_rice``, over the content mix of
tests/test_flac_rice_device.py: tones, silence and constant subframes, DC,
white noise (large k), impulse escapes, wasted bits, a short final frame in
mono.  Every comparison is bit-exact.  The kernel itself runs only on the
card (marker ``gpu``), against the plain version."""

import numpy as np
import pytest
import torch

from ohpipeline_tpu_torch import _host, _kernels
from ohpipeline_tpu_torch.codecs import flac
from ohpipeline_tpu_torch.codecs.flac import rice
from ohpipeline_tpu_torch.codecs.flac.serving import iter_groups

RATE = 44100


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tones(n=22050, seed=7):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / RATE
    x = (0.5 * np.sin(2 * np.pi * 523 * t) + 0.2 * np.sin(2 * np.pi * 97 * t)
         + 0.02 * rng.standard_normal(n))
    st = np.stack([x, np.roll(x, 17) * 0.8])
    return np.clip(st * 32000, -32768, 32767).astype(np.int32)


def _silence_burst():
    x = np.zeros((2, 22050), np.int32)
    x[0, 15000:15100] = 12000
    return x


def _impulses():
    rng = np.random.default_rng(4)
    x = rng.integers(-2, 3, (2, 22050)).astype(np.int32)
    pos = rng.integers(0, 22050, 12)
    x[0, pos], x[1, pos] = 32000, -32000
    return x


def _short_final_mono():
    rng = np.random.default_rng(6)
    n = 1024 * 9 + 777
    t = np.arange(n) / RATE
    return np.clip(20000 * np.sin(2 * np.pi * 441 * t)
                   + 300 * rng.standard_normal(n),
                   -32768, 32767).astype(np.int32)[None, :]


CONTENT = {
    "tones_noise_stereo": _tones,
    "silence_constant_subframes": _silence_burst,
    "dc_constant_value": lambda: np.full((2, 10000), -1234, np.int32),
    "white_noise_large_k": lambda: np.random.default_rng(3).integers(
        -32768, 32768, (2, 11025)).astype(np.int32),
    "impulse_spikes_escape_codewords": _impulses,
    "wasted_bits": lambda: (np.random.default_rng(5).integers(
        -2048, 2048, (2, 15000)) << 4).astype(np.int32),
    "short_final_frame_and_mono": _short_final_mono,
}


def _groups(name, frames_per_group=16):
    track = CONTENT[name]()
    data = _host.encode_flac(track, RATE, 16, blocksize=1024)
    return track, list(iter_groups([data], frames_per_group))


@pytest.mark.parametrize("name", sorted(CONTENT))
def test_decode_units_matches_jax(name):
    from ohpipeline_tpu.codecs.flac import rice_jax

    _, groups = _groups(name)
    for planes, _meta in groups:
        args = [planes[k] for k in flac.RICE_PLANES[:12]]
        want = np.asarray(rice_jax.decode_units(*args))
        t = flac.to_device(planes, "cpu")
        got = rice.decode_units(*(t[k] for k in flac.RICE_PLANES[:12]))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(CONTENT))
def test_synthesise_group_rice_matches_jax(name):
    from ohpipeline_tpu.codecs.flac import _synthesise_group_rice

    track, groups = _groups(name)
    nch = track.shape[0]
    pcm = []
    for planes, meta in groups:
        want = np.asarray(_synthesise_group_rice(
            *(planes[k] for k in flac.RICE_PLANES), nch))
        t = flac.to_device(planes, "cpu")
        got = flac.synthesise_group_rice(*(t[k] for k in flac.RICE_PLANES),
                                         nch).numpy()
        np.testing.assert_array_equal(got, want)
        (_s, n, sizes), = meta
        pcm += [got[f, :, :sizes[f]] for f in range(n)]
    np.testing.assert_array_equal(np.concatenate(pcm, axis=1), track)


def test_escapes_and_overflow_units_are_exercised():
    _, groups = _groups("impulse_spikes_escape_codewords")
    assert any((p["esc_row"] >= 0).any() for p, _ in groups)
    assert any((p["orow"] >= 0).any() for p, _ in groups)
    _, groups = _groups("silence_constant_subframes")
    assert any((p["cfrow"] >= 0).any() for p, _ in groups)


def test_cpu_tensors_take_plain_version():
    _kernels.reset_launches()
    _, groups = _groups("dc_constant_value")
    t = flac.to_device(groups[0][0], "cpu")
    rice.decode_units(*(t[k] for k in flac.RICE_PLANES[:12]))
    assert _kernels.launches["rice"] == 0


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(cuda):
    streams = [_host.encode_flac(CONTENT[name](), RATE, 16)
               for name in sorted(CONTENT) if name != "short_final_frame_and_mono"]
    for planes, _meta in iter_groups(streams, 32):
        t = flac.to_device(planes, cuda)
        lanes = rice.unit_lanes(*(t[k] for k in flac.RICE_PLANES[:7]))
        _kernels.reset_launches()
        got = rice.scan_units(*lanes)
        torch.cuda.synchronize()
        assert _kernels.launches["rice"] == 1
        assert torch.equal(got, rice.scan_units_torch(*lanes))
