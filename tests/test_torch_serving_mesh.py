"""The port's serving calls with ``mesh=``: the streams split into contiguous
blocks over the mesh's dp rows, each block served with its own group loop,
on a mesh of eight CPU entries (dp 4) and on an uneven one (three entries,
dp 3, for four streams).

Streams have different lengths.  FLAC is bit-exact against ``mesh=None`` and
the encoder's input; AAC-LC and MP3 stay within 1 LSB and HE-AAC within 2
LSB of the JAX package's ``mesh=None`` call (the port's gates for those
paths, ROADMAP items 7, 9 and 10); the JAX package's sharded result is not
the reference.  HE-AAC streams are tests/assets/dryrun_he.aac cut at its
SBR headers, since no machine has an HE encoder.  A mismatched batch raises
the same error with and without ``mesh=``, and a call that names both a
device and a mesh raises.  The ``gpu`` tests hold a logical
mesh of four entries on one card to ``mesh=None`` on it.  JAX is imported
inside the tests that compare with it."""

import functools
import pathlib

import numpy as np
import pytest
import torch

from ohpipeline_tpu_torch import _host, parallel
from ohpipeline_tpu_torch.codecs.aac import serving as aac_serving
from ohpipeline_tpu_torch.codecs.flac import serving as flac_serving
from ohpipeline_tpu_torch.codecs.mp3 import serving as mp3_serving

ASSETS = pathlib.Path(__file__).resolve().parent / "assets"
MESHES = {"cpu8": ["cpu"] * 8, "uneven3": ["cpu"] * 3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pcm(seed, secs, rate=44100):
    t = np.arange(int(rate * secs)) / rate
    rng = np.random.default_rng(seed)
    x = (np.sin(2 * np.pi * (300 + 70 * seed) * t) * 9000
         + rng.standard_normal(len(t)) * 600)
    return np.stack([x, 0.6 * x]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _flac():
    pcms = [_pcm(s, 0.3 + 0.25 * s) for s in range(4)]
    return pcms, [_host.encode_flac(x, 44100, 16, blocksize=1024)
                  for x in pcms]


def _frame_offsets(data: bytes) -> list:
    offsets, pos = [], 0
    while (h := _host.aac_bitstream.parse_adts_header(data, pos)) \
            is not None:
        offsets.append(pos)
        pos += h.frame_bytes
    return offsets + [pos]


def _aac():
    data = (ASSETS / "dryrun.aac").read_bytes()
    off = _frame_offsets(data)
    return [data[:off[k]] for k in (6, 9, 12)] + [data]


def _he():
    data = (ASSETS / "dryrun_he.aac").read_bytes()
    off = _frame_offsets(data)           # an SBR header every 10 frames
    return [data[:off[k]] for k in (10, 20, 30)] + [data]


def _mp3():
    streams = []
    for s in range(4):
        rng = np.random.default_rng(s)
        frames = []
        for _ in range(12 + 7 * s):
            spec = np.zeros((2, 576), np.int32)
            m = rng.random((2, 576)) < 0.22
            spec[m] = rng.integers(1, 12, m.sum())
            spec[rng.random((2, 576)) < 0.5] *= -1
            frames.append(_host.mp3_encoder.build_frame(
                [spec[0], spec[1]], global_gain=int(rng.integers(172, 186))))
        streams.append(b"".join(frames))
    return streams


#: codec -> (port call, JAX module, streams, frames a group, LSB bound)
CODECS = {
    "aac": (aac_serving.decode_aac_streams_device, "aac", _aac, 4, 1),
    "he": (aac_serving.decode_he_streams_device, "aac", _he, 8, 2),
    "mp3": (mp3_serving.decode_mp3_streams_device, "mp3", _mp3, 16, 1),
}


@functools.lru_cache(maxsize=None)
def _jax_mesh_none(codec: str) -> list:
    import importlib

    fn, module, streams, group, _ = CODECS[codec]
    jax_fn = getattr(importlib.import_module(
        f"ohpipeline_tpu.codecs.{module}.serving"), fn.__name__)
    return jax_fn(streams(), frames_per_group=group)


def _lsb(got, want) -> int:
    assert got.shape == want.shape and got.dtype == np.int32
    return int(np.abs(got.astype(np.int64) - want).max())


@pytest.mark.parametrize("name", sorted(MESHES))
def test_flac_mesh_is_bit_exact(name):
    pcms, streams = _flac()
    mesh = parallel.make_mesh(devices=MESHES[name])
    want = flac_serving.decode_flac_streams_device(streams, 8, device="cpu")
    got = flac_serving.decode_flac_streams_device(streams, 8, mesh=mesh)
    assert len({o.shape[1] for o in got}) == 4       # four lengths
    for g, w, x in zip(got, want, pcms):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, x)


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("codec", sorted(CODECS))
def test_mesh_matches_the_jax_call_without_a_mesh(codec, name):
    fn, _, streams, group, bound = CODECS[codec]
    got = fn(streams(), group, mesh=parallel.make_mesh(devices=MESHES[name]))
    want = _jax_mesh_none(codec)
    assert len(got) == len(want) == 4
    assert len({o.shape[1] for o in got}) == 4
    for g, w in zip(got, want):
        assert _lsb(g, w) <= bound


def _mono_flac():
    return _host.encode_flac(_pcm(9, 0.1)[:1], 44100, 16, blocksize=1024)


def _lsf_mp3():
    spec = np.zeros((2, 576), np.int32)
    spec[:, 3] = 5
    return _host.mp3_encoder.build_frame([spec[0], spec[1]], version=2,
                                         sample_rate=22050, bitrate=160)


#: case -> (call, a batch it refuses, the error's text)
MISMATCHED = {
    "flac channels": (flac_serving.decode_flac_streams_device,
                      lambda: _flac()[1] + [_mono_flac()],
                      "uniform channel count"),
    "aac rates": (aac_serving.decode_aac_streams_device,
                  lambda: _aac() + [(ASSETS / "dryrun_he.aac").read_bytes()],
                  "uniform rate/channels"),
    "he without sbr": (aac_serving.decode_he_streams_device, _aac,
                       "frame without SBR payload"),
    "mp3 versions": (mp3_serving.decode_mp3_streams_device,
                     lambda: _mp3() + [_lsf_mp3()],
                     "uniform version/rate/channels"),
}


@pytest.mark.parametrize("case", sorted(MISMATCHED))
def test_a_mismatched_batch_raises_the_same_error(case):
    fn, streams, text = MISMATCHED[case]
    with pytest.raises(ValueError, match=text) as plain:
        fn(streams(), device="cpu")
    with pytest.raises(ValueError) as meshed:
        fn(streams(), mesh=parallel.make_mesh(devices=MESHES["cpu8"]))
    assert str(meshed.value) == str(plain.value)


@pytest.mark.parametrize("codec", ["flac", *sorted(CODECS)])
def test_device_and_mesh_together_raise(codec):
    """The mesh places the work: a call that also names a device raises
    rather than ignoring it."""
    if codec == "flac":
        fn, streams = flac_serving.decode_flac_streams_device, _flac()[1]
    else:
        fn, _, make, _, _ = CODECS[codec]
        streams = make()
    with pytest.raises(ValueError, match="mesh= both given"):
        fn(streams, device="cpu",
           mesh=parallel.make_mesh(devices=MESHES["cpu8"]))


@pytest.mark.gpu
@pytest.mark.parametrize("codec", ["flac", *sorted(CODECS)])
def test_logical_mesh_on_the_card(cuda, codec):
    """Four entries on one card (dp 2) against mesh=None on it: FLAC
    bit-exact, AAC-LC and MP3 within 1 LSB, HE-AAC within 2."""
    if codec == "flac":
        fn, streams, group, bound = (flac_serving.decode_flac_streams_device,
                                     _flac()[1], 8, 0)
    else:
        fn, _, make, group, bound = CODECS[codec]
        streams = make()
    want = fn(streams, group, device="cuda")
    got = fn(streams, group, mesh=parallel.make_mesh(
        devices=["cuda:0"] * 4))
    for g, w in zip(got, want):
        assert _lsb(g, w) <= bound
