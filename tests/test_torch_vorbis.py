"""The port's batched Vorbis synthesis (ohpipeline_tpu_torch.codecs.vorbis
.device) against the JAX package's ``vorbis_jax`` and against the host
synthesis (the port's copy of ``synthesis.imdct_many`` + ``Lapper``, float64),
on streams made with the port's ``StreamSpec`` copy: mixed, all-long and
all-short blocks, stereo with coupling and mono (tests/test_vorbis_device.py's
content), and bench_secondary.py's all-long content.

Tolerances, and why: the operators are exact.  <= 1 LSB against the JAX
serving call (the same int16 spectrum wire and float32 products, summed in
another order; 1 LSB measured), between group sizes and between a batch and
single streams.  <= 2 LSB and >= 60 dB against the host synthesis, the
repo's own bound for the device path (tests/test_vorbis_device.py; 1 LSB
measured).  The ``gpu`` test runs the call on the card against the CPU (<= 1
LSB)."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import chip_smoke
from ohpipeline_tpu_torch import _host
from ohpipeline_tpu_torch.codecs.vorbis import device as VD
from ohpipeline_tpu_torch.host.codecs.vorbis import residue


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _make_stream(seed, nblocks=40, coupling=True, mode="mixed", ch=2):
    """tests/test_vorbis_device.py's content."""
    rng = np.random.default_rng(seed)
    spec = _host.vorbis_encoder.StreamSpec(
        channels=ch, sample_rate=44100, bs0=256, bs1=1024, coupling=coupling)
    blocks = []
    for _ in range(nblocks):
        if mode == "mixed":
            lng = int(rng.random() < 0.7)
        else:
            lng = 1 if mode == "long" else 0
        half = 512 if lng else 128
        r = np.zeros((ch, half), np.int64)
        m = rng.random((ch, half)) < 0.3
        r[m] = rng.integers(-2, 3, m.sum())
        fy = [(int(rng.integers(100, 200)), int(rng.integers(80, 200)))
              for _ in range(ch)]
        blocks.append((lng, fy, r))
    return spec.build(blocks)


def host_pcm(data) -> np.ndarray:
    """The host synthesis: imdct_many + Lapper in float64, int16 range."""
    syn = _host.vorbis_synthesis
    info, blocks = VD.capture_stream(data)
    lap = syn.Lapper(info.channels, info.blocksize[0])
    outs = [lap.add_block(syn.imdct_many(spec, n), n, pf, nf)
            for n, pf, nf, spec in blocks]
    pcm = np.concatenate(outs, axis=1)
    return np.clip(np.rint(pcm * 32768.0), -32768, 32767).astype(np.int32)


def _lsb(got, want) -> int:
    assert got.shape == want.shape
    return int(np.abs(got.astype(np.int64) - want).max())


def _host_gate(got, ref, lsb=2, db=60.0):
    assert got.dtype == np.int16
    assert _lsb(got, ref) <= lsb
    assert chip_smoke.snr_db(ref, got) >= db


def test_operators_equal_jax():
    from ohpipeline_tpu.codecs.vorbis import vorbis_jax as VJ

    np.testing.assert_array_equal(VD._operators(256, 1024),
                                  VJ._operators(256, 1024))
    ops = VD.device_operators(256, 1024, "cpu")
    assert ops.dtype == torch.float32 and ops.shape == (5, 512, 1024)
    assert VD.device_operators(256, 1024, "cpu") is ops


def test_group_step_matches_jax_group_fn():
    """One group of 2 streams of mixed blocks from a random carried lap
    tail (mid-stream state), against the JAX ``_group_fn``: the PCM <= 1
    LSB, the new carry within 1e-5 of its peak."""
    from ohpipeline_tpu.codecs.vorbis import vorbis_jax as VJ

    streams = [_make_stream(20 + i, nblocks=12) for i in range(2)]
    gens = [VD.capture_stream_iter(s)[1] for s in streams]
    G = 8
    wire = VD.next_group(gens, [None, None], 256, 1024, 2, G)
    Xq, scale, onehot, lo, shift = wire
    carry = (np.random.default_rng(6).standard_normal((2, 2, 512)) * 0.05) \
        .astype(np.float32)
    jpcm, jcarry = VJ._group_fn(2, G, 2, 256, 1024)(
        Xq, scale, onehot, lo.astype(np.int32), shift.astype(np.int32),
        carry)
    pcm, got_carry = VD.group_step(
        VD.device_operators(256, 1024, "cpu"),
        *(torch.from_numpy(a) for a in (Xq, scale)), onehot,
        *(torch.from_numpy(a) for a in (lo, shift, carry)))
    assert pcm.dtype == torch.int16
    assert _lsb(pcm.numpy(), np.asarray(jpcm)) <= 1
    jcarry = np.asarray(jcarry)
    assert np.abs(got_carry.numpy() - jcarry).max() \
        <= 1e-5 * np.abs(jcarry).max()
    assert (shift > 0).all() and np.abs(jcarry).max() > 0.01


def test_serving_matches_jax_serving():
    from ohpipeline_tpu.codecs.vorbis import vorbis_jax as VJ

    streams = [_make_stream(10 + i, nblocks=20 + 7 * i) for i in range(3)]
    got = VD.decode_vorbis_streams_device(streams, 16, device="cpu")
    want = VJ.decode_vorbis_streams_device(streams, 16)
    for g, w in zip(got, want):
        assert g.dtype == np.int16
        assert _lsb(g, w) <= 1


@pytest.mark.parametrize("mode,ch,coupling", [("mixed", 2, True),
                                              ("long", 1, False),
                                              ("short", 1, False)])
def test_matches_host_synthesis(mode, ch, coupling):
    data = _make_stream(1 if mode == "mixed" else 2,
                        nblocks=50 if mode == "mixed" else 30, mode=mode,
                        ch=ch, coupling=coupling)
    got = VD.decode_vorbis_stream_device(data, device="cpu")
    _host_gate(got, host_pcm(data))


def test_bench_content_matches_host_synthesis():
    data = chip_smoke.vorbis_stream(0, "bench", seconds=0.5)
    got = VD.decode_vorbis_stream_device(data, device="cpu")
    assert got.shape[1] > 0.45 * 44100
    _host_gate(got, host_pcm(data))


def test_group_carry_lapping():
    """Small groups force the carry path: within the host bounds, and near
    a one-group decode."""
    data = _make_stream(3, nblocks=37, mode="mixed")
    small = VD.decode_vorbis_stream_device(data, group=8, device="cpu")
    big = VD.decode_vorbis_stream_device(data, group=64, device="cpu")
    _host_gate(small, host_pcm(data))
    assert _lsb(small, big) <= 1


def test_multistream_batch_matches_single():
    streams = [_make_stream(10 + i, nblocks=20 + 7 * i, mode="mixed")
               for i in range(3)]
    batch = VD.decode_vorbis_streams_device(streams, group=16, device="cpu")
    for s, data in enumerate(streams):
        one = VD.decode_vorbis_stream_device(data, group=16, device="cpu")
        assert _lsb(batch[s], one) <= 1


def test_mismatched_batch_rejected():
    stereo = _make_stream(1, nblocks=4)
    mono = _make_stream(2, nblocks=4, coupling=False, ch=1)
    with pytest.raises(ValueError, match="uniform"):
        VD.decode_vorbis_streams_device([stereo, mono], device="cpu")


def test_native_residue_walk_is_taken(monkeypatch):
    def python_walk(*args, **kwargs):
        raise AssertionError("the Python residue walk was taken")

    monkeypatch.setattr(residue, "_decode_vectors", python_walk)
    data = _make_stream(4, nblocks=12)
    out = VD.decode_vorbis_stream_device(data, device="cpu")
    assert out.shape[0] == 2 and out.any()


def test_packet_decoder_raises_when_the_native_core_refuses(monkeypatch):
    monkeypatch.setattr(_host.native.VorbisNativeCtx, "ok",
                        property(lambda self: False))
    with pytest.raises(_host.vorbis_synthesis.VorbisError, match="native"):
        VD.capture_stream(_make_stream(5, nblocks=3))


def test_device_matches_host_real_file():
    """A real encoder's stream (libvorbis): the example asset of the pygame
    package, where it is installed (tests/test_vorbis_device.py's file)."""
    spec = importlib.util.find_spec("pygame")
    real = (pathlib.Path(spec.origin).parent / "examples" / "data"
            / "house_lo.ogg") if spec and spec.origin else None
    if real is None or not real.exists():
        pytest.skip("real ogg asset unavailable")
    data = real.read_bytes()
    out = VD.decode_vorbis_stream_device(data, device="cpu")
    # real spectra have a higher crest than the synthetic ones, so the
    # block-scaled int16 wire lands a few LSB off peaks (the JAX test's
    # bounds: 6 LSB, 70 dB)
    _host_gate(out, host_pcm(data), lsb=6, db=70.0)


@pytest.mark.gpu
def test_serving_card_matches_cpu(cuda):
    streams = [_make_stream(10 + i, nblocks=20 + 7 * i) for i in range(3)]
    got = VD.decode_vorbis_streams_device(streams, 16, device=cuda)
    want = VD.decode_vorbis_streams_device(streams, 16, device="cpu")
    for g, w in zip(got, want):
        assert _lsb(g, w) <= 1
