"""The port's CELT serving calls
(ohpipeline_tpu_torch.codecs.opus.celt.decode_celt_stream{,s}_device) against
the JAX package's ``decode_celt_streams_device`` and against the host
``celt.py`` decode, on streams rebuilt from ``tests/assets/dryrun.opus``
(CELT-only, 20 ms, stereo, 50 frames): stream s is the asset's header
packets, its audio packets from frame 3 s on, then all 50 packets k more
times, paged again with the port's ``build_pages``.

Tolerances, and why: <= 1 LSB against the JAX serving call (the same float32
program with matrix products summed in another order; 1 LSB measured); <= 2
LSB and >= 70 dB against the host float64 decode, the repo's own bound for
the device CELT path (``tests/test_opus_celt_device.py``; 2 LSB and 81.3 dB
measured).  The ``gpu`` test runs the call on the card against the CPU
(<= 1 LSB) and counts the comb kernel's launches."""

import pathlib

import numpy as np
import pytest
import torch

from ohpipeline_tpu_torch import _host, _kernels
from ohpipeline_tpu_torch.codecs.opus import celt as PC

DATA = (pathlib.Path(__file__).resolve().parent / "assets"
        / "dryrun.opus").read_bytes()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _packets(data=DATA):
    return list(_host.ogg.OggReader(_host.base.BufferReader(data)).packets())


def _stream(head, tags, audio, serial=1):
    ogg = _host.ogg
    return (ogg.build_pages(serial, [head], bos=True)
            + ogg.build_pages(serial, [tags], first_sequence=1)
            + ogg.build_pages(serial, audio, first_sequence=2,
                              granule=960 * len(audio), eos=True))


def celt_streams(S, repeats, retoc=None):
    """Stream s: the asset's header packets, its audio packets from frame
    3 s (mod 50) on, then all of them ``repeats`` more times; ``retoc``
    maps (s, TOC byte) to a new TOC byte."""
    head, tags, *audio = _packets()
    out = []
    for s in range(S):
        pk = audio[(3 * s) % len(audio):] + audio * repeats
        if retoc is not None:
            pk = [bytes([retoc(s, p[0])]) + p[1:] for p in pk]
        out.append(_stream(head, tags, pk, serial=s + 1))
    return out


def _host_decode(data: bytes) -> np.ndarray:
    """The host ``celt.py`` synthesis-path decode (no pre-skip or gain
    trim), the exact target of the device path."""
    st, outs = None, []
    for pk in _packets(data)[2:]:
        toc, frames = _host.split_packet_frames(pk)
        assert toc.mode == "celt"
        if st is None:
            st = _host.celt.CeltDecoderState(2 if toc.stereo else 1)
        for f in frames:
            outs.append(_host.celt.decode_frame(st, f, 960))
    pcm = np.concatenate(outs, axis=1) * 32768.0
    return np.clip(np.rint(pcm), -32768, 32767).astype(np.int16)


def _lsb(got, want):
    assert got.shape == want.shape and got.dtype == np.int16
    return int(np.abs(got.astype(np.int32) - want).max())


def test_rebuilt_streams_hold_the_asset():
    s0, s1 = celt_streams(2, 1)
    assert _packets(s0)[2:] == _packets()[2:] * 2
    assert _packets(s1)[2:] == _packets()[5:] + _packets()[2:]


def test_celt_serving_matches_jax_serving():
    from ohpipeline_tpu.codecs.opus import celt_jax as CJ

    streams = celt_streams(2, 1)                # 100 and 97 frames
    got = PC.decode_celt_streams_device(streams, 32, device="cpu")
    want = np.asarray(CJ.decode_celt_streams_device(streams, 32))
    assert got.shape == (2, 2, 97 * 960)
    assert _lsb(got, want) <= 1


def test_celt_serving_matches_host_decode():
    got = PC.decode_celt_streams_device([DATA], 32, device="cpu")[0]
    ref = _host_decode(DATA)
    assert got.shape == ref.shape == (2, 50 * 960)
    err = np.abs(got.astype(np.int32) - ref)
    sig = float(np.sqrt((ref.astype(np.float64) ** 2).mean()))
    rms = float(np.sqrt((err.astype(np.float64) ** 2).mean()))
    assert err.max() <= 2
    assert 20 * np.log10(sig / max(rms, 1e-9)) >= 70.0
    one = PC.decode_celt_stream_device(DATA, 16, device="cpu")
    assert _lsb(one, ref) <= 2


def test_celt_serving_raises_on_mixed_channel_counts():
    mono = celt_streams(2, 0, retoc=lambda s, t: t & ~0x04 if s else t)
    with pytest.raises(ValueError, match="channels"):
        PC.decode_celt_streams_device(mono, 32, device="cpu")


def test_celt_serving_raises_on_a_stream_that_is_not_celt():
    silk = celt_streams(1, 0, retoc=lambda s, t: (1 << 3) | (t & 0x07))
    with pytest.raises(ValueError, match="CELT-only"):
        PC.decode_celt_streams_device(silk, 32, device="cpu")


def test_native_celt_entropy_layer_is_taken(monkeypatch):
    def python_entropy(*args, **kwargs):
        raise AssertionError("the Python CELT entropy layer was taken")

    monkeypatch.setattr(_host.celt, "_entropy_decode_py", python_entropy)
    assert _host.native.have_celt_core()
    ch, caps = PC.capture_stream(DATA)
    assert ch == 2 and len(caps) == 50
    assert sum(c["is_transient"] for c in caps) == 1
    assert sum(c["pf"][1][1] > 0 for c in caps) == 48
    lags = [c["pf"][k][0] for c in caps for k in range(3)]
    assert min(lags) == 15 and max(lags) == 75


@pytest.mark.gpu
def test_celt_serving_card_matches_cpu(cuda):
    streams = celt_streams(4, 1)
    _kernels.reset_launches()
    got = PC.decode_celt_streams_device(streams, 32, device=cuda)
    assert _kernels.launches["celt_comb"] == 3     # 91 frames
    want = PC.decode_celt_streams_device(streams, 32, device="cpu")
    assert _lsb(got, want) <= 1
