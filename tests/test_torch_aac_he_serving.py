"""The port's HE-AAC v1 serving call
(ohpipeline_tpu_torch.codecs.aac.serving.decode_he_streams_device) against
the JAX package's and against ``sbr.py``'s numpy SbrDecoder chain, on
``tests/assets/dryrun_he.aac`` (22.05 kHz stereo core, 46 frames, an SBR
header every 10 frames), cut at header frames.

Tolerances, and why: <= 2 LSB against the JAX serving call (both run the
same float32 program, with matrix products and band sums in another order,
and the HF generator's LPC coefficients amplify that on tonal bands; 1 LSB
measured); against the numpy float64 chain fed the same core PCM, the
repo's own bound for the device SBR path (``tests/test_sbr_device.py``):
max error < 2e-3 of the peak and rms error < 5e-4 of the rms.  The ``gpu``
test runs the call on the card against the CPU (<= 2 LSB)."""

import pathlib

import numpy as np
import pytest
import torch

from ohpipeline_tpu_torch import _host, _kernels
from ohpipeline_tpu_torch.codecs.aac import sbr as sbrd
from ohpipeline_tpu_torch.codecs.aac.serving import decode_he_streams_device

DATA = (pathlib.Path(__file__).resolve().parent / "assets"
        / "dryrun_he.aac").read_bytes()
NCH = 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _offsets():
    offsets, pos = [], 0
    while pos < len(DATA):
        h = _host.aac_bitstream.parse_adts_header(DATA, pos)
        if h is None:
            break
        offsets.append(pos)
        pos += h.frame_bytes
    return offsets


def _ragged_streams():
    """Three streams of different lengths, each starting at an SBR header
    (frames 0, 10 and 20), two with whole copies of the asset appended."""
    off = _offsets()
    return [DATA[off[0]:], DATA[off[10]:] + DATA, DATA[off[20]:] + DATA * 2]


def _lsb(got, want):
    assert got.shape == want.shape and got.dtype == np.int32
    return int(np.abs(got.astype(np.int64) - want).max())


def test_he_serving_matches_jax_serving():
    from ohpipeline_tpu.codecs.aac.serving import (
        decode_he_streams_device as jax_serving)

    streams = _ragged_streams()
    outs = decode_he_streams_device(streams, frames_per_group=16,
                                    device="cpu")
    want = jax_serving(streams, frames_per_group=16)
    assert len(outs) == len(want) == 3
    assert [o.shape[1] for o in outs] == [46 * 2048, 82 * 2048, 118 * 2048]
    for got, w in zip(outs, want):
        assert _lsb(got, w) <= 2


def _joined():
    """Frames 20-29 of the asset, then frames 10-19: frame 29's envelopes
    end at the frame's end and frame 10's start one time slot into it, so
    the QMF slots between them belong to no envelope.  The host chain
    outputs them as the analysis left them (nothing patched above the
    crossover); an encoder tiles its frames' borders, so only a stream
    joined at a header frame, as a relay switching sources makes, has
    such slots."""
    off = _offsets()
    return DATA[off[20]:off[30]] + DATA[off[10]:off[20]]


def _against_numpy_sbr_chain(data: bytes, frames: int, monkeypatch):
    """The port's serving call on one stream, in groups of 16 frames,
    against SbrDecoder.process_frame fed the core PCM the port decoded."""
    seen = []
    group = sbrd.device_decode_group

    def record(static, pcm, cond, state):
        out, new_state = group(static, pcm, cond, state)
        seen.append((pcm.numpy().copy(), out.numpy().copy()))
        return out, new_state

    monkeypatch.setattr(sbrd, "device_decode_group", record)
    pcm16, = decode_he_streams_device([data], frames_per_group=16,
                                      device="cpu")
    core = np.concatenate([p for p, _ in seen], axis=1)     # (2, F, 1024)
    got = np.concatenate([o for _, o in seen], axis=1)
    n, _, b = _host.aac_native().aac_parse_group_sbr(
        data, 0, channels=NCH, max_frames=64)
    dec = _host.aac_sbr.SbrDecoder(
        _host.aac_bitstream.parse_adts_header(data).sample_rate)
    ref = []
    for f in range(n):
        payload, nbits, crc = b["sbr"][f]
        chans, coupling = dec.parse_payload(payload, nbits, stereo=True,
                                            crc=crc)
        ref.append(dec.process_frame(core[:, f].astype(np.float64), chans,
                                     coupling))
    ref = np.concatenate(ref, axis=1)
    assert n == frames and ref.shape == pcm16.shape
    err = got[:, :ref.shape[1]] - ref
    peak = max(np.abs(ref).max(), 1.0)
    assert np.abs(err).max() / peak < 2e-3
    assert np.sqrt((err ** 2).mean() / (ref ** 2).mean()) < 5e-4
    # the int16 output is that float output rounded and clipped
    np.testing.assert_array_equal(
        pcm16, np.clip(np.rint(got[:, :ref.shape[1]]), -32768,
                       32767).astype(np.int32))


def test_he_serving_matches_numpy_sbr_chain(monkeypatch):
    """Stream 0 (the whole asset, 3 groups of 16 frames)."""
    _against_numpy_sbr_chain(DATA, 46, monkeypatch)


def test_he_serving_matches_numpy_sbr_chain_across_a_join(monkeypatch):
    """Two segments of the asset joined with QMF slots between their
    envelopes (2 groups)."""
    _against_numpy_sbr_chain(_joined(), 20, monkeypatch)


def test_native_sbr_parse_is_taken(monkeypatch):
    """Every SBR payload of the asset goes through the native parser
    (sbr.py's ``from ... import native`` resolves under the port's private
    host package): with the Python bit parser made to fail, the whole
    stream still parses."""
    _host.sbr_native()
    assert _host.native.have_sbr_parse()

    def python_parser(*args, **kwargs):
        raise AssertionError("the Python SBR bit parser was taken")

    monkeypatch.setattr(_host.aac_sbr, "parse_sbr_data", python_parser)
    n, _, b = _host.aac_native().aac_parse_group_sbr(
        DATA, 0, channels=NCH, max_frames=64)
    dec = _host.aac_sbr.SbrDecoder(22050)
    for payload, nbits, crc in b["sbr"][:n]:
        chans, _ = dec.parse_payload(payload, nbits, stereo=True, crc=crc)
        assert len(chans) == NCH and chans[0].ps is None
    out, = decode_he_streams_device([DATA], frames_per_group=48,
                                    device="cpu")
    assert out.shape == (NCH, 46 * 2048) and out.any()


@pytest.mark.parametrize("start", [5, 13])
def test_he_serving_rejects_stream_before_header(start):
    off = _offsets()
    with pytest.raises(ValueError, match="SBR data before header"):
        decode_he_streams_device([DATA, DATA[off[start]:]], device="cpu")


def test_he_serving_rejects_non_adts():
    with pytest.raises(ValueError, match="not an ADTS"):
        decode_he_streams_device([DATA, b"\0" * 64], device="cpu")


@pytest.mark.gpu
def test_he_serving_on_card_matches_cpu(cuda):
    streams = _ragged_streams()
    _kernels.reset_launches()
    outs = decode_he_streams_device(streams, frames_per_group=16,
                                    device=cuda)
    assert _kernels.launches["sbr_env"] > 0 and _kernels.launches["tns"] > 0
    want = decode_he_streams_device(streams, frames_per_group=16,
                                    device="cpu")
    for got, w in zip(outs, want):
        assert _lsb(got, w) <= 2
