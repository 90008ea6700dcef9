"""The port's AAC-LC hooks (ohpipeline_tpu_torch.codecs.aac) and serving
API (codecs.aac.serving.decode_aac_streams_device) against the JAX
package's on ``tests/assets/dryrun.aac``: <= 1 LSB against the JAX device
paths (matrix sums run in another order), <= 2 LSB against the JAX host
decode ``decode_adts`` outside PNS frames, whose noise both packages seed
differently from the host path and which are held by energy.  The ``gpu``
test runs the serving call on the card against the CPU."""

import pathlib

import numpy as np
import pytest
import torch

from ohpipeline_tpu_torch import _kernels
from ohpipeline_tpu_torch._host import aac_bitstream, aac_native
from ohpipeline_tpu_torch.codecs import aac
from ohpipeline_tpu_torch.codecs.aac.serving import (
    decode_aac_streams_device)

DATA = (pathlib.Path(__file__).resolve().parent / "assets"
        / "dryrun.aac").read_bytes()
NCH = 2
PNS_FRAMES = (87, 88)        # dryrun.aac's frames with noise-substituted bands


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _jaac():
    from ohpipeline_tpu.codecs import aac as jaac
    return jaac


def _lsb(got, want):
    assert got.shape == want.shape and got.dtype == np.int32
    return int(np.abs(got.astype(np.int64) - want).max())


def _cut_streams():
    """dryrun.aac cut after frames 6, 9 and 12, plus the whole file."""
    cuts, pos, k = [], 0, 0
    while pos < len(DATA):
        h = aac_bitstream.parse_adts_header(DATA, pos)
        if h is None:
            break
        pos += h.frame_bytes
        k += 1
        if k in (6, 9, 12):
            cuts.append(pos)
    return [DATA[:c] for c in cuts] + [DATA]


def _groups(G, count):
    pos, out = 0, []
    for _ in range(count):
        n, pos, b = aac_native().aac_parse_group(
            DATA, pos, channels=NCH, max_frames=G)
        out.append((n, {k: (v.copy() if isinstance(v, np.ndarray) else v)
                        for k, v in b.items()}))
    return out


def test_decode_group_arrays_carries_state_across_groups():
    jaac = _jaac()
    st, jst = aac._StreamState(NCH), jaac._StreamState(NCH)
    for n, b in _groups(16, 3):
        got = aac.decode_group_arrays(b, n, NCH, st, device="cpu")
        want = jaac.decode_group_arrays(b, n, NCH, jst)
        assert _lsb(got, want) <= 1
        np.testing.assert_array_equal(st.prev_shape, jst.prev_shape)
        np.testing.assert_allclose(st.overlap, jst.overlap, atol=0.05,
                                   rtol=0)


@pytest.mark.parametrize("start", [0, 2])
def test_decode_group_device_matches_jax(start):
    """Group 0 has TNS and short rows; group 2 (frames 64-88) the PNS
    frames; both ride the side plane."""
    jaac = _jaac()
    n, b = _groups(32, start + 1)[start]
    st, jst = aac._StreamState(NCH), jaac._StreamState(NCH)
    got = aac.decode_group_device(b, n, NCH, st, device="cpu")
    want = jaac.decode_group_device(b, n, NCH, jst)
    assert got is not None and want is not None
    assert _lsb(got, want) <= 1
    np.testing.assert_array_equal(st.prev_shape, jst.prev_shape)
    np.testing.assert_allclose(st.overlap, jst.overlap, atol=0.05, rtol=0)
    prep = aac.prepare_device_group(b, n, NCH, np.zeros(NCH, np.int32))
    jprep = jaac.prepare_device_group(b, n, NCH, np.zeros(NCH, np.int32))
    for key, val in jprep.items():
        if key == "cfg_map":
            assert prep[key] == val
        else:
            np.testing.assert_array_equal(prep[key], val)
    for got_t, want_t in zip(aac.cfg_tables(prep["cfg_map"]),
                             jaac.cfg_tables(jprep["cfg_map"])):
        np.testing.assert_array_equal(got_t, want_t)


def _mono_batch():
    return dict(rate_index=4, ics=np.zeros((4, 4), np.int32),
                cb=np.zeros((4, 128), np.int8),
                sf=np.zeros((4, 128), np.int32),
                quant=np.zeros((4, 1024), np.int32),
                msmask=np.zeros((4, 128), np.uint8),
                tnsn=np.zeros((4, 8), np.int32),
                tnsp=np.zeros((4, 24, 3), np.int32),
                tnsc=np.zeros((4, 24, 12), np.float32))


def _many_special_batch():
    """dryrun's first 32 frames with an order-0 TNS filter flagged on
    every row of 10 frames: 20 special rows, more than MAX_SIDE."""
    n, b = _groups(32, 1)[0]
    b["tnsn"][:20, 0] = 1
    return n, b


@pytest.mark.parametrize("which", ["mono", "many_special"])
def test_decode_group_device_none_where_jax_none(which):
    jaac = _jaac()
    if which == "mono":
        n, ch, b = 4, 1, _mono_batch()
    else:
        (n, b), ch = _many_special_batch(), NCH
    st, jst = aac._StreamState(ch), jaac._StreamState(ch)
    assert jaac.decode_group_device(b, n, ch, jst) is None
    assert aac.decode_group_device(b, n, ch, st, device="cpu") is None
    np.testing.assert_array_equal(st.prev_shape, jst.prev_shape)


def test_serving_matches_jax_serving():
    from ohpipeline_tpu.codecs.aac.serving import (
        decode_aac_streams_device as jax_serving)

    streams = _cut_streams()
    outs = decode_aac_streams_device(streams, frames_per_group=4,
                                     device="cpu")
    want = jax_serving(streams, frames_per_group=4)
    assert len(outs) == len(want) == 4
    for got, w in zip(outs, want):
        assert _lsb(got, w) <= 1


def test_serving_matches_host_decode():
    info, ref = _jaac().decode_adts(DATA)
    out, = decode_aac_streams_device([DATA], frames_per_group=64,
                                     device="cpu")
    assert out.shape == ref.shape and info.num_channels == NCH
    frames = np.arange(out.shape[1]) // 1024
    pns = np.isin(frames, PNS_FRAMES)
    assert pns.any() and not pns.all()
    assert _lsb(out[:, ~pns], ref[:, ~pns]) <= 2
    # PNS noise is energy-normalised per band; its samples differ
    e_got = np.sqrt((out[:, pns].astype(np.float64) ** 2).mean())
    e_ref = np.sqrt((ref[:, pns].astype(np.float64) ** 2).mean())
    assert abs(e_got - e_ref) <= 0.25 * e_ref


def test_serving_rejects_non_adts():
    with pytest.raises(ValueError, match="not an ADTS"):
        decode_aac_streams_device([DATA, b"\0" * 64], device="cpu")


@pytest.mark.gpu
def test_serving_on_card_matches_cpu(cuda):
    streams = _cut_streams()
    _kernels.reset_launches()
    outs = decode_aac_streams_device(streams, frames_per_group=16,
                                     device=cuda)
    assert _kernels.launches["tns"] > 0
    want = decode_aac_streams_device(streams, frames_per_group=16,
                                     device="cpu")
    for got, w in zip(outs, want):
        assert _lsb(got, w) <= 1
