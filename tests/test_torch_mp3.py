"""The port's MP3 filterbank (ohpipeline_tpu_torch.codecs.mp3) against the JAX
package's: the numpy host prep, the native Huffman core against its Python
oracle, ``hybrid_synthesis_parallel{,_i16}`` against the JAX ones and
against the scan ``hybrid_synthesis``, the window pass's plain version
against the JAX window pass and against its formula, and ``decode_frames``
across groups.  Inputs are seeded: broadband spectra over every block type,
mixed blocks (the first two subbands long) and partial groups (``n_real``
< Tg), from non-zero states, and streams made with the port's encoder copy
(long, start, short and stop blocks; MPEG-1 and MPEG-2 LSF; LSF intensity
stereo).

Tolerances, and why: the host prep, the constants and the Huffman decode
are exact.  PCM is held to <= 1 LSB of the JAX programs at 16 bits (the
same float32 arithmetic, with matrix products and the 16-term window sum
taken in another order; 1 LSB measured; 24 bits: see
``test_hybrid_parallel_matches_jax``), and the carried state to 1e-5 of its
peak (float32 rounding of sums of 18-32 terms).  The ``gpu`` tests hold the
``csrc/mp3_window.cu`` kernel to ``mp3_window_torch`` on the card on
chip_smoke.py's worst case and on short and odd shapes (<= 1 LSB, the smoke
test's gate; the plain version sums in the kernel's order, so they should
agree bit for bit: ``window_run_model``, the kernel's walk of a run of
granules through its ring of V rows, is held bit for bit to it here) and
the whole filterbank on the card to the CPU (<= 1 LSB).

JAX is imported inside the tests that compare with it, so the ``gpu`` tests
run where JAX is absent."""

import numpy as np
import pytest
import torch

import chip_smoke
from ohpipeline_tpu_torch import _host, _kernels
from ohpipeline_tpu_torch.codecs import mp3 as PM
from ohpipeline_tpu_torch.codecs.mp3 import synthesis as PS

TG, B = 8, 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def synth_case(seed, n_real=TG, Tg=TG, B=B):
    """Broadband spectra (Tg, B, 576) zero past n_real, block types drawn
    per granule and channel from 0-3 with a quarter of the short ones mixed
    (subbands 0-1 long), and a non-zero (overlap, vfifo)."""
    rng = np.random.default_rng(seed)
    xr = rng.standard_normal((Tg, B, 576)) \
        * rng.uniform(0.002, 0.05, (Tg, B, 1))
    xr[n_real:] = 0.0
    bt = np.repeat(rng.integers(0, 4, (Tg, B, 1)), 32, axis=2)
    mixed = (bt[..., 0] == 2) & (rng.random((Tg, B)) < 0.25)
    bt[mixed, :2] = 0
    ov = rng.standard_normal((B, 576)) * 0.05
    vf = rng.standard_normal((B, 16, 64)) * 0.2
    return (xr.astype(np.float32), bt.astype(np.int32),
            ov.astype(np.float32), vf.astype(np.float32))


def _jax_consts():
    from ohpipeline_tpu.codecs.mp3 import synthesis as JS

    return (JS._imdct_operators().astype(np.float32),
            JS._polyphase_matrix().astype(np.float32),
            JS._window_matrix().astype(np.float32))


def _jax_parallel(case, n_real, bit_depth=16):
    from ohpipeline_tpu.codecs.mp3 import synthesis as JS

    pcm, ov, vf = JS.hybrid_synthesis_parallel(*case, *_jax_consts(), n_real,
                                               bit_depth)
    return np.asarray(pcm), np.asarray(ov), np.asarray(vf)


def _port_parallel(case, n_real, bit_depth=16):
    xr, bt, ov, vf = case
    state = PS.state_from_numpy(ov, vf, "cpu")
    pcm, ov2, vf2 = PS.hybrid_synthesis_parallel(
        torch.from_numpy(xr), torch.from_numpy(bt), *state, n_real,
        bit_depth)
    return pcm.numpy(), ov2.numpy(), vf2.numpy()


def _lsb(got, want) -> int:
    return int(np.abs(np.asarray(got, np.int64) - want).max())


def _state_close(got, want):
    peak = float(np.abs(want).max())
    assert np.abs(got - want).max() <= 1e-5 * peak, (
        np.abs(got - want).max(), peak)


def _frames(data):
    st, out = _host.mp3_bitstream.Mp3Stream(data), []
    while (fr := st.next_frame()) is not None:
        out.append(fr)
    return out


STREAMS = {
    "long": lambda: chip_smoke.mp3_bench_stream(0, seconds=0.4),
    "blocks": lambda: chip_smoke.mp3_block_stream(3, 14),
    "lsf": lambda: chip_smoke.mp3_block_stream(4, 14, lsf=True),
    "lsf_intensity": lambda: _lsf_intensity_stream(),
}


def _lsf_intensity_stream():
    """LSF intensity stereo with is-positions 0-2 (tests/test_mp3.py)."""
    isl = np.zeros(576, np.int32)
    for b, v in ((20, 10), (21, -8), (80, 7), (200, 5)):
        isl[b] = v
    ispos = [0, 1, 2, 0, 1, 2, 0] * 3
    return _host.mp3_encoder.build_stream(
        [isl, np.zeros(576, np.int32)], nframes=6, global_gain=180,
        version=2, sample_rate=22050, bitrate=128, intensity=True,
        scalefac_compress=172,
        scalefacs=[[0] * 39, ispos + [0] * (39 - len(ispos))])


def test_host_constants_equal_jax():
    from ohpipeline_tpu.codecs.mp3 import synthesis as JS

    prep = _host.mp3_prep
    for name in ("_imdct_operators", "_polyphase_matrix", "_window_matrix"):
        np.testing.assert_array_equal(getattr(prep, name)(),
                                      getattr(JS, name)(), err_msg=name)
    np.testing.assert_array_equal(prep.CS, JS.CS)
    np.testing.assert_array_equal(prep.CA, JS.CA)
    static = PS.device_static("cpu")
    ops = JS._imdct_operators().astype(np.float32)
    for k in range(4):
        np.testing.assert_array_equal(
            static.imdct[:, 36 * k:36 * (k + 1)].numpy(), ops[k])


@pytest.mark.parametrize("kind", sorted(STREAMS))
def test_prepare_granules_equals_jax(kind):
    from ohpipeline_tpu.codecs import mp3 as JM

    data = STREAMS[kind]()
    nch = _host.mp3_bitstream.parse_frame_header(data).channels
    jframes = _jax_frames(data)
    want = JM.prepare_granules(jframes, nch)
    got = PM.prepare_granules(_frames(data), nch)
    assert got[0].shape[0] == len(jframes) * (1 if "lsf" in kind else 2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    types = {"blocks": {0, 1, 2, 3}, "lsf": {0, 1, 2, 3}, "long": {0},
             "lsf_intensity": {0}}[kind]
    assert set(np.unique(got[1]).tolist()) == types


def test_native_huffman_matches_the_python_walk(monkeypatch):
    bs = _host.mp3_bitstream
    data = STREAMS["blocks"]() + STREAMS["long"]()
    native = [g.spectrum for fr in _frames(data)
              for gr in fr.side.granules for g in gr]
    monkeypatch.setattr(bs, "parse_huffman", bs.parse_huffman_py)
    walked = [g.spectrum for fr in _frames(data)
              for gr in fr.side.granules for g in gr]
    assert len(native) == len(walked) > 100
    for a, b in zip(native, walked):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,n_real,bit_depth",
                         [(0, TG, 16), (1, 5, 16), (2, 1, 16), (3, 6, 24)])
def test_hybrid_parallel_matches_jax(seed, n_real, bit_depth):
    """<= 1 LSB at 16 bits.  At 24 bits float32 carries a sample to ~1 LSB
    and the window sum's partial sums run past full scale, so two
    summation orders part by a few ulp of 2^-23: <= 4 LSB (2 measured)."""
    case = synth_case(seed, n_real)
    pcm, ov, vf = _port_parallel(case, n_real, bit_depth)
    jpcm, jov, jvf = _jax_parallel(case, n_real, bit_depth)
    assert pcm.dtype == np.int32 and pcm.shape == jpcm.shape == (TG, B, 576)
    assert _lsb(pcm, jpcm) <= (1 if bit_depth == 16 else 4)
    assert np.abs(jpcm).max() > 1000        # broadband, far from silence
    _state_close(ov, jov)
    _state_close(vf, jvf)


def test_hybrid_parallel_i16_matches_jax():
    from ohpipeline_tpu.codecs.mp3 import synthesis as JS

    rng = np.random.default_rng(7)
    xr, bt, ov, vf = synth_case(7, 6)
    q16 = rng.integers(-32767, 32768, xr.shape).astype(np.int16)
    q16[6:] = 0
    scl = rng.uniform(1e-7, 2e-6, xr.shape[:2]).astype(np.float32)
    bt8 = bt.astype(np.uint8)
    pcm, ov2, vf2 = PS.hybrid_synthesis_parallel_i16(
        *(torch.from_numpy(a) for a in (q16, scl, bt8)),
        *PS.state_from_numpy(ov, vf, "cpu"), 6)
    jpcm, jov, jvf = JS.hybrid_synthesis_parallel_i16(
        q16, scl, bt8, ov, vf, *_jax_consts(), 6)
    assert _lsb(pcm.numpy(), np.asarray(jpcm)) <= 1
    _state_close(ov2.numpy(), np.asarray(jov))
    _state_close(vf2.numpy(), np.asarray(jvf))


@pytest.mark.parametrize("n_real", [TG, 5])
def test_hybrid_parallel_matches_the_jax_scan(n_real):
    from ohpipeline_tpu.codecs.mp3 import synthesis as JS

    case = synth_case(11, n_real)
    pcm, ov, vf = _port_parallel(case, n_real)
    xr, bt, ov0, vf0 = case
    spcm, sov, svf = JS.hybrid_synthesis(xr[:n_real], bt[:n_real], ov0, vf0,
                                         *_jax_consts())
    want = np.clip(np.rint(np.asarray(spcm) * 32768.0), -32768, 32767)
    assert _lsb(pcm[:n_real], want) <= 1
    _state_close(ov, np.asarray(sov))
    _state_close(vf, np.asarray(svf))


def _window_formula(vfull, wnd, bit_depth):
    """The window pass written out from its definition, in float64 ->
    ((Tg, B, 576) PCM, the sum of |products| of each sample in LSB)."""
    T, Bc = vfull.shape[0] - 15, vfull.shape[1]
    v = vfull.astype(np.float64)
    out, mag = np.zeros((T, Bc, 32)), np.zeros((T, Bc, 32))
    for m in range(8):
        for p in (wnd[2 * m] * v[15 - 2 * m:15 - 2 * m + T, :, :32],
                  wnd[2 * m + 1] * v[14 - 2 * m:14 - 2 * m + T, :, 32:]):
            out += p
            mag += np.abs(p)
    lim = 1 << (bit_depth - 1)
    out = np.clip(np.rint(out * lim), -lim, lim - 1)

    def lay(a):
        return a.reshape(T // 18, 18, Bc, 32).transpose(0, 2, 1, 3) \
            .reshape(T // 18, Bc, 576)
    return lay(out), lay(mag * lim)


@pytest.mark.parametrize("bit_depth", [16, 24])
def test_mp3_window_torch_matches_its_formula(bit_depth):
    """Against float64, within 1 LSB plus float32's rounding of a 16-term
    sum: 16 ulp (2^-24 each) of the sum of |products| (the samples here
    reach 3x full scale, so that is up to 3 LSB at 24 bits)."""
    vfull = chip_smoke.mp3_window_case("cpu", Tg=6, B=5, n_real=4)
    wnd = PS.device_static("cpu").wnd
    got = PS.mp3_window_torch(vfull, wnd, bit_depth)
    want, mag = _window_formula(vfull.numpy(),
                                wnd.numpy().astype(np.float64), bit_depth)
    assert got.dtype == torch.int32 and got.shape == (6, 5, 576)
    err = np.abs(got.numpy() - want)
    assert (err <= 1 + 16 * 2.0 ** -24 * mag).all()
    if bit_depth == 16:
        assert err.max() <= 1
    lim = 1 << (bit_depth - 1)
    assert (want == lim - 1).any() and (want == -lim).any()   # both clips


def test_mp3_window_torch_matches_the_jax_window_pass():
    """The JAX program with an IMDCT that passes the spectrum through
    (operators [I | 0] for every block type, no overlap) runs its window
    pass on V = S @ poly behind a random 64-lane V history; the port's
    plain version gets the same vfull from the port's matrixing."""
    from ohpipeline_tpu.codecs.mp3 import synthesis as JS

    rng = np.random.default_rng(5)
    S = (rng.standard_normal((TG, B, 32, 18)) * 0.1).astype(np.float32)
    vf = (rng.standard_normal((B, 16, 64)) * 0.3).astype(np.float32)
    bt = rng.integers(0, 4, (TG, B, 32)).astype(np.int32)
    ident = np.zeros((4, 18, 36), np.float32)
    ident[:, np.arange(18), np.arange(18)] = 1.0
    _, poly, wnd = _jax_consts()
    want = np.asarray(JS.hybrid_synthesis_parallel(
        S.reshape(TG, B, 576), bt, np.zeros((B, 576), np.float32), vf,
        ident, poly, wnd, TG)[0])
    static = PS.device_static("cpu")
    vfull = PS.matrixing(static, torch.from_numpy(S) * static.inv,
                         torch.from_numpy(vf))
    got = PS.mp3_window_torch(vfull, static.wnd)
    assert _lsb(got.numpy(), want) <= 1
    assert np.abs(want).max() > 1000


def window_run_model(vfull, wnd, bit_depth):
    """csrc/mp3_window.cu's walk in numpy float32: one block per (run of
    MP3_RUN granules, channel) holds a ring of MP3_RING V rows
    (row r at r mod MP3_RING); it loads the run's 15 history rows with its
    first granule's 18, then each granule's 18 new rows (the run's rows
    must not overwrite each other in the ring), and sums slot s of granule
    g from the ring in j order."""
    vfull, wnd = np.asarray(vfull, np.float32), np.asarray(wnd, np.float32)
    T, Bc = vfull.shape[0] - 15, vfull.shape[1]
    Tg, R, RING = T // 18, _kernels.MP3_RUN, _kernels.MP3_RING
    out = np.zeros((Tg, Bc, 576), np.int64)
    lim = 1 << (bit_depth - 1)
    s = np.arange(18)                             # slots of a granule
    for g0 in range(0, Tg, R):
        n = min(R, Tg - g0)
        for ch in range(Bc):
            ring = np.full((RING, 64), np.nan, np.float32)

            def load(lo, hi):
                for r in range(lo, hi):
                    ring[r % RING] = vfull[r, ch]
            load(18 * g0, 18 * g0 + 33)
            for g in range(g0 + 1, g0 + n):
                load(18 * g + 15, 18 * g + 33)
            for g in range(g0, g0 + n):
                r0 = 18 * g + 15 + s
                acc = np.zeros((18, 32), np.float32)
                for m in range(8):
                    acc = acc + wnd[2 * m] * ring[(r0 - 2 * m) % RING, :32]
                    acc = acc + wnd[2 * m + 1] \
                        * ring[(r0 - 1 - 2 * m) % RING, 32:]
                pcm = np.clip(np.rint(acc * np.float32(lim)), -lim, lim - 1)
                out[g, ch] = pcm.reshape(576)
    return out


@pytest.mark.parametrize("Tg", [1, _kernels.MP3_RUN - 1, _kernels.MP3_RUN,
                                _kernels.MP3_RUN + 1, 64])
@pytest.mark.parametrize("bit_depth", [16, 24])
def test_window_run_model_equals_plain(Tg, bit_depth):
    """Bit for bit: the kernel sums in the plain version's order.  Tg not a
    multiple of the run leaves the last run short; 64 granules wrap the
    ring."""
    vfull = chip_smoke.mp3_window_case("cpu", Tg=Tg, B=3,
                                       n_real=max(Tg - 1, 1))
    wnd = PS.device_static("cpu").wnd
    want = PS.mp3_window_torch(vfull, wnd, bit_depth).numpy()
    assert np.array_equal(window_run_model(vfull.numpy(), wnd.numpy(),
                                           bit_depth), want)
    if Tg == 64:
        lim = 1 << (bit_depth - 1)
        assert (want == lim - 1).any() and (want == -lim).any()


def _jax_frames(data):
    from ohpipeline_tpu.codecs.mp3 import bitstream as JB

    st, out = JB.Mp3Stream(data), []
    while (fr := st.next_frame()) is not None:
        out.append(fr)
    return out


def test_decode_frames_matches_jax_across_groups():
    from ohpipeline_tpu.codecs import mp3 as JM

    data = chip_smoke.mp3_block_stream(9, 30)
    frames, jframes = _frames(data), _jax_frames(data)
    state, jstate = PM.StreamState(2, device="cpu"), JM._StreamState(2)
    for a, b in ((0, 12), (12, 24), (24, 30)):
        got = PM.decode_frames(frames[a:b], state, 2)
        want = JM.decode_frames(jframes[a:b], jstate, 2)
        assert got.shape == want.shape == (2, (b - a) * 1152)
        assert _lsb(got, want) <= 1
    _state_close(state.overlap.numpy(), np.asarray(jstate.overlap))
    _state_close(state.vfifo.numpy(), np.asarray(jstate.vfifo))
    assert PM.decode_frames([], state, 2).shape == (2, 0)


def test_the_kernel_wrapper_refuses_cpu_tensors():
    vfull = torch.zeros((15 + 18, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.mp3_window(vfull, torch.zeros((16, 32)))


def test_n_real_outside_the_group_raises():
    case = synth_case(0)
    with pytest.raises(ValueError, match="n_real"):
        _port_parallel(case, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("Tg,Bc", [(64, 33), (1, 1), (1, 33),
                                   (_kernels.MP3_RUN + 1, 1),
                                   (_kernels.MP3_RUN + 1, 33), (64, 1)])
@pytest.mark.parametrize("bit_depth", [16, 24])
def test_mp3_window_kernel_matches_plain_on_the_card(cuda, bit_depth, Tg,
                                                     Bc):
    vfull = chip_smoke.mp3_window_case(cuda, Tg=Tg, B=Bc)
    wnd = PS.device_static(cuda).wnd
    _kernels.reset_launches()
    got = _kernels.mp3_window(vfull, wnd, bit_depth)
    assert _kernels.launches["mp3_window"] == 1
    want = PS.mp3_window_torch(vfull, wnd, bit_depth)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (Tg, Bc, 576)
    assert int((got.long() - want.long()).abs().max()) <= 1
    if (Tg, Bc) == (64, 33):
        lim = 1 << (bit_depth - 1)
        assert bool((want == lim - 1).any()) and bool((want == -lim).any())


@pytest.mark.gpu
@pytest.mark.parametrize("seed,n_real", [(0, TG), (1, 5)])
def test_hybrid_parallel_card_matches_cpu(cuda, seed, n_real):
    case = synth_case(seed, n_real, B=7)
    want = _port_parallel(case, n_real)
    xr, bt, ov, vf = case
    got = PS.hybrid_synthesis_parallel(
        torch.from_numpy(xr).to(cuda), torch.from_numpy(bt).to(cuda),
        *PS.state_from_numpy(ov, vf, cuda), n_real)
    assert _lsb(got[0].cpu().numpy(), want[0]) <= 1
    _state_close(got[1].cpu().numpy(), want[1])
    _state_close(got[2].cpu().numpy(), want[2])
