"""The port's CELT group synthesis (ohpipeline_tpu_torch.codecs.opus.celt)
against the JAX package's ``celt_jax``: the static tensors, the carry facts
the one-pass group program rests on, the comb post-filter's plain version
against ``_comb_device``, and ``device_decode_group`` on real groups of
``tests/assets/dryrun.opus`` (CELT-only, 20 ms, stereo, 50 frames: one
transient frame, 48 with an active post-filter, lags 15-75).

Tolerances, and why: the static tensors and the carry facts are exact.
``comb_torch`` is held to ``_comb_device`` within 1e-5 of each row's peak
(both run the same float32 taps; XLA may fuse a multiply-add where PyTorch
rounds each op; 8.1e-8 of the peak measured).  The group program is held
to <= 1 LSB of the JAX one (float32 matrix products summed in another
order; 1 LSB measured).  The ``gpu`` tests hold the ``csrc/celt_comb.cu``
kernel to ``comb_torch`` on the card bit for bit and the group program on
the card to the CPU (<= 1 LSB).

JAX is imported inside the tests that compare with it, so the ``gpu`` tests
run where JAX is absent."""

import pathlib

import numpy as np
import pytest
import torch

import chip_smoke
from ohpipeline_tpu_torch import _host, _kernels
from ohpipeline_tpu_torch.codecs.opus import celt as PC

DATA = (pathlib.Path(__file__).resolve().parent / "assets"
        / "dryrun.opus").read_bytes()
CH = 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def captures():
    ch, caps = PC.capture_stream(DATA)
    assert ch == CH and len(caps) == 50
    return caps


def _jax_group(X, gains, op, Tv, gt, state):
    from ohpipeline_tpu.codecs.opus import celt_jax as CJ

    pcm, (h, c, m) = CJ._group_fn(False)(X, gains, op, Tv, gt, *state)
    return np.asarray(pcm), tuple(np.asarray(a) for a in (h, c, m))


def _port_group(static, wire, state):
    X, gains, op, Tv, gt = wire
    dev = static.device
    t = [torch.from_numpy(a[None]).to(dev) for a in (X, gains, Tv, gt)]
    pcm, st = PC.device_decode_group(static, t[0], t[1], op[None], t[2],
                                     t[3], state)
    return pcm[0].cpu().numpy(), st


def _zero_jax_state():
    return (np.zeros((CH, PC.HLEN), np.float32),
            np.zeros((CH, 60), np.float32), np.zeros(CH, np.float32))


def test_static_tensors_equal_jax():
    from ohpipeline_tpu.codecs.opus import celt_jax as CJ

    js, ps = CJ._static(), PC.device_static("cpu")
    assert (ps.ov, ps.nb, ps.coef0) == (js.ov, js.nb, js.coef0)
    for name in ("S", "Cm", "band_expand", "deemph", "dpow", "win2"):
        want = np.asarray(getattr(js, name))
        got = getattr(ps, name)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_carry_facts():
    """Cm is zero past sample 960, so a frame's carried TDAC tail depends
    only on its own spectrum; dpow is exactly 0 in float32 from sample 640
    on, so a frame's last sample, and the deemphasis carry m, do not depend
    on the carry it received."""
    ps = PC.device_static("cpu")
    assert bool((ps.Cm[:, :, PC.N_FRAME:] == 0).all())
    assert bool((ps.dpow[640:] == 0).all()) and bool((ps.dpow[:640] > 0).all())


def test_m_is_coef0_times_last_sample_and_free_of_the_carry(captures):
    """The JAX frame scan's m after frame f is coef0 * pcm_f[-1]; the port
    computes every frame's m at once from its own product.  Two initial
    carries give the same PCM after frame 0 and the same final m."""
    ps = PC.device_static("cpu")
    wire = PC.pack_captures(captures[:8], CH)
    outs = []
    for m0 in (0.0, 5000.0):
        state = PC.init_state(1, CH, "cpu")
        state = (state[0], state[1], torch.full((1, CH), m0))
        outs.append(_port_group(ps, wire, state))
    (p0, s0), (p1, s1) = outs
    assert not np.array_equal(p0[0], p1[0])
    np.testing.assert_array_equal(p0[1:], p1[1:])
    assert torch.equal(s0[2], s1[2])
    # the final m against the JAX scan's coef0 * pcm[-1]
    _, (_, _, mj) = _jax_group(*wire, _zero_jax_state())
    np.testing.assert_allclose(s0[2][0].numpy(), mj, rtol=1e-5, atol=1e-3)


def _comb_case(seed=3, S=2, F=7):
    """Seeded rows and per-frame post-filter parameters covering lag 15 and
    1024, tapsets crossfading 0 -> 1 -> 2, zero gains (whole frames, and a
    filter switching on and off) and random lags in between."""
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((S * CH, PC.HLEN + F * PC.N_FRAME))
         * 3000).astype(np.float32)
    Tv = rng.integers(15, 1025, (S, F, 3)).astype(np.int32)
    gain = rng.uniform(0.1, 0.75, (S, F, 3))
    tap = rng.integers(0, 3, (S, F, 3))
    Tv[:, 0] = 15
    Tv[:, 1] = 1024
    Tv[:, 2] = (15, 1024, 15)
    tap[:, 3] = (0, 1, 2)
    gain[:, 4] = 0.0
    gain[:, 5, :2] = 0.0                 # off -> on
    gain[:, 6, 2] = 0.0                  # on -> off
    gt = (gain[..., None] * np.asarray(_host.celt.COMB_GAINS)[tap]) \
        .astype(np.float32)
    return y, Tv, gt


def _jax_comb_rows(y, Tv, gt):
    """_comb_device frame by frame, per stream, with the history carried."""
    import jax

    from ohpipeline_tpu.codecs.opus import celt_jax as CJ

    st = CJ._static()
    fn = jax.jit(lambda yy, T, g: CJ._comb_device(st, yy, T, g))
    S, F = Tv.shape[:2]
    N, H = PC.N_FRAME, PC.HLEN
    out = np.zeros((y.shape[0], F * N), np.float32)
    hist = np.zeros((y.shape[0], H), np.float32)
    for s in range(S):
        rows = slice(s * CH, (s + 1) * CH)
        h = y[rows, :H]
        for f in range(F):
            yy = np.concatenate([h, y[rows, H + f * N:H + (f + 1) * N]], 1)
            r = np.asarray(fn(yy, Tv[s, f], gt[s, f]))
            out[rows, f * N:(f + 1) * N] = r[:, H:]
            h = r[:, -H:]
        hist[rows] = h
    return out, hist


def test_comb_torch_matches_jax_comb():
    y, Tv, gt = _comb_case()
    win2 = PC.device_static("cpu").win2
    out, hist = PC.comb_torch(torch.from_numpy(y), torch.from_numpy(Tv),
                              torch.from_numpy(gt), win2)
    jout, jhist = _jax_comb_rows(y, Tv, gt)
    peak = np.abs(jout).max(axis=1)
    err = np.abs(out.numpy() - jout).max(axis=1)
    assert (err <= 1e-5 * peak).all(), err / peak
    np.testing.assert_array_equal(hist.numpy(), out.numpy()[:, -PC.HLEN:])
    np.testing.assert_allclose(hist.numpy(), jhist, rtol=0,
                               atol=1e-5 * float(peak.max()))
    # zero-gain frames pass through unchanged
    N, H = PC.N_FRAME, PC.HLEN
    np.testing.assert_array_equal(out.numpy()[:, 4 * N:5 * N],
                                  y[:, H + 4 * N:H + 5 * N])


def test_device_decode_group_matches_jax(captures):
    ps = PC.device_static("cpu")
    wire = PC.pack_captures(captures[:32], CH)
    assert wire[2][:, 1].any() and (wire[4] != 0).any()
    want, (hj, cj, mj) = _jax_group(*wire, _zero_jax_state())
    got, (h, c, m) = _port_group(ps, wire, PC.init_state(1, CH, "cpu"))
    assert got.shape == want.shape == (32, CH, PC.N_FRAME)
    assert got.dtype == np.int16
    assert int(np.abs(got.astype(np.int32) - want).max()) <= 1
    np.testing.assert_allclose(h[0].numpy(), hj, rtol=0, atol=2e-3)
    np.testing.assert_allclose(c[0].numpy(), cj, rtol=0, atol=2e-3)
    np.testing.assert_allclose(m[0].numpy(), mj, rtol=1e-5, atol=1e-3)


def test_groups_chain_through_state_from_jax(captures):
    """Split the stream at a group boundary in both packages: the JAX state
    after group 1, turned into the port's tensors, carries the port's
    group 2 to the JAX group 2."""
    ps = PC.device_static("cpu")
    w1 = PC.pack_captures(captures[:32], CH)
    w2 = PC.pack_captures(captures[32:], CH)
    _, jstate = _jax_group(*w1, _zero_jax_state())
    want, _ = _jax_group(*w2, jstate)
    got, _ = _port_group(ps, w2, PC.state_from_jax(*jstate, device="cpu"))
    assert got.shape == want.shape == (18, CH, PC.N_FRAME)
    assert int(np.abs(got.astype(np.int32) - want).max()) <= 1
    state = PC.state_from_jax(*jstate, device="cpu")
    assert [tuple(t.shape) for t in state] == [(1, CH, PC.HLEN), (1, CH, 60),
                                               (1, CH)]


def test_comb_dispatch_takes_the_plain_version_on_cpu(monkeypatch):
    def kernel(*args):
        raise AssertionError("the kernel was called for a CPU tensor")

    monkeypatch.setattr(_kernels, "celt_comb", kernel)
    y, Tv, gt = _comb_case(S=1)
    win2 = PC.device_static("cpu").win2
    got = PC.comb(*(torch.from_numpy(a) for a in (y, Tv, gt)), win2)
    want = PC.comb_torch(*(torch.from_numpy(a) for a in (y, Tv, gt)), win2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))



@pytest.mark.gpu
@pytest.mark.parametrize("case", ["mixed", "warp_edges"])
def test_comb_kernel_equals_plain_on_card(cuda, case):
    """"warp_edges": lags 33-35 and 66-67, runs either side of one and two
    warp widths (chip_smoke.py's celt_comb_lag_case)."""
    win2 = PC.device_static(cuda).win2
    if case == "mixed":
        args = [torch.from_numpy(a).to(cuda) for a in _comb_case(S=8, F=12)]
    else:
        args = chip_smoke.celt_comb_lag_case(cuda, S=8, F=12)
    before = _kernels.launches["celt_comb"]
    out, hist = PC.comb(*args, win2)
    want_out, want_hist = PC.comb_torch(*args, win2)
    torch.cuda.synchronize()
    assert _kernels.launches["celt_comb"] == before + 1
    assert torch.equal(out, want_out) and torch.equal(hist, want_hist)


@pytest.mark.gpu
def test_comb_kernel_checks_its_arguments(cuda):
    y, Tv, gt = (torch.from_numpy(a).to(cuda) for a in _comb_case())
    win2 = PC.device_static(cuda).win2
    with pytest.raises(ValueError):
        _kernels.celt_comb(y[:, 1:], Tv, gt, win2)
    with pytest.raises(ValueError):
        _kernels.celt_comb(y, Tv.float(), gt, win2)
    with pytest.raises(ValueError):
        _kernels.celt_comb(y.cpu(), Tv, gt, win2)


@pytest.mark.gpu
def test_device_decode_group_card_matches_cpu(cuda, captures):
    wire = PC.pack_captures(captures[:32], CH)
    want, _ = _port_group(PC.device_static("cpu"), wire,
                          PC.init_state(1, CH, "cpu"))
    got, (h, c, m) = _port_group(PC.device_static(cuda), wire,
                                 PC.init_state(1, CH, cuda))
    assert h.device.type == "cuda"
    assert int(np.abs(got.astype(np.int32) - want).max()) <= 1
