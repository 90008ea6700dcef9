"""The port's SBR group decode (ohpipeline_tpu_torch.codecs.aac.sbr) against
the JAX package's ``sbr_jax`` on ``tests/assets/dryrun_he.aac`` (the only
HE-AAC content: the repo has no HE-AAC encoder) and on seeded worst cases
of the frame scan.

Tolerances, and why:
  - the frame scan (``envelope_scan_torch`` against the JAX ``frame_step``
    under ``lax.scan``) is elementwise float32 on both sides, with the
    one-hot products of the JAX program exact; only XLA's fusion of a
    multiply into an add can differ: 1e-6 of each channel's peak;
  - the scan's input planes: the slot -> envelope assignments, the
    regenerated noise and sine planes and the cond planes are equal; the
    HF-patched slots within 5e-4 of each channel's peak, because the
    transposer's LPC coefficients divide by a covariance determinant that
    cancels on tonal bands, so the float32 sum order of the covariances
    moves a band's patch by up to ~1e-3 of its level (measured 1.6e-4 of
    the peak and 8e-4 of the worst band on dryrun_he.aac; no coefficient
    changes branch at the |d| > 1e-9, p11 > 1e-9 or |a| >= 4 thresholds
    there); the gain, noise and sine levels, which divide by those
    patched energies, within 1e-3 of each element (measured 5.4e-4);
  - the group output within 2e-5 of each channel's peak (the QMF
    synthesis sums the bands, which averages the patch errors down), the
    carried state within 5e-4 (the 6-slot tail holds patched slots).
The ``gpu`` tests hold the ``csrc/sbr_env.cu`` kernel to the plain version
on the card (1e-5 of each channel's peak; the kernel repeats the plain
version's float operations, so it is expected to be exact)."""

import pathlib

import numpy as np
import pytest
import torch

from ohpipeline_tpu_torch import _kernels
from ohpipeline_tpu_torch._host import aac_sbr as SBR
from ohpipeline_tpu_torch._host import aac_bitstream, sbr_native
from ohpipeline_tpu_torch.codecs.aac import sbr as sbrd
from ohpipeline_tpu_torch.codecs.aac import synthesis as SYN
from ohpipeline_tpu_torch.codecs.aac.serving import (_sbr_frames, iter_groups,
                                                     to_device)

DATA = (pathlib.Path(__file__).resolve().parent / "assets"
        / "dryrun_he.aac").read_bytes()
NCH = 2
G = 16
SCAN_OUT = ("out_r", "out_i", "filt", "tail_r", "tail_i")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _peak_err(got, want):
    """Worst |got - want| / peak over the leading (channel) axis."""
    got, want = (np.asarray(a, np.float64).reshape(len(a), -1)
                 for a in (got, want))
    peak = np.maximum(np.abs(want).max(1), 1e-30)
    return float((np.abs(got - want).max(1) / peak).max())


def _real_groups(count):
    """The first ``count`` groups of dryrun_he.aac (one stereo stream, G
    frames each): [(core pcm (C, F, 1024) float32 tensor, cond numpy dict)]
    and the runner whose static config they share."""
    sbr_native()
    rate = aac_bitstream.parse_adts_header(DATA).sample_rate
    dec = SBR.SbrDecoder(rate)
    runner, out = None, []
    for planes, counts in iter_groups([DATA], G, sbr=True):
        per_ch = [([], [], []) for _ in range(NCH)]
        _sbr_frames(dec, 0, planes["sbr"][0], NCH, None, per_ch)
        if runner is None:
            runner = sbrd.SbrDeviceRunner(dec, NCH, device="cpu")
        consts = SYN.device_constants(planes["rate_index"], device="cpu")
        pcm, runner._core_ov = SYN.decode_planes(
            to_device(planes, "cpu"), runner._core_ov, consts)
        out.append((pcm.transpose(0, 1).contiguous(),
                    runner._build_stacked_cond(NCH, G, per_ch)))
        if len(out) == count:
            break
    return out, runner


def _jax_scan_capture(static, pcm, cond, state, monkeypatch):
    """Run the JAX device_decode_group on one channel with lax.scan
    recorded: returns (frame_step, init, xs, scan result)."""
    import jax
    import jax.numpy as jnp

    from ohpipeline_tpu.codecs.aac import sbr_jax

    seen = {}
    real = jax.lax.scan

    def record(f, init, xs):
        res = real(f, init, xs)
        seen.update(f=f, init=init, xs=xs, res=res)
        return res

    monkeypatch.setattr(jax.lax, "scan", record)
    sbr_jax.device_decode_group(
        static, jnp.asarray(pcm), {k: jnp.asarray(v) for k, v in cond.items()},
        {k: jnp.asarray(v) for k, v in state.items()})
    monkeypatch.setattr(jax.lax, "scan", real)
    return seen["f"], seen["init"], seen["xs"], seen["res"]


def _ids(onehot, axis=-1):
    """One-hot rows -> index, -1 for an all-zero row."""
    a = np.asarray(onehot)
    return np.where(a.sum(axis) > 0, a.argmax(axis), -1).astype(np.int8)


def _jax_xs_to_port(xs, init):
    """The JAX scan inputs and carry of one channel -> the port's scan
    arguments with a channel axis of 1."""
    (G_, N_, S_, B_, A, Ap, r, act, last, nre, nim, sre, sim, er, ei,
     cm) = (np.asarray(x) for x in xs)
    assert np.array_equal(act, (A.sum(-1) > 0).astype(np.float32))
    args = (G_, N_, S_, B_, _ids(A), _ids(Ap), _ids(last), r, cm, nre, nim,
            sre, sim, er, ei, *(np.asarray(c) for c in init))
    return [torch.from_numpy(np.array(a))[None] for a in args]


def _port_args_to_jax(args, c):
    """Channel c of the port's scan arguments -> (JAX xs, JAX carry)."""
    import jax.numpy as jnp

    a = [np.asarray(t[c]) for t in args]
    (G_, N_, S_, B_, eid, pid, last, r, cm, nre, nim, sre, sim, er, ei,
     filt, tr, ti) = a

    def onehot(idx, n):
        return (idx[..., None] == np.arange(n)).astype(np.float32)

    xs = (G_, N_, S_, B_, onehot(eid, sbrd.MAXE), onehot(pid, sbrd.MAXE + 1),
          r, (eid >= 0).astype(np.float32), onehot(last, sbrd.MAXE), nre, nim,
          sre, sim, er, ei, cm)
    return (tuple(jnp.asarray(x) for x in xs),
            tuple(jnp.asarray(x) for x in (filt, tr, ti)))


def worst_case(C=3, F=6, M=24, seed=8):
    """Scan arguments with every slot active, prev_id drawn from the
    frame's envelopes and the carry (MAXE), carry_mask on the first 8
    slots (6 carried, 2 zeroed), smoothing ratios in [0, 1), sine bins,
    sine and noise levels all on; CPU tensors."""
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))

    def i8(lo, hi, *shape):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int8))

    levels = [f32(C, F, 8, M).abs() for _ in range(3)]
    bins = torch.from_numpy((rng.random((C, F, 8, M)) < 0.3)
                            .astype(np.float32))
    r = torch.from_numpy(rng.random((C, F, 38)).astype(np.float32))
    cmask = torch.zeros((C, F, 38))
    cmask[:, :, :8] = 1.0
    planes = [f32(C, F, 38, M, scale=300.0) for _ in range(6)]
    return [*levels, bins, i8(0, 8, C, F, 38), i8(0, 9, C, F, 38),
            i8(-1, 8, C, F), r, cmask, *planes, f32(C, 2, M).abs(),
            f32(C, 6, M, scale=300.0), f32(C, 6, M, scale=300.0)]


def _jax_scan(f, xs, init):
    import jax

    (filt, tr, ti), (o_r, o_i) = jax.lax.scan(f, init, xs)
    return [np.asarray(x) for x in (o_r, o_i, filt, tr, ti)]


@pytest.fixture(scope="module")
def real():
    return _real_groups(3)


def test_envelope_scan_torch_matches_jax_frame_step_on_real_group(
        real, monkeypatch):
    (groups, runner) = real
    pcm, cond = groups[0]
    state = sbrd.device_init_state(runner.static.M)
    for c in range(NCH):
        f, init, xs, res = _jax_scan_capture(
            runner.static, pcm[c].numpy(), {k: v[c] for k, v in cond.items()},
            state, monkeypatch)
        got = sbrd.envelope_scan_torch(*_jax_xs_to_port(xs, init))
        (filt, tr, ti), (o_r, o_i) = res
        for name, g, w in zip(SCAN_OUT, got, (o_r, o_i, filt, tr, ti)):
            assert _peak_err(g, np.asarray(w)[None]) <= 1e-6, name


@pytest.mark.parametrize("M", [24, 40])
def test_envelope_scan_torch_matches_jax_frame_step_on_worst_case(
        real, monkeypatch, M):
    (groups, runner) = real
    pcm, cond = groups[0]
    f, *_ = _jax_scan_capture(
        runner.static, pcm[0].numpy(), {k: v[0] for k, v in cond.items()},
        sbrd.device_init_state(runner.static.M), monkeypatch)
    args = worst_case(M=M)
    got = sbrd.envelope_scan_torch(*args)
    for c in range(args[0].shape[0]):
        want = _jax_scan(f, *_port_args_to_jax(args, c))
        for name, g, w in zip(SCAN_OUT, got, want):
            assert _peak_err(g[c:c + 1], w[None]) <= 1e-6, name


def test_envelope_inputs_match_jax_scan_inputs(real, monkeypatch):
    """The port's envelope adjustment and regenerated noise and sine
    planes against the planes the JAX program feeds its scan."""
    (groups, runner) = real
    pcm, cond = groups[0]
    state = sbrd.device_init_state(runner.static.M)
    args, _, _ = sbrd.envelope_inputs(
        runner.static, pcm, sbrd.cond_to_device(cond, "cpu"),
        sbrd.state_to_device([state] * NCH, "cpu"))
    names = ("gain", "noise", "sine", "sine_bins", "env_id", "prev_id",
             "last_env", "r", "carry_mask", "nre", "nim", "sre", "sim", "er",
             "ei")
    for c in range(NCH):
        _f, init, xs, _res = _jax_scan_capture(
            runner.static, pcm[c].numpy(), {k: v[c] for k, v in cond.items()},
            state, monkeypatch)
        want = _jax_xs_to_port(xs, init)
        for name, g, w in zip(names, args, want):
            g = g[c:c + 1]
            if name in ("gain", "noise", "sine"):
                torch.testing.assert_close(g, w, rtol=1e-3, atol=0)
            elif name in ("er", "ei"):
                assert _peak_err(g, w) <= 5e-4, name
            else:
                assert torch.equal(g, w), name


def test_device_decode_group_matches_jax_over_chained_groups(real):
    """Three chained groups: every carried state (analysis history, slot
    history, LPC prehistory, tail, filt, synthesis overlap) crosses two
    group boundaries."""
    import jax.numpy as jnp

    from ohpipeline_tpu.codecs.aac import sbr_jax

    (groups, runner) = real
    static = runner.static
    fn = sbr_jax._group_fn(static)
    init = sbrd.device_init_state(static.M)
    jstates = [init] * NCH
    state = sbrd.state_to_device([init] * NCH, "cpu")
    for pcm, cond in groups:
        out, state = sbrd.device_decode_group(
            static, pcm, sbrd.cond_to_device(cond, "cpu"), state)
        for c in range(NCH):
            want, jstates[c] = fn(jnp.asarray(pcm[c].numpy()),
                                  {k: jnp.asarray(v[c])
                                   for k, v in cond.items()}, jstates[c])
            assert _peak_err(out[c:c + 1], np.asarray(want)[None]) <= 2e-5
            for key, val in jstates[c].items():
                assert _peak_err(state[key][c:c + 1],
                                 np.asarray(val)[None]) <= 5e-4, key


def test_synthesize_slots_matches_jax():
    import jax.numpy as jnp

    from ohpipeline_tpu.codecs.aac import sbr_jax

    _groups, runner = _real_groups(1)
    static = runner.static
    rng = np.random.default_rng(3)
    syn = np.zeros(704, np.float32)
    syn_t = torch.zeros((1, 704))
    for NS in (32, 8, 64):                   # chained, one run under 704
        Zr, Zi = (rng.standard_normal((NS, 64)).astype(np.float32) * 500
                  for _ in range(2))
        got, syn_t = sbrd.synthesize_slots(static, torch.from_numpy(Zr)[None],
                                           torch.from_numpy(Zi)[None], syn_t)
        want, syn = sbr_jax.synthesize_slots(static, jnp.asarray(Zr),
                                             jnp.asarray(Zi), syn)
        assert _peak_err(got, np.asarray(want)[None]) <= 2e-5
        assert _peak_err(syn_t, np.asarray(syn)[None]) <= 2e-5


def test_envelope_scan_needs_a_kernel_off_the_cpu():
    meta = [torch.empty(a.shape, dtype=a.dtype, device="meta")
            for a in worst_case(C=1, F=1)]
    with pytest.raises(ValueError, match="no kernel"):
        sbrd.envelope_scan(*meta)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        _kernels.sbr_env(*worst_case(C=1, F=1))


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["real", "worst", "wide"])
def test_sbr_env_kernel_matches_plain_on_card(which, cuda):
    """"wide" has 40 bins: two bin tiles of the kernel, the second with
    dead lanes."""
    if which == "real":
        (groups, runner) = _real_groups(1)
        pcm, cond = groups[0]
        state = sbrd.device_init_state(runner.static.M)
        args, _, _ = sbrd.envelope_inputs(
            runner.static, pcm.to(cuda), sbrd.cond_to_device(cond, cuda),
            sbrd.state_to_device([state] * NCH, cuda))
    else:
        M = 24 if which == "worst" else 40
        args = [a.to(cuda) for a in worst_case(C=32, F=48, M=M)]
    _kernels.reset_launches()
    got = sbrd.envelope_scan(*args)
    assert _kernels.launches["sbr_env"] == 1
    want = sbrd.envelope_scan_torch(*args)
    for name, g, w in zip(SCAN_OUT, got, want):
        assert g.device.type == "cuda"
        assert _peak_err(g.cpu(), w.cpu()) <= 1e-5, name
