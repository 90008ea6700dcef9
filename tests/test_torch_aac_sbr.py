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
The kernel ``csrc/sbr_env.cu`` runs the scan as a map over (channel, frame,
slot, bin): ``sbr_map_model`` is its float32 model (filt by selection,
carried slots recomputed from the previous frame), held bit for bit to
``envelope_scan_torch`` here; the ``gpu`` tests hold the kernel bit for bit
to its plain version (``noise_sine_planes``, then ``envelope_scan_torch``)
on the card."""

import pathlib

import numpy as np
import pytest
import torch

import chip_smoke
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


def worst_case(C=3, F=6, M=24):
    """chip_smoke.py's worst case (every slot active, prev_id drawn from the
    frame's envelopes and the carry, carried slots, sine and noise on) in
    the plane form envelope_scan_torch takes; CPU tensors."""
    return sbrd.plane_args(*chip_smoke.sbr_env_case("cpu", C=C, F=F, M=M))


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
    args = sbrd.plane_args(*args)
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



def _real_compact(real, g):
    """The compact scan arguments of real group g (from the initial
    state: the scan's own carries are what the cases vary)."""
    (groups, runner) = real
    pcm, cond = groups[g]
    state = sbrd.device_init_state(runner.static.M)
    args, _, _ = sbrd.envelope_inputs(
        runner.static, pcm, sbrd.cond_to_device(cond, "cpu"),
        sbrd.state_to_device([state] * NCH, "cpu"))
    return args


@pytest.mark.parametrize("g", range(3))
def test_noise_sine_planes_match_jax(real, monkeypatch, g):
    """The noise and sine planes regenerated from the counter seeds equal
    the planes the JAX program feeds its scan, bit for bit."""
    (groups, runner) = real
    pcm, cond = groups[g]
    state = sbrd.device_init_state(runner.static.M)
    args = _real_compact(real, g)
    sine_bins, env_id, counters = args[3], args[4], args[9:17]
    got = sbrd.noise_sine_planes(env_id, sine_bins, *counters)
    for c in range(NCH):
        _f, init, xs, _res = _jax_scan_capture(
            runner.static, pcm[c].numpy(), {k: v[c] for k, v in cond.items()},
            state, monkeypatch)
        want = _jax_xs_to_port(xs, init)[9:13]
        for name, g_, w in zip(("nre", "nim", "sre", "sim"), got, want):
            assert torch.equal(g_[c:c + 1], w), name


def sbr_map_model(gain, noise, sine, sine_bins, env_id, prev_id, last_env, r,
                  carry_mask, nre, nim, sre, sim, er, ei, filt, tail_r,
                  tail_i):
    """float32 model of csrc/sbr_env.cu's decomposition of the frame scan
    (arguments and results of envelope_scan_torch), every frame at once:
    the filt each frame starts from is selected, not carried (the gain and
    noise of the last envelope of the latest earlier frame that has one, by
    a cummax over frame numbers, or the input filt); every slot is adjusted
    once with its carried input zeroed, which gives each frame's slots
    32-37 as they are; then the carried slots s < 6 of frame f take frame f
    - 1's slot 32 + s (the input tail at frame 0), and every slot is
    adjusted again from its true input."""
    C, F, _, M = gain.shape
    ch = torch.arange(C)[:, None]

    def selected(src):
        """(C, K) frame numbers (-1 = none) -> the filt they leave, (C, K,
        2, M)."""
        at = src.clamp_min(0)
        le = last_env.long()[ch, at].clamp_min(0)
        rows = torch.stack([gain[ch, at, le], noise[ch, at, le]], 2)
        return torch.where((src >= 0)[..., None, None], rows,
                           filt[:, None])

    seen = torch.where(last_env >= 0, torch.arange(F), -1).cummax(1).values
    fsel = selected(torch.cat([torch.full((C, 1), -1), seen[:, :-1]], 1))

    def gather(planes, idx):
        rows = torch.gather(planes, 2, idx.clamp_min(0)[..., None]
                            .expand(-1, -1, -1, M))
        return torch.where((idx >= 0)[..., None], rows, 0.0)

    e, p = env_id.long(), prev_id.long()
    Gprev = gather(torch.cat([gain, fsel[:, :, :1]], 2), p)
    Nprev = gather(torch.cat([noise, fsel[:, :, 1:]], 2), p)
    rf = r[..., None]
    g_sl = rf * Gprev + (1 - rf) * gather(gain, e)
    n_sl = rf * Nprev + (1 - rf) * gather(noise, e)
    s_sl, sine_mask = gather(sine, e), gather(sine_bins, e)
    act = (e >= 0)[..., None]
    cm = carry_mask[..., None] > 0

    def adjust(x_r, x_i):
        o_r = x_r * g_sl + nre * n_sl * (1 - sine_mask) + sre * s_sl
        o_i = x_i * g_sl + nim * n_sl * (1 - sine_mask) + sim * s_sl
        return torch.where(act, o_r, x_r), torch.where(act, o_i, x_i)

    y0r, y0i = adjust(torch.where(cm, 0.0, er), torch.where(cm, 0.0, ei))
    pad = er.new_zeros((C, F, sbrd.NSL - tail_r.shape[1], M))
    tr = torch.cat([tail_r[:, None], y0r[:, :-1, sbrd.NOUT:]], 1)
    ti = torch.cat([tail_i[:, None], y0i[:, :-1, sbrd.NOUT:]], 1)
    yr, yi = adjust(torch.where(cm, torch.cat([tr, pad], 2), er),
                    torch.where(cm, torch.cat([ti, pad], 2), ei))
    filt_out = selected(seen[:, -1:])[:, 0]
    return (yr[:, :, :sbrd.NOUT], yi[:, :, :sbrd.NOUT], filt_out,
            yr[:, -1, sbrd.NOUT:], yi[:, -1, sbrd.NOUT:])


MAP_CASES = ["real0", "real1", "real2", "worst", "wide", "stale_filt",
             "carry_high"]


def _map_case(real, case):
    """Compact scan arguments: a real group of dryrun_he.aac, or one of
    chip_smoke.py's seeded cases (the worst case at 24 and 40 bins, a
    carried filt from far back, carried and inactive slots everywhere) at
    a few channels and frames."""
    if case.startswith("real"):
        return _real_compact(real, int(case[4:]))
    kind = {"wide": "worst"}.get(case, case)
    return chip_smoke.sbr_env_case("cpu", kind, C=3, F=48,
                                      M=40 if case == "wide" else 24)


@pytest.mark.parametrize("case", MAP_CASES)
def test_sbr_map_model_equals_scan(real, case):
    """The kernel's decomposition (a map with depth one) is the frame scan,
    bit for bit, in all five outputs."""
    args = sbrd.plane_args(*_map_case(real, case))
    want = sbrd.envelope_scan_torch(*args)
    got = sbr_map_model(*args)
    for name, g, w in zip(SCAN_OUT, got, want):
        assert g.shape == w.shape and torch.equal(g, w), name


def test_sbr_cases_reach_what_they_name(real):
    """stale_filt smooths against a filt left many frames back (or the
    input's, in channel 0); carry_high carries into slots >= 32 and leaves
    slots inactive, some of them carried."""
    (gain, _, _, _, env_id, prev_id, last_env, _, cm, *_rest) = \
        _map_case(real, "stale_filt")
    assert bool((last_env[0] < 0).all())
    seen = torch.where(last_env >= 0, torch.arange(last_env.shape[1]), -1)
    gap = torch.arange(last_env.shape[1]) - seen.cummax(1).values
    assert int(gap.max()) >= 10 and float((prev_id == 8).float().mean()) > .7
    (_, _, _, _, env_id, _, _, _, cm, *_rest) = _map_case(real, "carry_high")
    assert bool((cm[..., 32:] > 0).any())
    assert bool(((env_id < 0) & (cm > 0)).any())


def test_envelope_scan_needs_a_kernel_off_the_cpu():
    args = chip_smoke.sbr_env_case("cpu", C=1, F=1)
    meta = [torch.empty(a.shape, dtype=a.dtype, device="meta")
            if isinstance(a, torch.Tensor) else a for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        sbrd.envelope_scan(*meta)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        _kernels.sbr_env(*args)


def test_envelope_scan_on_cpu_is_planes_then_scan():
    args = chip_smoke.sbr_env_case("cpu", C=2, F=5)
    got = sbrd.envelope_scan(*args)
    want = sbrd.envelope_scan_torch(*sbrd.plane_args(*args))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _bytes_read(args, got):
    """Bytes the map kernel moves, counted by walking its threads one
    (channel, frame, slot) at a time as csrc/sbr_env.cu does (every bin of a
    slot reads the same rows)."""
    (gain, _, _, _, env_id, prev_id, last_env, _, cmask, *_rest) = \
        [a.numpy() if isinstance(a, torch.Tensor) else a for a in args]
    C, F, _, M = gain.shape
    gn, ss, er, act = set(), set(), set(), set()

    def filt_at(c, f):
        for k in range(f - 1, -1, -1):
            if last_env[c, k] >= 0:
                gn.add((c, k, last_env[c, k]))
                return

    def adjust(c, f, s):
        e, p = env_id[c, f, s], prev_id[c, f, s]
        if e < 0:
            return
        act.add((c, f, s))
        if p >= 8:
            filt_at(c, f)
        elif p >= 0:
            gn.add((c, f, p))
        gn.add((c, f, e))
        ss.add((c, f, e))

    for c in range(C):
        for f in range(F):
            for s in range(38):
                if s >= 32 and f < F - 1:
                    continue
                if cmask[c, f, s] <= 0:
                    er.add((c, f, s))
                elif 0 < f and s < 6 and cmask[c, f - 1, 32 + s] <= 0:
                    er.add((c, f - 1, 32 + s))
                if cmask[c, f, s] > 0 and 0 < f and s < 6:
                    adjust(c, f - 1, 32 + s)
                adjust(c, f, s)
        filt_at(c, F)
    per_ch = (*args[10:12], *args[13:16])   # counters, tables, parity
    return (8 * M * (len(gn) + len(ss) + len(er)) + 4 * len(ss)
            + 9 * len(act) + chip_smoke.nbytes(*args[4:5], *args[6:7],
                                               *args[8:9], *args[19:], *got,
                                               *per_ch))


@pytest.mark.parametrize("case", ["real0", "worst", "stale_filt",
                                  "carry_high"])
def test_sbr_env_bound_counts_what_the_kernel_reads(real, case):
    """chip_smoke.sbr_env_bytes, the bytes behind sbr_env's bound, is the
    count of what the kernel's threads read and write on this data; on a
    real group it is below the whole inputs' bytes (envelope rows 5-7 are
    never used: at most 5 envelopes a frame)."""
    args = _map_case(real, case)
    if case != "real0":
        args = chip_smoke.sbr_env_case("cpu", case, C=2, F=12)
    got = sbrd.envelope_scan(*args)
    n = chip_smoke.sbr_env_bytes(args, got)
    assert n == _bytes_read(args, got)
    whole = chip_smoke.nbytes(*(a for a in args if isinstance(a, torch.Tensor)),
                              *got)
    assert n < whole if case == "real0" else n <= whole


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["real", "worst", "wide", "stale_filt",
                                   "carry_high"])
def test_sbr_env_kernel_matches_plain_on_card(which, cuda):
    """Bit for bit against noise_sine_planes, then envelope_scan_torch, at
    the serving shape (C 32, F 48); "wide" has 40 bins."""
    if which == "real":
        (groups, runner) = _real_groups(1)
        pcm, cond = groups[0]
        state = sbrd.device_init_state(runner.static.M)
        args, _, _ = sbrd.envelope_inputs(
            runner.static, pcm.to(cuda), sbrd.cond_to_device(cond, cuda),
            sbrd.state_to_device([state] * NCH, cuda))
    else:
        kind = {"wide": "worst"}.get(which, which)
        args = chip_smoke.sbr_env_case(cuda, kind,
                                          M=40 if which == "wide" else 24)
    _kernels.reset_launches()
    got = sbrd.envelope_scan(*args)
    assert _kernels.launches["sbr_env"] == 1
    want = sbrd.envelope_scan_torch(*sbrd.plane_args(*args))
    for name, g, w in zip(SCAN_OUT, got, want):
        assert g.device.type == "cuda"
        assert torch.equal(g, w), name
