"""The port's HE-AAC v2 (parametric stereo) path (ohpipeline_tpu_torch.codecs.
aac.sbr) against the JAX package's ``sbr_jax``: the PS stage
``ps_decorrelate_mix`` on seeded QMF planes over chained groups, the mixing
matrices ``build_ps_H_slots`` on seeded PsData, the LC core filterbank
``core_imdct_device``, and ``SbrPsDeviceRunner`` on ``chip_smoke.ps_content``
(dryrun_he.aac's left channel with seeded PsData: the repository has no
HE-AAC v2 stream), also against sbr.py's per-frame numpy chain
(``SbrDecoder.process_frame_ps``).  Groups of 8 frames (S = 256 slots).

Tolerances, and why:
  - ``ps_decorrelate_mix``: outputs and the 25 state arrays within 1e-5 of
    each one's peak: the same float32 arithmetic, with the group powers and
    the hybrid FIRs summed in another order than XLA's (8e-8 of the peak
    measured on the outputs, 3e-7 on the state);
  - ``build_ps_H_slots``: equal (the same float64 numpy on both sides);
  - ``core_imdct_device``: within 1e-4 of the PCM's peak (float32 products
    summed in another order; an absolute 1e-4 would ask for equal sums);
  - the runner: <= 2 LSB against the JAX runner (the SBR group's own
    bound, ``test_torch_aac_he_serving``), and max error < 5e-3 of the peak,
    rms error < 1e-3 of the rms against the numpy chain
    (``tests/test_ps_device.py``'s bounds).
The scan's plain version ``ps_scan_torch`` and the kernel
``csrc/ps_mix.cu`` take every operation in the same order, so they agree bit
for bit: ``ps_kernel_model`` (the kernel's three stages, its 60-slot chunks
and its register rings, in numpy float32) is held bit for bit to the plain
version here, and the ``gpu`` tests hold the kernel itself to it on the
card.

JAX is imported inside the tests that compare with it, so the ``gpu`` tests
run where JAX is absent."""

import numpy as np
import pytest
import torch

import chip_smoke
from ohpipeline_tpu_torch import _kernels
from ohpipeline_tpu_torch._host import aac_sbr as SBR
from ohpipeline_tpu_torch._host import aac_sbr_jax as SJ
from ohpipeline_tpu_torch.codecs import aac
from ohpipeline_tpu_torch.codecs.aac import sbr as sbrd

G = 8                      # frames a group
S = 32 * G                 # slots a group
NG = 3                     # chained groups


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _peak_err(got, want) -> float:
    got, want = (np.asarray(a, np.float64) for a in (got, want))
    return float(np.abs(got - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _planes(seed: int):
    """Seeded mid QMF planes (S, 64) with a burst every 40 slots, and
    mixing matrices (S, 4, 22) in [-1.5, 1.5)."""
    rng = np.random.default_rng(seed)
    burst = np.where(np.arange(S) % 40 == 0, 30.0, 1.0)[:, None]
    Zr, Zi = ((rng.standard_normal((S, 64)) * 1000.0 * burst)
              .astype(np.float32) for _ in range(2))
    H = rng.uniform(-1.5, 1.5, (S, 4, 22)).astype(np.float32)
    return Zr, Zi, H


def _capture_scan():
    """Wraps ps_scan_torch to keep the arguments of each call (a list)."""
    seen = []
    real = sbrd.ps_scan_torch

    def rec(*args):
        seen.append(tuple(a.clone() for a in args))
        return real(*args)
    return seen, rec


def test_ps_decorrelate_mix_matches_jax_over_chained_groups(monkeypatch):
    import jax.numpy as jnp

    from ohpipeline_tpu.codecs.aac import sbr_jax

    ps_j, ps_p = sbr_jax.PsStatic(), sbrd.PsStatic()
    st_j = sbr_jax.ps_init_state()
    st_p = sbrd.ps_state_to_device([sbrd.ps_init_state()], "cpu")
    seen, rec = _capture_scan()
    monkeypatch.setattr(sbrd, "ps_scan_torch", rec)
    for g in range(NG):
        Zr, Zi, H = _planes(g)
        *out_j, st_j = sbr_jax.ps_decorrelate_mix(
            ps_j, ps_j, jnp.asarray(Zr), jnp.asarray(Zi), jnp.asarray(H),
            {k: jnp.asarray(v) for k, v in st_j.items()})
        *out_p, st_p = sbrd.ps_decorrelate_mix(
            ps_p, *(torch.from_numpy(a)[None] for a in (Zr, Zi, H)), st_p)
        for a, b in zip(out_j, out_p):
            assert b.shape == (1, S, 64)
            assert _peak_err(b[0].numpy(), a) <= 1e-5
        host = sbrd.ps_state_to_host(st_p)[0]
        assert sorted(host) == sorted(st_j) and len(host) == 25
        for k, v in st_j.items():
            assert host[k].shape == np.shape(v), k
            assert _peak_err(host[k], v) <= 1e-5, k
    # the transient factors took both branches
    trans = torch.cat([sbrd.ps_transients(
        mr, mi, sbrd._split(carry, sbrd.PS_CARRY)["pow"], coef, imap)[0]
        for mr, mi, _H, carry, coef, imap in seen], 1)
    assert bool((trans < 1).any()) and bool((trans == 1).any())


def test_ps_state_round_trip():
    rng = np.random.default_rng(3)
    states = [{k: rng.standard_normal(np.shape(v)).astype(np.float32)
               for k, v in sbrd.ps_init_state().items()} for _ in range(2)]
    back = sbrd.ps_state_to_host(sbrd.ps_state_to_device(states, "cpu"))
    for s, b in zip(states, back):
        assert sorted(s) == sorted(b)
        for k in s:
            assert np.array_equal(s[k], b[k]), k


def test_layouts_match_the_kernel():
    assert sbrd._size(sbrd.PS_CARRY) == _kernels.PS_NCARRY
    assert sbrd._size(sbrd.PS_COEF) == _kernels.PS_NCOEF
    assert sbrd._size(sbrd.PS_IMAP) == _kernels.PS_NIMAP
    assert (sbrd.PS_CH, sbrd.PS_MIX) == (_kernels.PS_CH, _kernels.PS_MIX)
    k = sbrd.ps_constants(sbrd.PsStatic(), "cpu")
    ix = sbrd._split(k["imap"], sbrd.PS_IMAP)
    mem = ix["members"]
    # each group's channels in increasing order; every channel of the
    # power map in exactly one group, channels 4 and 5 in none
    for g in range(sbrd.PS_GROUPS):
        row = mem[g, :int(ix["nmem"][g])]
        assert bool((row[1:] > row[:-1]).all()) and bool((row >= 0).all())
        assert bool((mem[g, int(ix["nmem"][g]):] == -1).all())
    used = sorted(int(c) for c in mem[mem >= 0])
    assert used == [c for c in range(sbrd.PS_CH) if c not in (4, 5)]


def _ps_sequence(F: int, seed: int) -> list:
    """Seeded PsData frames (chip_smoke.ps_frame), None on every fifth."""
    rng = np.random.default_rng(seed)
    prev_i, prev_c = np.zeros(34, np.int64), np.zeros(34, np.int64)
    out = []
    for f in range(F):
        ps = chip_smoke.ps_frame(rng, f, prev_i, prev_c)
        if ps is not None:
            _, _, prev_i, prev_c = SBR.decode_ps_indices(ps, prev_i, prev_c)
        out.append(ps)
    return out


def test_ps_frames_cover_what_they_name(monkeypatch):
    # the decoded indices stay legal without the decoder's clamps
    real = SBR._ps_delta_decode

    def unclamped(enable, raw, prev, dt, n, stride, lo, hi):
        out = real(enable, raw, prev, dt, n, stride, -10 ** 6, 10 ** 6)
        assert lo <= out.min() and out.max() <= hi
        return out

    monkeypatch.setattr(SBR, "_ps_delta_decode", unclamped)
    seq = _ps_sequence(NG * G, 900)
    live = [p for p in seq if p is not None]
    assert seq[0] is not None and None in seq
    assert {p.mode_iid for p in live} == set(range(6))
    assert {p.mode_icc for p in live} == set(range(6))
    assert {p.frame_class for p in live} == {0, 1}
    assert {p.n_env for p in live if p.frame_class == 0} == {0, 1, 2, 4}


@pytest.mark.parametrize("seed", [900, 901])
def test_build_ps_H_slots_matches_jax(seed):
    from ohpipeline_tpu.codecs.aac import sbr as jsbr
    from ohpipeline_tpu.codecs.aac import sbr_jax

    seq = _ps_sequence(NG * G, seed)
    pj, pp = jsbr.PsDecoder(), SBR.PsDecoder()
    assert hasattr(pj, "_h_delay") and hasattr(pp, "_h_delay")
    for g in range(NG):
        got = SJ.build_ps_H_slots(pp, seq[g * G:(g + 1) * G], 32)
        want = sbr_jax.build_ps_H_slots(pj, seq[g * G:(g + 1) * G], 32)
        assert got.shape == want.shape == (S, 4, 22)
        assert np.array_equal(got, want)


def test_build_ps_H_slots_needs_the_h_delay():
    pdec = SBR.PsDecoder()
    del pdec._h_delay
    with pytest.raises(ValueError, match="_h_delay"):
        SJ.build_ps_H_slots(pdec, _ps_sequence(G, 900), 32)


def test_build_ps_H_slots_seeds_the_identity_split():
    """The first 6 slots of a fresh decoder's first group are the identity
    split PsDecoder.__init__ puts in its H delay (not the group's first
    matrix, as the JAX function takes without _h_delay)."""
    H = SJ.build_ps_H_slots(SBR.PsDecoder(), _ps_sequence(G, 900), 32)
    ident = np.array([np.ones(22), np.ones(22), np.zeros(22), np.zeros(22)])
    assert np.array_equal(H[:6], np.broadcast_to(ident, (6, 4, 22)))


def test_core_imdct_device_matches_jax():
    import jax.numpy as jnp

    from ohpipeline_tpu.codecs.aac import sbr_jax

    from ohpipeline_tpu_torch._host import aac_native
    from ohpipeline_tpu_torch.codecs.aac import synthesis as SYN

    data = open(chip_smoke.AAC_ASSET, "rb").read()
    n, _, b = aac_native().aac_parse_group(data, 0, channels=2,
                                           max_frames=24)
    specs, ops = SYN.prepare_group(b, n, 2, np.zeros(2, np.int32))
    assert (ops >> 2 == 2).any() and (ops >> 2 != 2).any()  # short, long
    ov = np.random.default_rng(1).standard_normal((2, 1024)) \
        .astype(np.float32) * 1000
    specs_c, ops_c = specs.transpose(1, 0, 2), ops.T
    got, got_ov = sbrd.core_imdct_device(
        torch.from_numpy(np.ascontiguousarray(specs_c)),
        torch.from_numpy(np.ascontiguousarray(ops_c)), torch.from_numpy(ov))
    for c in range(2):
        want, want_ov = sbr_jax.core_imdct_device(
            jnp.asarray(specs_c[c]), jnp.asarray(ops_c[c]), jnp.asarray(ov[c]))
        peak = float(np.abs(want).max())
        assert np.abs(got[c].numpy() - want).max() <= 1e-4 * peak
        assert np.abs(got_ov[c].numpy() - want_ov).max() <= 1e-4 * peak
    # and the numpy float32 core of the plug-in
    st = aac._StreamState(2)
    st.overlap = ov.astype(np.float64)
    ref = aac._core_float_from_specs(specs, ops, st)
    assert _peak_err(got.reshape(2, -1).numpy(), ref) <= 1e-5
    assert _peak_err(got_ov.numpy(), st.overlap) <= 1e-5


@pytest.fixture(scope="module")
def content():
    return chip_smoke.ps_content(0, NG * G)


def _lsb(a, b) -> int:
    return int(np.abs(np.asarray(a, np.int64) - np.asarray(b, np.int64))
               .max())


def _spec_groups(runner, c, host_ov):
    return np.concatenate([runner.decode_group_lazy_spec(
        c["specs"][g * G:(g + 1) * G], c["ops"][g * G:(g + 1) * G],
        c["datas"][g * G:(g + 1) * G], c["Es"][g * G:(g + 1) * G],
        c["Qs"][g * G:(g + 1) * G], c["ps"][g * G:(g + 1) * G], host_ov)()
        for g in range(NG)], axis=1)


def _pcm_groups(runner, c, core):
    return np.concatenate([runner.decode_group(
        core[g * G:(g + 1) * G], c["datas"][g * G:(g + 1) * G],
        c["Es"][g * G:(g + 1) * G], c["Qs"][g * G:(g + 1) * G],
        c["ps"][g * G:(g + 1) * G]) for g in range(NG)], axis=1)


@pytest.fixture(scope="module")
def numpy_ref():
    return chip_smoke.numpy_ps_chain(chip_smoke.ps_content(0, NG * G))


@pytest.mark.parametrize("mode", ["spec", "pcm"])
def test_ps_runner_matches_jax_and_the_numpy_chain(content, numpy_ref,
                                                    mode, monkeypatch):
    from ohpipeline_tpu.codecs.aac import sbr_jax

    seen, rec = _capture_scan()
    monkeypatch.setattr(sbrd, "ps_scan_torch", rec)
    zeros = np.zeros(1024, np.float32)
    port = sbrd.SbrPsDeviceRunner(content["dec"], device="cpu")
    ref = sbr_jax.SbrPsDeviceRunner(content["dec"])
    if mode == "spec":
        got, want = _spec_groups(port, content, zeros), \
            _spec_groups(ref, content, zeros)
    else:
        core = aac._core_float_from_specs(
            content["specs"][:, None], content["ops"][:, None],
            aac._StreamState(1)).reshape(-1, 1024).astype(np.float32)
        got, want = _pcm_groups(port, content, core), \
            _pcm_groups(ref, content, core)
    assert got.shape == want.shape == (2, NG * G * 2048)
    assert got.dtype == np.int16 and got.any()
    assert _lsb(got, want) <= 2
    err = got.astype(np.float64) - numpy_ref
    assert np.abs(err).max() / np.abs(numpy_ref).max() < 5e-3
    assert np.sqrt((err ** 2).mean() / (numpy_ref ** 2).mean()) < 1e-3
    # the scan ran once a group, on the group's slots, with transients
    assert len(seen) == NG and all(a[0].shape == (1, S, 73) for a in seen)
    for mr, mi, _H, carry, coef, imap in seen:
        trans = sbrd.ps_transients(
            mr, mi, sbrd._split(carry, sbrd.PS_CARRY)["pow"], coef, imap)[0]
        assert bool((trans < 1).any())
    # the spec mode's core overlap goes back to the host once
    if mode == "spec":
        ov = port.fetch_core_overlap()
        assert ov.shape == (1024,) and port.fetch_core_overlap() is None
        assert np.abs(ov - np.asarray(ref.fetch_core_overlap())).max() \
            <= 1e-4 * np.abs(ov).max()


def ps_kernel_model(mr, mi, H, carry, coef, imap):
    """csrc/ps_mix.cu's three stages in numpy float32, vectorised over the
    streams and over each stage's threads.  1. the group powers; 2. the
    chains: the 20 power chains storing (ppd, nrg) a slot, and the 32
    all-pass channels walked slot by slot (the kernel's chunks of staged
    slots change no operation), each ring held oldest first and moved along
    a slot as the kernel's registers are, the re and im parts of a channel each computed as the kernel's lane
    pair does (own part x c1 + other part x c2, a difference taken as the
    sum with the negated product), storing d before the transient factor;
    3. the mix: trans from (ppd,
    nrg), the long channels' delay read straight from the input or the
    carried ring, the carry's long rings the last 14 inputs.  Every numpy
    float32 operation rounds on its own, as the kernel's __fmul_rn /
    __fadd_rn / __fsub_rn / __fdiv_rn do."""
    mr, mi, H, carry, coef = (np.asarray(a, np.float32)
                              for a in (mr, mi, H, carry, coef))
    imap = np.asarray(imap)
    f32 = np.float32
    k = sbrd._split(coef, sbrd.PS_COEF)
    ix = sbrd._split(imap, sbrd.PS_IMAP)
    cin = sbrd._split(carry, sbrd.PS_CARRY)
    pk, ic, ti = k["pk_ic_ti"]
    AP, LG, NG, LNG = sbrd.PS_AP, sbrd.PS_LONG, sbrd.PS_GROUPS, sbrd.PS_LNG
    C, Sn, _ = mr.shape
    # 1. group powers, members in channel order
    p = np.zeros((C, Sn, NG), f32)
    for g in range(NG):
        acc = np.zeros((C, Sn), f32)
        for j in range(int(ix["nmem"][g])):
            m = ix["members"][g, j]
            acc = acc + (mr[..., m] * mr[..., m] + mi[..., m] * mi[..., m])
        p[..., g] = acc
    # 2. the power chains
    pd, ppd, pnrg = (cin["pow"][:, i].copy() for i in range(3))
    ppd_s, nrg_s = np.zeros((2, C, Sn, NG), f32)
    for t in range(Sn):
        pt = p[:, t]
        pd = np.maximum(pd * pk, pt)
        ppd = ppd + ic * ((pd - pt) - ppd)
        pnrg = np.maximum(pnrg + ic * (pt - pnrg), f32(0))
        ppd_s[:, t], nrg_s[:, t] = ppd, pnrg * ti
    # ... and the all-pass walk
    d2a_r, d2b_r = (cin["d2_re"][:, i].copy() for i in range(2))
    d2a_i, d2b_i = (cin["d2_im"][:, i].copy() for i in range(2))
    rings = [[cin[f"r{d}_re"].copy(), cin[f"r{d}_im"].copy()]
             for d in sbrd.PS_LINKS]
    d_re, d_im = np.zeros((2, C, Sn, AP), f32)
    for t in range(Sn):
        x_r, x_i = mr[:, t, :AP], mi[:, t, :AP]
        # a lane's part: own * c1 + other * c2, a - b taken as a + (-b)
        r0r = d2a_r * k["phi_re"] + d2a_i * -k["phi_im"]
        r0i = d2a_i * k["phi_re"] + d2a_r * k["phi_im"]
        d2a_r, d2a_i, d2b_r, d2b_i = d2b_r, d2b_i, x_r, x_i
        res_r, res_i = k["dsf"] * r0r, k["dsf"] * r0i
        for m, ring in enumerate(rings):
            sr, si = ring[0][..., 0], ring[1][..., 0]
            sre, sim = k["ser_re"][:, m], k["ser_im"][:, m]
            tr = (sr * sre + si * -sim) - k["dser"][m] * res_r
            tq = (si * sre + sr * sim) - k["dser"][m] * res_i
            res_r, res_i = k["dsf"] * tr, k["dsf"] * tq
            new = (r0r + k["dser"][m] * res_r, r0i + k["dser"][m] * res_i)
            for q in range(2):
                ring[q] = np.concatenate(
                    [ring[q][..., 1:], new[q][..., None]], -1)
            r0r, r0i = tr, tq
        d_re[:, t], d_im[:, t] = r0r, r0i
    # 3. trans, the long delays and the mix
    with np.errstate(over="ignore", divide="ignore"):  # the branch not taken
        trans = np.where(ppd_s <= nrg_s, f32(1),
                         nrg_s / np.maximum(ppd_s, f32(1e-30)))
    tc = trans[..., ix["tgrp"]]
    hist = [np.concatenate([cin[f"lng_{q}"].transpose(0, 2, 1), x[..., AP:]],
                           1) for q, x in (("re", mr), ("im", mi))]
    at = np.arange(Sn)[:, None] + ix["loff"][None, :]
    dr = np.concatenate([d_re, hist[0][:, at, np.arange(LG)]], -1) * tc
    di = np.concatenate([d_im, hist[1][:, at, np.arange(LG)]], -1) * tc
    hh, cm = H[..., ix["mgrp"]], k["cmask"]
    outs = [(hh[:, :, 0] * mr + hh[:, :, 2] * dr) * cm,
            (hh[:, :, 0] * mi + hh[:, :, 2] * di) * cm,
            (hh[:, :, 1] * mr + hh[:, :, 3] * dr) * cm,
            (hh[:, :, 1] * mi + hh[:, :, 3] * di) * cm]
    parts = dict(pow=np.stack([pd, ppd, pnrg], 1),
                 d2_re=np.stack([d2a_r, d2b_r], 1),
                 d2_im=np.stack([d2a_i, d2b_i], 1),
                 lng_re=hist[0][:, Sn:Sn + LNG].transpose(0, 2, 1),
                 lng_im=hist[1][:, Sn:Sn + LNG].transpose(0, 2, 1))
    for d, (re, im) in zip(sbrd.PS_LINKS, rings):
        parts[f"r{d}_re"], parts[f"r{d}_im"] = re, im
    cout = np.concatenate([parts[nm].reshape(C, -1)
                           for nm, _ in sbrd.PS_CARRY], 1)
    return (*outs, cout)


def _equal(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        assert np.array_equal(g.view(np.int32), w.view(np.int32))


@pytest.mark.parametrize("case", ["worst", "tail chunk", "real", "S=1",
                                  "S=59", "S=60", "S=61", "S=121",
                                  "chained"])
def test_ps_kernel_model_equals_plain(case, content, monkeypatch):
    """Full chunks and remainders of 1 to 29 slots, a group shorter than the
    2-slot delay and than every ring, and a carry from a group whose last
    chunk was short into the next."""
    if case == "real":
        seen, rec = _capture_scan()
        monkeypatch.setattr(sbrd, "ps_scan_torch", rec)
        _spec_groups(sbrd.SbrPsDeviceRunner(content["dec"], device="cpu"),
                     content, np.zeros(1024, np.float32))
        args = seen[1]
    elif case.startswith("S="):
        args = chip_smoke.ps_mix_worst_case("cpu", C=1, S=int(case[2:]))
    else:
        args = chip_smoke.ps_mix_worst_case(
            "cpu", C=2, S={"worst": S, "tail chunk": 101, "chained": 61}[case])
    want = sbrd.ps_scan_torch(*args)
    got = ps_kernel_model(*args)
    _equal(got, want)
    if case == "chained":
        nxt = chip_smoke.ps_mix_worst_case("cpu", C=2, S=121, seed=16)
        want = sbrd.ps_scan_torch(*nxt[:3], want[4], *nxt[4:])
        got = ps_kernel_model(*nxt[:3], got[4], *nxt[4:])
        _equal(got, want)
    if case == "worst":
        trans = sbrd.ps_transients(
            args[0], args[1], sbrd._split(args[3], sbrd.PS_CARRY)["pow"],
            args[4], args[5])[0]
        assert bool((trans < 1).any()) and bool((trans == 1).any())
        assert float(args[0].abs().max()) > 3e4


def test_ps_scan_needs_a_kernel_off_the_cpu():
    args = chip_smoke.ps_mix_worst_case("cpu", C=1, S=4)
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.ps_mix(*args)
    with pytest.raises(ValueError, match="no kernel"):
        sbrd.ps_scan(*(a.to("meta") for a in args))


PS_CARD_CASES = {"worst": (3, S), "tail chunk": (2, 101), "chained": (3, S),
                 **{f"C={c} S={n}": (c, n) for n in (1, 59, 61, 121)
                    for c in (1, 16)}}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(PS_CARD_CASES))
def test_ps_mix_kernel_matches_plain_on_card(cuda, case):
    C, n = PS_CARD_CASES[case]
    args = chip_smoke.ps_mix_worst_case(cuda, C=C, S=n)
    _kernels.reset_launches()
    got = sbrd.ps_scan(*args)
    want = sbrd.ps_scan_torch(*args)
    if case == "chained":
        nxt = chip_smoke.ps_mix_worst_case(cuda, C=C, S=n, seed=16)
        got = sbrd.ps_scan(*nxt[:3], got[4], *nxt[4:])
        want = sbrd.ps_scan_torch(*nxt[:3], want[4], *nxt[4:])
    torch.cuda.synchronize()
    assert _kernels.launches["ps_mix"] == (2 if case == "chained" else 1)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_ps_runner_card_matches_cpu(cuda, content):
    zeros = np.zeros(1024, np.float32)
    _kernels.reset_launches()
    got = _spec_groups(sbrd.SbrPsDeviceRunner(content["dec"], device=cuda),
                       content, zeros)
    assert _kernels.launches["ps_mix"] == NG
    want = _spec_groups(sbrd.SbrPsDeviceRunner(content["dec"], device="cpu"),
                        content, zeros)
    assert _lsb(got, want) <= 2
