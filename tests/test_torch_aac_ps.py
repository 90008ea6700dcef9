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
for bit: ``ps_kernel_model`` (the kernel's chunked walk with its ring
pointers, in numpy float32) is held bit for bit to the plain version here,
and the ``gpu`` tests hold the kernel itself to it on the card.

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


def ps_kernel_model(mr, mi, H, carry, coef, imap, chunk=32):
    """csrc/ps_mix.cu's walk in numpy float32, vectorised over its threads:
    per stream, slots in chunks of ``chunk``; per chunk the (group, slot)
    powers, the 20-thread recurrence, then each channel's delay, all-pass
    links over rings addressed by their oldest slot (p3, p4, p5, pl) in
    shared-memory layout, and mix; the carry written back oldest slot
    first.  Every numpy float32 operation rounds on its own, as the
    kernel's __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn do."""
    mr, mi, H, carry, coef = (np.asarray(a, np.float32)
                              for a in (mr, mi, H, carry, coef))
    imap = np.asarray(imap)
    f32 = np.float32
    k = sbrd._split(coef, sbrd.PS_COEF)
    ix = sbrd._split(imap, sbrd.PS_IMAP)
    pk, ic, ti = k["pk_ic_ti"]
    AP, LG = sbrd.PS_AP, sbrd.PS_LONG
    C, Sn, _ = mr.shape
    outs = np.zeros((4, C, Sn, sbrd.PS_CH), f32)
    cout = np.zeros_like(carry)
    lidx = np.arange(LG)
    for c in range(C):
        cin = sbrd._split(carry[c], sbrd.PS_CARRY)
        pd, ppd, pnrg = (cin["pow"][i].copy() for i in range(3))
        d2a_r, d2b_r = cin["d2_re"][0].copy(), cin["d2_re"][1].copy()
        d2a_i, d2b_i = cin["d2_im"][0].copy(), cin["d2_im"][1].copy()
        s_ap = np.zeros((2, 12, AP), f32)
        for base, d in ((0, 3), (3, 4), (7, 5)):
            s_ap[0, base:base + d] = cin[f"r{d}_re"].T
            s_ap[1, base:base + d] = cin[f"r{d}_im"].T
        s_lng = np.stack([cin["lng_re"].T, cin["lng_im"].T]).copy()
        p3 = p4 = p5 = pl = 0
        for t0 in range(0, Sn, chunk):
            n = min(chunk, Sn - t0)
            xr, xi, h = mr[c, t0:t0 + n], mi[c, t0:t0 + n], H[c, t0:t0 + n]
            s_tr = np.zeros((n, sbrd.PS_GROUPS), f32)
            for g in range(sbrd.PS_GROUPS):
                acc = np.zeros(n, f32)
                for j in range(int(ix["nmem"][g])):
                    m = ix["members"][g, j]
                    acc = acc + (xr[:, m] * xr[:, m] + xi[:, m] * xi[:, m])
                s_tr[:, g] = acc
            for t in range(n):
                p = s_tr[t].copy()
                pd = np.maximum(pd * pk, p)
                ppd = ppd + ic * ((pd - p) - ppd)
                pnrg = np.maximum(pnrg + ic * (p - pnrg), f32(0))
                nrg = pnrg * ti
                with np.errstate(over="ignore"):     # the branch not taken
                    s_tr[t] = np.where(ppd <= nrg, f32(1),
                                       nrg / np.maximum(ppd, f32(1e-30)))
            for t in range(n):
                x_r, x_i = xr[t], xi[t]
                r0r = d2a_r * k["phi_re"] - d2a_i * k["phi_im"]
                r0i = d2a_r * k["phi_im"] + d2a_i * k["phi_re"]
                d2a_r, d2a_i = d2b_r, d2b_i
                d2b_r, d2b_i = x_r[:AP].copy(), x_i[:AP].copy()
                res_r, res_i = k["dsf"] * r0r, k["dsf"] * r0i
                for m, at in enumerate((p3, 3 + p4, 7 + p5)):
                    sr, si = s_ap[0, at].copy(), s_ap[1, at].copy()
                    sre, sim = k["ser_re"][:, m], k["ser_im"][:, m]
                    tr = (sr * sre - si * sim) - k["dser"][m] * res_r
                    tq = (sr * sim + si * sre) - k["dser"][m] * res_i
                    res_r, res_i = k["dsf"] * tr, k["dsf"] * tq
                    s_ap[0, at] = r0r + k["dser"][m] * res_r
                    s_ap[1, at] = r0i + k["dser"][m] * res_i
                    r0r, r0i = tr, tq
                rd = pl + ix["loff"]
                rd = np.where(rd < sbrd.PS_LNG, rd, rd - sbrd.PS_LNG)
                dl_r, dl_i = s_lng[0, rd, lidx], s_lng[1, rd, lidx]
                s_lng[0, pl], s_lng[1, pl] = x_r[AP:], x_i[AP:]
                tc = s_tr[t][ix["tgrp"]]
                dr = np.concatenate([r0r, dl_r]) * tc
                di = np.concatenate([r0i, dl_i]) * tc
                hh = h[t][:, ix["mgrp"]]
                cm = k["cmask"]
                outs[:, c, t0 + t] = [(hh[0] * x_r + hh[2] * dr) * cm,
                                      (hh[0] * x_i + hh[2] * di) * cm,
                                      (hh[1] * x_r + hh[3] * dr) * cm,
                                      (hh[1] * x_i + hh[3] * di) * cm]
                p3, p4, p5 = (p3 + 1) % 3, (p4 + 1) % 4, (p5 + 1) % 5
                pl = (pl + 1) % sbrd.PS_LNG
        parts = dict(pow=np.stack([pd, ppd, pnrg]),
                     d2_re=np.stack([d2a_r, d2b_r]),
                     d2_im=np.stack([d2a_i, d2b_i]))
        for base, d, p in ((0, 3, p3), (3, 4, p4), (7, 5, p5)):
            order = base + (p + np.arange(d)) % d
            parts[f"r{d}_re"] = s_ap[0, order].T
            parts[f"r{d}_im"] = s_ap[1, order].T
        order = (pl + np.arange(sbrd.PS_LNG)) % sbrd.PS_LNG
        parts["lng_re"] = s_lng[0, order].T
        parts["lng_im"] = s_lng[1, order].T
        cout[c] = np.concatenate([parts[nm].reshape(-1)
                                  for nm, _ in sbrd.PS_CARRY])
    return (*outs, cout)


def _equal(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        assert np.array_equal(g.view(np.int32), w.view(np.int32))


@pytest.mark.parametrize("case", ["worst", "tail chunk", "real"])
def test_ps_kernel_model_equals_plain(case, content, monkeypatch):
    if case == "real":
        seen, rec = _capture_scan()
        monkeypatch.setattr(sbrd, "ps_scan_torch", rec)
        _spec_groups(sbrd.SbrPsDeviceRunner(content["dec"], device="cpu"),
                     content, np.zeros(1024, np.float32))
        args = seen[1]
    else:
        args = chip_smoke.ps_mix_worst_case(
            "cpu", C=2, S=S if case == "worst" else 101)
    want = sbrd.ps_scan_torch(*args)
    _equal(ps_kernel_model(*args), want)
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


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["worst", "tail chunk", "chained"])
def test_ps_mix_kernel_matches_plain_on_card(cuda, case):
    C, n = (3, S) if case != "tail chunk" else (2, 101)
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
