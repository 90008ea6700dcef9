"""The port's AAC-LC synthesis (ohpipeline_tpu_torch.codecs.aac.synthesis)
against ohpipeline_tpu.codecs.aac.synthesis on the same inputs.

Host helpers and constant tables are numpy in both packages and must be
equal.  The device program's elementwise front end reproduces the JAX
package's float32 operations bit for bit; TNS is held to 1e-5 of each row's
peak, and the PCM of ``decode_chunk_zz`` to the repo's own bounds between
wires (atol 0.05 without TNS, 0.5 with it) and to the float64 reference
(rms <= 0.25, max <= 1 LSB).  Content: ``tests/assets/dryrun.aac`` (89
ADTS frames, 44.1 kHz stereo, with short windows, TNS, escapes, PNS and
M/S) and a seeded synthetic TNS pool.  The ``gpu`` tests hold the TNS kernel
on the card to the float64 reference and to its plain version, unless the
plain version is the further of the two from float64 (chip_smoke.py's
``tns_gate``: on filters at the encoder's limits the plain version drifts
past 1e-5 of the row's peak)."""

import pathlib

import numpy as np
import pytest
import torch

import chip_smoke
from ohpipeline_tpu_torch import _kernels
from ohpipeline_tpu_torch._host import aac_native
from ohpipeline_tpu_torch.codecs.aac import synthesis as SYN
from ohpipeline_tpu_torch.codecs.aac.serving import _side_rows

DATA = (pathlib.Path(__file__).resolve().parent / "assets"
        / "dryrun.aac").read_bytes()
NCH = 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _jsyn():
    from ohpipeline_tpu.codecs.aac import synthesis as JSYN
    return JSYN


def _t(*arrays, device="cpu"):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def _parse(G, pos=0):
    return aac_native().aac_parse_group(DATA, pos, channels=NCH,
                                        max_frames=G)


# --- host helpers and constant tables: equal -------------------------------

def test_constant_tables_equal():
    J = _jsyn()
    for n_out in (2048, 256):
        np.testing.assert_array_equal(SYN._imdct_matrix(n_out),
                                      J._imdct_matrix(n_out))
    for got, want in zip(SYN.window_bank(), J.window_bank()):
        np.testing.assert_array_equal(got, want)
    for ri in range(12):
        np.testing.assert_array_equal(SYN.sf_expand_matrix(ri),
                                      J.sf_expand_matrix(ri))
    np.testing.assert_array_equal(SYN._POW43, J._POW43)


@pytest.mark.parametrize("key", [(4, 0, 0, 49), (4, 0, 0, 40),
                                 (4, 2, 0x5B, 14), (4, 2, 0, 12),
                                 (3, 2, 0x7F, 14), (8, 0, 0, 43)])
def test_layout_equal(key):
    for got, want in zip(SYN._layout(*key), _jsyn()._layout(*key)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("start_frame", [0, 64])
def test_prepare_group_equal(start_frame):
    """A 25-frame group from frame 0 (short windows, TNS) and from frame 64
    (PNS rows at frames 87-88)."""
    pos = 0
    if start_frame:
        _n, pos, _b = _parse(start_frame)
    n, _, b = _parse(25, pos)
    ps_port, ps_jax = np.array([0, 1], np.int32), np.array([0, 1], np.int32)
    got = SYN.prepare_group(b, n, NCH, ps_port)
    want = _jsyn().prepare_group(b, n, NCH, ps_jax)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(ps_port, ps_jax)


def test_lattice_and_pns_equal():
    J = _jsyn()
    refl = np.sin(np.arange(-6, 6) / 4.77)
    np.testing.assert_array_equal(SYN._lattice_to_lpc(refl),
                                  J._lattice_to_lpc(refl))
    np.testing.assert_array_equal(SYN._pns_noise(175, 212, 40),
                                  J._pns_noise(175, 212, 40))


# --- elementwise front end: bit-exact --------------------------------------

def test_fast_cbrt_and_exp2_quarter_bit_exact():
    import jax.numpy as jnp
    J = _jsyn()
    q = np.arange(8192, dtype=np.float32)
    np.testing.assert_array_equal(
        SYN._fast_cbrt(torch.from_numpy(q)).numpy().view(np.int32),
        np.asarray(J._fast_cbrt(jnp.asarray(q))).view(np.int32))
    k = np.arange(-100, 156, dtype=np.int32)
    np.testing.assert_array_equal(
        SYN._exp2_quarter(torch.from_numpy(k)).numpy().view(np.int32),
        np.asarray(J._exp2_quarter(jnp.asarray(k))).view(np.int32))


# --- TNS: plain version against the JAX scan and the f64 reference ---------

def _synthetic_pool(seed, P=24, TB=40, npad=4):
    """Long and short rows (8 windows x up to 3 filters), order up to 12,
    upward and downward regions next to each other, gaps (order 0),
    padding rows, and stable direct-form coefficients from
    _lattice_to_lpc over 4-bit quantised reflection coefficients that
    shrink with the tap, as an encoder's partial correlations do (dryrun's
    first taps reach 0.95, later ones mostly stay within 0.45)."""
    rng = np.random.default_rng(seed)
    tfi = np.zeros((P, 1024), np.uint8)
    tco = np.zeros((P, 24, 12), np.float32)
    tdir = np.zeros((P, 24), np.uint8)
    trow = np.full(P, -1, np.int32)
    trow[:P - npad] = rng.permutation(TB)[:P - npad]
    iq, iqm = 7.5 / (np.pi / 2), 8.5 / (np.pi / 2)
    for j in range(P - npad):
        short = j % 3 == 1
        width = 128 if short else 1024
        for w in range(8 if short else 1):
            nf = int(rng.integers(1, 4))
            bottoms = np.sort(rng.choice(np.arange(4, width - 4), nf,
                                         replace=False))[::-1]
            top = width - int(rng.integers(0, 4))
            for fi, bottom in enumerate(bottoms):
                order = 12 if fi == 0 and j % 2 == 0 else \
                    int(rng.integers(0, 13))
                if order:
                    lim = np.minimum(7, 8 >> np.minimum(
                        np.arange(order), 2))
                    qc = rng.integers(-lim, lim + 1)
                    refl = np.where(qc >= 0, np.sin(qc / iq),
                                    np.sin(qc / iqm))
                    slot = w * 3 + fi
                    tco[j, slot, :order] = SYN._lattice_to_lpc(refl)
                    tdir[j, slot] = rng.integers(0, 2)
                    base = w * 128 if short else 0
                    tfi[j, base + bottom:base + top] = slot + 1
                top = bottom
    spec = (rng.standard_normal((TB, 1024))
            * np.exp(rng.uniform(0, 12, (TB, 1)))).astype(np.float32)
    return spec, tfi, tco, tdir, trow


def _dryrun_pool(seed=3):
    """The TnsPool planes of dryrun.aac's first 64-frame group (TNS on long
    and short rows), over seeded spectra."""
    from ohpipeline_tpu_torch.codecs.aac.serving import iter_groups

    planes, _ = next(iter_groups([DATA], 64))
    assert (planes["trow"] >= 0).sum() >= 4
    rng = np.random.default_rng(seed)
    spec = (rng.standard_normal((64 * NCH, 1024)) * 3000).astype(np.float32)
    return spec, planes["tfi"], planes["tco"], planes["tdir"], planes["trow"]


def _tns_close(got, ref, rows):
    for r in rows[rows >= 0]:
        peak = np.abs(ref[r]).max()
        err = np.abs(got[r].astype(np.float64) - ref[r]).max()
        assert err <= 1e-5 * peak, (int(r), err, peak)


TNS_CASES = {"dryrun": _dryrun_pool,
             "synthetic": lambda: _synthetic_pool(11),
             "synthetic_b": lambda: _synthetic_pool(12)}


@pytest.mark.parametrize("case", list(TNS_CASES))
def test_apply_tns_zz_matches_jax_and_f64(case):
    import jax.numpy as jnp
    J = _jsyn()
    spec, tfi, tco, tdir, trow = TNS_CASES[case]()
    got = SYN.apply_tns_zz(*_t(spec, tfi, tco, tdir, trow)).numpy()
    ref = J.apply_tns_zz_reference(spec.astype(np.float64), tfi, tco, tdir,
                                   trow)
    want = np.asarray(J.apply_tns_zz(*(jnp.asarray(a) for a in
                                       (spec, tfi, tco, tdir, trow))))
    _tns_close(got, ref, trow)
    _tns_close(got, want.astype(np.float64), trow)
    untouched = np.setdiff1d(np.arange(spec.shape[0]), trow)
    np.testing.assert_array_equal(got[untouched], spec[untouched])
    # the port's f64 reference is the JAX package's
    np.testing.assert_array_equal(
        SYN.apply_tns_zz_reference(spec.astype(np.float64), tfi, tco, tdir,
                                   trow), ref)


# --- TNS: the kernel's decomposition into independent runs ------------------

def _pool(P, TB=None):
    TB = P if TB is None else TB
    return (np.zeros((P, 1024), np.uint8), np.zeros((P, 24, 12), np.float32),
            np.zeros((P, 24), np.uint8), np.arange(P, dtype=np.int32), TB)


def _encoder_coeffs(rng, order=12, qc=None):
    """Direct-form coefficients from 4-bit quantised reflection coefficients
    (``qc`` in [-8, 7]; by default shrinking with the tap as an encoder's
    partial correlations do)."""
    if qc is None:
        lim = np.minimum(7, 8 >> np.minimum(np.arange(order), 2))
        qc = rng.integers(-lim, lim + 1)
    qc = np.asarray(qc)
    refl = np.where(qc >= 0, np.sin(qc / (7.5 / (np.pi / 2))),
                    np.sin(qc / (8.5 / (np.pi / 2))))
    return SYN._lattice_to_lpc(refl)


def _tns_edges(seed=21):
    """Single-bin runs (at bins 0, 500 and 1023), a slot in two separate
    stretches, an upward and a downward run meeting at a bin, a run of
    all-zero coefficients, an inactive slot byte (> 24) and an inactive
    direction (2)."""
    rng = np.random.default_rng(seed)
    tfi, tco, tdir, trow, TB = _pool(4)
    for j in range(4):
        for s in range(24):
            tco[j, s] = _encoder_coeffs(rng)
        tdir[j] = rng.integers(0, 2, 24)
    tfi[0, 0], tfi[0, 500], tfi[0, 1023] = 1, 2, 3
    tfi[0, 499], tfi[0, 501] = 4, 4                  # neighbours, one slot
    tfi[1, 100:200] = tfi[1, 300:400] = 5            # two stretches of one
    tfi[1, 200:300] = 6                              # slot, another between
    tfi[2, 200:300], tdir[2, 6] = 7, 0               # up, then down from
    tfi[2, 300:451], tdir[2, 7] = 8, 1               # bin 300: they meet
    tfi[2, 600:700], tco[2, 8] = 9, 0.0              # order 0
    tfi[3, 10:90] = 30                               # slot byte > 24
    tfi[3, 90:400], tdir[3, 9] = 10, 2               # direction 2
    tfi[3, 400:800] = 11
    spec = (rng.standard_normal((TB, 1024)) * 3000).astype(np.float32)
    return spec, tfi, tco, tdir, trow


def _tns_long_near_unit(seed=22):
    """1024-bin runs of order 12, up and down, whose 12 quantised
    reflection coefficients all sit at the encoder's limits: the first at
    the quantiser's ends (7, -8: +0.995, -0.996), the rest at magnitudes 4,
    then 2.  Two of the four (7 then signs alternating; all negative) keep
    phi's row sums under the kernel's gate (2.0, 1.7) and are cut into
    chunks, two (7 then all negative; -8, -4 then signs alternating: 9.5,
    16.2) are walked whole.  Held to the float64 reference (tns_gate).
    (Two sign patterns go further: all positive, or -8 then signs
    alternating from +4, put phi's row sums near 300, and there every
    float32 walk, the plain version's and the kernel's, is 3-5e-5 of the
    row's peak from float64.)"""
    rng = np.random.default_rng(seed)
    tfi, tco, tdir, trow, TB = _pool(4)
    tfi[:] = 1
    tdir[1::2, 0] = 1
    lim = np.minimum(7, 8 >> np.minimum(np.arange(12), 2))
    alt = (-1) ** np.arange(12)
    for j, sign in enumerate((alt, -1, np.r_[1, -np.ones(11)],
                              np.r_[-1, -1, alt[2:]])):
        qc = sign * lim
        qc[0] = 7 if qc[0] > 0 else -8
        tco[j, 0] = _encoder_coeffs(rng, qc=qc)
    spec = (rng.standard_normal((TB, 1024)) * 3000).astype(np.float32)
    return spec, tfi, tco, tdir, trow


def _tns_all_slots_padded(seed=23):
    """chip_smoke.py's worst case (all 24 slots, order 12, both directions),
    its pooled rows interleaved with padding (trow -1) and with rows out of
    range (trow >= TB)."""
    spec, tfi, tco, tdir, trow = chip_smoke.tns_worst_case(P=48, seed=seed)
    trow = trow.copy()
    trow[1::4], trow[3::8] = -1, 48 + 5
    return spec, tfi, tco, tdir, trow



TNS_STRESS = {
    "edges": _tns_edges,
    "long_near_unit": _tns_long_near_unit,
    "all_slots_padded": _tns_all_slots_padded,
    "worst_case": lambda: chip_smoke.tns_worst_case(P=128),
    "dryrun": _dryrun_pool,
}


def tns_runs(tfi, tdir):
    """The runs csrc/tns.cu finds with ballots, as (pooled row, first bin,
    last bin, slot): maximal stretches of one slot byte in 1..24 whose
    direction is 0 or 1."""
    f = tfi.astype(np.int64)
    slot = np.clip(f - 1, 0, 23)
    act = (f >= 1) & (f <= 24) & (np.take_along_axis(tdir, slot, 1) <= 1)
    edge = np.ones_like(act)
    edge[:, 1:] = f[:, 1:] != f[:, :-1]
    last = np.ones_like(act)
    last[:, :-1] = f[:, :-1] != f[:, 1:]
    (j0, lo), (j1, hi) = np.nonzero(act & edge), np.nonzero(act & last)
    assert np.array_equal(j0, j1)
    return j0, lo, hi, slot[j0, lo]


def _walk(xs, a, init):
    """Filters the sequences xs (list of float32 arrays) from the histories
    init (n, 12; init[:, t] is the output t + 1 steps back) with the
    coefficients a (n, 12), all at once, summing the taps in csrc/tns.cu's
    order, oldest first.  Returns the list of outputs."""
    n, L = len(xs), max(len(x) for x in xs)
    x = np.zeros((n, L), np.float32)
    for i, s in enumerate(xs):
        x[i, :len(s)] = s
    a, h = np.asarray(a, np.float32), np.array(init, np.float32)
    y = np.empty_like(x)
    for p in range(L):
        acc = np.zeros(n, np.float32)
        for t in range(11, -1, -1):
            acc = acc + a[:, t] * h[:, t]
        y[:, p] = x[:, p] - acc
        h = np.concatenate([y[:, p:p + 1], h[:, :-1]], 1)
    return [y[i, :len(s)] for i, s in enumerate(xs)]


def _pass_maps(a, g, C):
    """(n, 12, 12) maps from a run's state (12 outputs, newest first) to
    its state C zero-input steps later, as csrc/tns.cu builds them from g
    (n, C), the response to the unit state: phi[r, c] = sum over m <= 11 - c
    of -a[m + c] * g[C - 2 - r - m], m ascending."""
    phi = np.zeros((len(a), 12, 12), np.float32)
    for r in range(12):
        for c in range(12):
            for m in range(12 - c):
                phi[:, r, c] = phi[:, r, c] + (-a[:, m + c]) * g[:, C - 2 - r
                                                                  - m]
    return phi


def tns_kernel_model(spec, tfi, tco, tdir, trow, long=128, C=32, gate=4.0):
    """numpy float32 model of csrc/tns.cu.  Every run of a row, upward and
    downward, is its own chain from a zero history (the passes are not
    sequenced).  A run of up to ``long`` bins is walked whole.  A longer one
    is cut into K chunks of C: chunk 0 from a zero history; each chunk
    1 <= k <= K - 2 from a zero history for its last 12 outputs T0[k]; the
    states passed along, S[1] = chunk 0's last outputs, S[k + 1] = T0[k] +
    phi S[k] (two sums over c, even and odd, ascending); then every chunk
    k >= 1 walked again from S[k].  If a row of phi sums to more than
    ``gate`` in absolute value, the run is walked whole after chunk 0."""
    out = spec.copy()
    TB = spec.shape[0]
    j, lo, hi, slot = tns_runs(tfi, tdir)
    keep = (trow[j] >= 0) & (trow[j] < TB)
    j, lo, hi, slot = j[keep], lo[keep], hi[keep], slot[keep]
    if not len(j):
        return out
    rows, a = trow[j], tco[j, slot]
    idx = [np.arange(l, h + 1)[::-1 if tdir[jj, s] == 1 else 1]
           for jj, l, h, s in zip(j, lo, hi, slot)]
    xs = [out[r, i] for r, i in zip(rows, idx)]
    long_runs = [n for n, x in enumerate(xs) if len(x) > long]
    K = {n: -(-len(xs[n]) // C) for n in long_runs}
    unit = np.eye(12, dtype=np.float32)[0]
    # first round: short runs whole, chunk 0 and the tails of chunks 1 to
    # K - 2 of the long runs, and each long run's unit-state response
    tasks = [(xs[n] if n not in K else xs[n][:C], a[n], 0 * unit, n)
             for n in range(len(xs))]
    tasks += [(xs[n][k * C:(k + 1) * C], a[n], 0 * unit, (n, k))
              for n in long_runs for k in range(1, K[n] - 1)]
    tasks += [(np.zeros(C, np.float32), a[n], unit, (n, "g"))
              for n in long_runs]
    ys = dict(zip((t[3] for t in tasks),
                  _walk(*zip(*((x, aa, i) for x, aa, i, _ in tasks)))))
    if long_runs:
        phi = _pass_maps(a[long_runs], np.stack([ys[n, "g"]
                                                 for n in long_runs]), C)
    tasks = []
    for q, n in enumerate(long_runs):
        state = ys[n][:-13:-1]                       # S[1]
        if np.abs(phi[q]).sum(1).max() > gate:
            tasks.append((xs[n][C:], a[n], state, (n, 1)))
            continue
        for k in range(1, K[n]):
            tasks.append((xs[n][k * C:(k + 1) * C], a[n], state, (n, k)))
            if k < K[n] - 1:
                even = odd = np.zeros(12, np.float32)
                for c in range(0, 12, 2):
                    even = even + phi[q][:, c] * state[c]
                    odd = odd + phi[q][:, c + 1] * state[c + 1]
                state = ys[n, k][:-13:-1] + (even + odd)
    if tasks:
        for (_, _, _, (n, k)), y in zip(tasks, _walk(
                *zip(*((x, aa, i) for x, aa, i, _ in tasks)))):
            ys[n] = np.concatenate([ys[n][:k * C], y])
    for n, (r, i) in enumerate(zip(rows, idx)):
        out[r, i] = ys[n]
    return out


def _tns_gate(got, plain, arrays):
    """The TNS gate of chip_smoke.py on the pool ``arrays`` (the float64
    reference of ``tns_f64``; ``_nearer_than_plain``)."""
    ref, inside = chip_smoke.tns_f64(*arrays)
    _nearer_than_plain(got, plain, ref, inside[inside >= 0])


@pytest.mark.parametrize("case,long", [(c, 128) for c in TNS_STRESS]
                         + [("worst_case", 40), ("long_near_unit", 40),
                            ("dryrun", 40)])
def test_tns_kernel_model_matches_plain(case, long):
    """The kernel's decomposition (every run on its own, both directions at
    once; runs over ``long`` bins cut into chunks with their states passed
    along) passes the TNS gate against the float64 reference and
    tns_scan_torch (``_tns_gate``).  ``long`` 40 cuts most of the worst
    case's runs too."""
    spec, tfi, tco, tdir, trow = TNS_STRESS[case]()
    want = SYN.tns_scan_torch(*_t(spec.copy(), tfi, tco, tdir, trow))
    got = tns_kernel_model(spec, tfi, tco, tdir, trow, long=long)
    _tns_gate(got, want.numpy(), (spec, tfi, tco, tdir, trow))
    inside = np.where(trow < spec.shape[0], trow, -1)
    live = inside[inside >= 0]
    np.testing.assert_array_equal(np.delete(got, live, 0),
                                  np.delete(spec, live, 0))


def test_tns_long_runs_fall_on_both_sides_of_the_gate():
    """long_near_unit's 1024-bin runs are cut; two of them pass the gate on
    phi and two are walked whole, so the card's stress test runs both."""
    _, _, tco, _, _ = _tns_long_near_unit()
    a = tco[:, 0]
    g = np.stack(_walk([np.zeros(32, np.float32)] * len(a), a,
                       np.eye(12, dtype=np.float32)[[0] * len(a)]))
    norms = np.abs(_pass_maps(a, g, 32)).sum(2).max(1)
    assert (norms <= 4.0).sum() == 2 and (norms > 4.0).sum() == 2, norms


def _tns_encoder_limits(seed):
    """chip_smoke.py's encoder-limit pool (``tns_encoder_limits``): 4
    1024-bin runs of order 12, up and down, whose 12 quantised reflection
    coefficients all sit at the encoder's limits (magnitudes 7, 4, then 2
    as they shrink with the tap; signs drawn from the seed): the filters of
    the largest gain an encoder emits."""
    return chip_smoke.tns_encoder_limits(seed)


TNS_LIMIT_SEEDS = range(100, 106)


def _row_errs(got, ref, rows):
    """|got - ref| over each row's peak of ref, row by row."""
    return np.array([np.abs(got[r].astype(np.float64) - ref[r]).max()
                     / np.abs(ref[r]).max() for r in rows])


def _nearer_than_plain(got, plain, ref, rows):
    """got is within 1e-5 of each row's peak of the float64 reference ref,
    and wherever it is more than 1e-5 from the plain version, the plain
    version is the further of the two from ref (chip_smoke.py's
    ``tns_gate``)."""
    k_err, p_err, bad = chip_smoke.tns_gate(got, plain, ref, rows)
    assert not bad, (bad, k_err, p_err)


@pytest.mark.parametrize("seed", TNS_LIMIT_SEEDS)
def test_tns_at_encoder_limits_against_f64(seed):
    """At the encoder's limits the float32 model of csrc/tns.cu stays within
    1e-5 of each row's peak of the float64 reference, and where it is more
    than 1e-5 from tns_scan_torch, tns_scan_torch is the one further from
    the reference (seed 100: 1.12e-5 against the model's 4.8e-6)."""
    spec, tfi, tco, tdir, trow = _tns_encoder_limits(seed)
    ref = SYN.apply_tns_zz_reference(spec.astype(np.float64), tfi, tco,
                                     tdir, trow)
    plain = SYN.tns_scan_torch(*_t(spec.copy(), tfi, tco, tdir,
                                   trow)).numpy()
    _nearer_than_plain(tns_kernel_model(spec, tfi, tco, tdir, trow), plain,
                       ref, trow)


def test_tns_gate_keeps_encoder_limit_runs_in_bound():
    """Cut into chunks with no gate on phi, some encoder-limit run leaves
    1e-5 of its row's peak of the float64 reference (phi's row sums reach
    4-48 there and grow the error of the state passed along); behind the
    gate none does."""
    worst = {}
    for gate in (np.inf, 4.0):
        errs = []
        for seed in TNS_LIMIT_SEEDS:
            spec, tfi, tco, tdir, trow = _tns_encoder_limits(seed)
            ref = SYN.apply_tns_zz_reference(spec.astype(np.float64), tfi,
                                             tco, tdir, trow)
            errs.append(_row_errs(tns_kernel_model(spec, tfi, tco, tdir, trow,
                                                   gate=gate), ref,
                                  trow).max())
        worst[gate] = max(errs)
    assert worst[np.inf] > 1e-5 >= worst[4.0], worst


def test_jax_tns_scan_drift_at_encoder_limits():
    """How far the JAX package's _tns_scan_device drifts from the float64
    reference on the encoder-limit filters (seeds 100-105): within 1e-5 of
    each row's peak (6.05e-6 measured, seed 100, where tns_scan_torch
    drifts 1.12e-5).  Through the long IMDCT the spectra's differences stay
    inside the 0.5 PCM gate between the port and JAX
    (test_decode_chunk_zz_matches_jax_and_f64): JAX against float64, and
    tns_scan_torch and the kernel's model against JAX (0.159, 0.415 and
    0.207 measured)."""
    import jax.numpy as jnp
    J = _jsyn()
    imdct = SYN._imdct_matrix(2048).astype(np.float64)
    rel, pcm = [], {"jax_f64": [], "plain_jax": [], "model_jax": []}
    for seed in TNS_LIMIT_SEEDS:
        spec, tfi, tco, tdir, trow = _tns_encoder_limits(seed)
        ref = SYN.apply_tns_zz_reference(spec.astype(np.float64), tfi, tco,
                                         tdir, trow)
        jx = np.asarray(J.apply_tns_zz(*(jnp.asarray(a) for a in (
            spec, tfi, tco, tdir, trow)))).astype(np.float64)
        plain = SYN.tns_scan_torch(*_t(spec.copy(), tfi, tco, tdir, trow)) \
            .numpy().astype(np.float64)
        model = tns_kernel_model(spec, tfi, tco, tdir, trow) \
            .astype(np.float64)
        rel.append(_row_errs(jx, ref, trow).max())
        for key, d in (("jax_f64", jx - ref), ("plain_jax", plain - jx),
                       ("model_jax", model - jx)):
            pcm[key].append(np.abs(d @ imdct).max())
    assert max(rel) <= 1e-5, rel
    assert all(max(v) <= 0.5 for v in pcm.values()), pcm


def _tns_past_float32(seed=22):
    """1024-bin runs of order 12, up and down, with the two sign patterns
    of _tns_long_near_unit's limits that no float32 walk follows: every
    reflection coefficient positive (7, 4, then 2), and -8 then signs
    alternating from +4."""
    rng = np.random.default_rng(seed)
    tfi, tco, tdir, trow, TB = _pool(4)
    tfi[:] = 1
    tdir[1::2, 0] = 1
    lim = np.minimum(7, 8 >> np.minimum(np.arange(12), 2))
    alt = np.r_[-1, (-1) ** np.arange(11)]
    for j, sign in enumerate((1, 1, alt, alt)):
        qc = sign * lim
        qc[0] = 7 if qc[0] > 0 else -8
        tco[j, 0] = _encoder_coeffs(rng, qc=qc)
    spec = (rng.standard_normal((TB, 1024)) * 3000).astype(np.float32)
    return spec, tfi, tco, tdir, trow


def test_tns_float32_walks_leave_the_gate_past_float32():
    """The open question of the TNS gate, kept in view: on the sign patterns
    _tns_past_float32 makes, tns_scan_torch and the kernel's model both
    drift 1e-5 to 1e-4 of each row's peak from the float64 reference
    (2.6-5.1e-5 and 3.6-4.4e-5 measured), past the gate's 1e-5, so the gate
    would fail such content if an encoder emitted it."""
    spec, tfi, tco, tdir, trow = _tns_past_float32()
    ref = SYN.apply_tns_zz_reference(spec.astype(np.float64), tfi, tco,
                                     tdir, trow)
    plain = SYN.tns_scan_torch(*_t(spec.copy(), tfi, tco, tdir,
                                   trow)).numpy()
    model = tns_kernel_model(spec, tfi, tco, tdir, trow)
    for got in (plain, model):
        errs = _row_errs(got, ref, trow)
        assert ((errs > 1e-5) & (errs < 1e-4)).all(), errs


def test_tns_edge_case_runs():
    """The runs of the edge case, as the ballots find them."""
    _, tfi, _, tdir, _ = _tns_edges()
    j, lo, hi, slot = tns_runs(tfi, tdir)
    got = {(int(a), int(b), int(c), int(d)) for a, b, c, d in
           zip(j, lo, hi, slot)}
    assert {(0, 0, 0, 0), (0, 500, 500, 1), (0, 1023, 1023, 2),
            (0, 499, 499, 3), (0, 501, 501, 3), (1, 100, 199, 4),
            (1, 300, 399, 4), (1, 200, 299, 5), (2, 200, 299, 6),
            (2, 300, 450, 7), (2, 600, 699, 8), (3, 400, 799, 10)} == got


def test_tns_scan_rejects_unknown_device_and_kernel_rejects_cpu():
    spec, tfi, tco, tdir, trow = _synthetic_pool(5, P=4, TB=8, npad=1)
    with pytest.raises(ValueError, match="no kernel"):
        SYN.tns_scan(*_t(spec, tfi, tco, tdir, trow, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        _kernels.tns(*_t(spec, tfi, tco, tdir, trow))


# --- decode_chunk_zz: against JAX and the f64 reference --------------------

def _zz_planes(G, with_pool):
    """One stream's first G frames on the zigzag wire, with TNS rows on the
    TnsPool or (without it) on the host-prepared side plane; escapes as
    (row, pos, val) triples."""
    native = aac_native()
    n, _, b = _parse(G)
    q4 = np.zeros((G, NCH, 512), np.uint8)
    sfb = np.zeros((G, NCH, 64), np.uint8)
    msb = np.zeros((G, NCH // 2, 128), np.uint8)
    opx = np.zeros((G, NCH), np.uint8)
    esc = native.EscapeList(8192)
    ssf = native.ShortSfPool(G * NCH)
    tns = native.TnsPool(G * NCH) if with_pool else None
    special = native.aac_prepare_rows_zz(
        b, n, G, NCH, np.zeros(NCH, np.int32), esc, ssf, q4=q4, sfb=sfb,
        msb=msb, opx=opx, col0=0, max_special=G * NCH, tns=tns)
    assert special is not None
    side = np.zeros((max(1, len(special)), 1024), np.float32)
    srow = np.full(len(side), -1, np.int32)
    if len(special):
        _side_rows(b, special, NCH, NCH, 0, side, srow, 0)
    planes = [q4, sfb, ssf.sf, ssf.row, msb, opx, esc.row, esc.pos, esc.val,
              side, srow]
    tns_planes = [tns.tfi, tns.tco, tns.tdir, tns.row] if with_pool else []
    overlap = (np.random.default_rng(G).standard_normal((NCH, 1024))
               * 300).astype(np.float32)
    return planes, overlap, tns_planes, b["rate_index"]


@pytest.mark.parametrize("G", [16, 64])
@pytest.mark.parametrize("with_pool", [False, True])
def test_decode_chunk_zz_matches_jax_and_f64(G, with_pool):
    import jax
    import jax.numpy as jnp
    J = _jsyn()
    planes, overlap, tns_planes, ri = _zz_planes(G, with_pool)
    if with_pool:
        assert (tns_planes[3] >= 0).sum() >= 4
    consts = SYN.device_constants(ri, device="cpu")
    pcm, ov = SYN.decode_chunk_zz(*_t(*planes, overlap), *consts,
                                  *_t(*tns_planes))
    jconsts = [jnp.asarray(c.numpy()) for c in consts]
    want, want_ov = jax.jit(J.decode_chunk_zz)(
        *(jnp.asarray(a) for a in planes), jnp.asarray(overlap), *jconsts,
        *(jnp.asarray(a) for a in tns_planes))
    bound = 0.5 if with_pool else 0.05
    np.testing.assert_allclose(pcm.numpy(), np.asarray(want), atol=bound,
                               rtol=0)
    np.testing.assert_allclose(ov.numpy(), np.asarray(want_ov), atol=bound,
                               rtol=0)
    ref, ref_ov = SYN.decode_chunk_zz_reference(
        *planes, overlap, consts[-1].numpy(), *tns_planes)
    d = pcm.numpy() - ref
    assert float(np.sqrt((d ** 2).mean())) <= 0.25
    assert float(np.abs(d).max()) <= 1.0
    assert float(np.abs(ov.numpy() - ref_ov).max()) <= 1.0
    # the port's f64 reference is the JAX package's
    jref, _ = J.decode_chunk_zz_reference(*planes, overlap,
                                          consts[-1].numpy(), *tns_planes)
    np.testing.assert_array_equal(ref, jref)


def test_decode_chunk_zz_packed_escapes_match_triples():
    planes, overlap, tns_planes, ri = _zz_planes(16, True)
    consts = SYN.device_constants(ri, device="cpu")
    pcm, _ = SYN.decode_chunk_zz(*_t(*planes, overlap), *consts,
                                 *_t(*tns_planes))
    esc_row, esc_pos = planes[6], planes[7]
    packed = np.where(esc_row >= 0, esc_row * 1024 + esc_pos, -1)
    planes_p = planes[:6] + [packed, None] + planes[8:]
    ts = [None if a is None else torch.from_numpy(a) for a in planes_p]
    pcm_p, _ = SYN.decode_chunk_zz(*ts, *_t(overlap), *consts,
                                   *_t(*tns_planes))
    assert torch.equal(pcm, pcm_p)


# --- filterbank_fast and dequant_filterbank --------------------------------

def test_filterbank_fast_matches_jax():
    import jax.numpy as jnp
    J = _jsyn()
    n, _, b = _parse(24)
    specs, opidx = SYN.prepare_group(b, n, NCH, np.zeros(NCH, np.int32))
    overlap = (np.random.default_rng(1).standard_normal((NCH, 1024))
               * 100).astype(np.float32)
    W, SW = SYN.window_bank()
    consts = [SYN._imdct_matrix(2048), SYN._imdct_matrix(256), W, SW]
    pcm, ov = SYN.filterbank_fast(*_t(specs, opidx, overlap, *consts))
    want, want_ov = J.filterbank_fast(*(jnp.asarray(a) for a in
                                        (specs, opidx, overlap, *consts)))
    np.testing.assert_allclose(pcm.numpy(), np.asarray(want), atol=0.05,
                               rtol=0)
    np.testing.assert_allclose(ov.numpy(), np.asarray(want_ov), atol=0.05,
                               rtol=0)


def test_dequant_filterbank_matches_jax():
    import jax.numpy as jnp
    from ohpipeline_tpu_torch.codecs import aac

    J = _jsyn()
    n, _, b = _parse(32)
    prep = aac.prepare_device_group(b, n, NCH, np.zeros(NCH, np.int32))
    perm, band = aac.cfg_tables(prep["cfg_map"])
    W, SW = SYN.window_bank()
    args = [prep["quant"], prep["sf"], prep["coded"], prep["cfg_idx"], perm,
            band, prep["ms_flag"], prep["side_spec"], prep["side_row"],
            prep["opidx"], np.zeros((NCH, 1024), np.float32),
            SYN._imdct_matrix(2048), SYN._imdct_matrix(256), W, SW]
    pcm, ov = SYN.dequant_filterbank(*_t(*args))
    want, want_ov = J.dequant_filterbank(*(jnp.asarray(a) for a in args))
    np.testing.assert_allclose(pcm.numpy(), np.asarray(want), atol=0.05,
                               rtol=0)
    np.testing.assert_allclose(ov.numpy(), np.asarray(want_ov), atol=0.05,
                               rtol=0)


# --- the card --------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("case", list(TNS_CASES))
def test_tns_kernel_matches_plain_on_card(case, cuda):
    spec, tfi, tco, tdir, trow = TNS_CASES[case]()
    args = _t(spec, tfi, tco, tdir, trow, device=cuda)
    before = _kernels.launches["tns"]
    got = SYN.apply_tns_zz(*args)
    torch.cuda.synchronize()
    assert _kernels.launches["tns"] == before + 1
    want = SYN.tns_scan_torch(args[0].clone(), *args[1:])
    _tns_close(got.cpu().numpy(), want.cpu().numpy().astype(np.float64),
               trow)
    ref = SYN.apply_tns_zz_reference(spec.astype(np.float64), tfi, tco,
                                     tdir, trow)
    _tns_close(got.cpu().numpy(), ref, trow)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(TNS_STRESS))
def test_tns_kernel_matches_plain_on_card_stress(case, cuda):
    spec, tfi, tco, tdir, trow = TNS_STRESS[case]()
    args = _t(spec, tfi, tco, tdir, trow, device=cuda)
    before = _kernels.launches["tns"]
    got = SYN.apply_tns_zz(*args)
    torch.cuda.synchronize()
    assert _kernels.launches["tns"] == before + 1
    want = SYN.tns_scan_torch(args[0].clone(), *args[1:])
    _tns_gate(got.cpu().numpy(), want.cpu().numpy(),
              (spec, tfi, tco, tdir, trow))
    inside = np.where(trow < spec.shape[0], trow, -1)
    live = inside[inside >= 0]
    np.testing.assert_array_equal(np.delete(got.cpu().numpy(), live, 0),
                                  np.delete(spec, live, 0))


@pytest.mark.gpu
@pytest.mark.parametrize("seed", TNS_LIMIT_SEEDS)
def test_tns_kernel_at_encoder_limits_on_card(seed, cuda):
    """The kernel holds the encoder-limit filters to the float64 reference
    as its model does (test_tns_at_encoder_limits_against_f64)."""
    spec, tfi, tco, tdir, trow = _tns_encoder_limits(seed)
    args = _t(spec, tfi, tco, tdir, trow, device=cuda)
    before = _kernels.launches["tns"]
    got = SYN.apply_tns_zz(*args)
    torch.cuda.synchronize()
    assert _kernels.launches["tns"] == before + 1
    plain = SYN.tns_scan_torch(args[0].clone(), *args[1:])
    ref = SYN.apply_tns_zz_reference(spec.astype(np.float64), tfi, tco,
                                     tdir, trow)
    _nearer_than_plain(got.cpu().numpy(), plain.cpu().numpy(), ref, trow)


@pytest.mark.gpu
@pytest.mark.parametrize("with_pool", [False, True])
def test_decode_chunk_zz_on_card_meets_f64(with_pool, cuda):
    planes, overlap, tns_planes, ri = _zz_planes(64, with_pool)
    consts = SYN.device_constants(ri, device=cuda)
    pcm, _ = SYN.decode_chunk_zz(*_t(*planes, overlap, device=cuda), *consts,
                                 *_t(*tns_planes, device=cuda))
    ref, _ = SYN.decode_chunk_zz_reference(*planes, overlap,
                                           consts[-1].cpu().numpy(),
                                           *tns_planes)
    d = pcm.cpu().numpy() - ref
    assert float(np.sqrt((d ** 2).mean())) <= 0.25
    assert float(np.abs(d).max()) <= 1.0
