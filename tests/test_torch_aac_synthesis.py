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
to its plain version on the card."""

import pathlib

import numpy as np
import pytest
import torch

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
