"""The HE-AAC serving call's native SBR chain (``codecs/aac/sbr_chain.py``
over ``host/native/sbr_chain.cc``) against the Python chain it replaces
there, ``sbr_chain.sbr_frames`` and ``SbrDeviceRunner._build_stacked_cond``
over ``SbrDecoder`` objects: group after group, the stacked cond planes are
equal bit for bit, every ``SbrFrameCond`` key of every channel, and so are
each channel's host state and each stream's delta-coding state after the
group.

Content: ``tests/assets/dryrun_he.aac`` (46 stereo frames, coupled and
uncoupled, an SBR header every 10 frames) whole, and streams joining its
header-led segments in several orders (as ``ohp_bench/content/he_aac.py``
draws them), in groups of 48, 16 and 7 frames, so that group borders fall
inside segments.  The asset's header turns envelope smoothing off and its
payloads carry no CRC, so two rewrites of its payloads reach what it does
not: every header given ``bs_smoothing_mode`` 0 (the smoothing ratios),
and every payload a 10-bit CRC field.  Payloads with a bit flipped, or
cut short, are decoded by both chains: the two give the same planes or
raise the same error, or the native chain raises ``ValueError`` on a group
the Python chain takes (a header change inside a stream's first group, a
level outside the dequantisation tables, a grid with too few borders).
Each of those three has its own case."""

import pathlib
import re

import numpy as np
import pytest

from ohpipeline_tpu_torch import _host
from ohpipeline_tpu_torch.codecs.aac import sbr as sbrd
from ohpipeline_tpu_torch.codecs.aac import sbr_chain, serving
from ohpipeline_tpu_torch.host import native

DATA = (pathlib.Path(__file__).resolve().parent / "assets"
        / "dryrun_he.aac").read_bytes()
NCH = 2
RATE = 22050
#: The asset's header-led segments (first, end frame).
SEGMENTS = ((0, 10), (10, 20), (20, 30), (30, 40), (40, 46))


def _frames() -> list:
    out, pos = [], 0
    while (h := _host.aac_bitstream.parse_adts_header(DATA, pos)) \
            is not None:
        out.append(DATA[pos:pos + h.frame_bytes])
        pos += h.frame_bytes
    return out


def _joined(*order) -> bytes:
    frames = _frames()
    return b"".join(b"".join(frames[slice(*SEGMENTS[k])]) for k in order)


def _joins() -> list:
    return [_joined(2, 1), _joined(1, 0, 3), _joined(4, 2, 0, 1, 3),
            _joined(3, 4, 1, 2)]


# -- payload rewrites, at the bit level ------------------------------------

def _bits(pl, f) -> np.ndarray:
    nb = int(pl.nbits[f])
    return np.unpackbits(pl.bytes[f])[:nb].copy()


def _rebuilt(pl, rows: dict, crc=None):
    """``pl`` with frame f's bits replaced by rows[f] (None: no payload)."""
    data, nbits = pl.bytes.copy(), pl.nbits.copy()
    for f, bits in rows.items():
        data[f] = 0
        if bits is None:
            nbits[f] = 0
            continue
        packed = np.packbits(bits)
        data[f, :len(packed)] = packed
        nbits[f] = len(bits)
    return sbr_chain.SbrPayloads(data, nbits,
                                 pl.crc.copy() if crc is None else crc)


def _header_at(pl, f) -> int:
    """Bit of frame f's header flag."""
    return 10 if pl.crc[f] else 0


def _smoothing_on(s, gi, pl):
    """Every header given extra2 fields with bs_smoothing_mode 0."""
    rows = {}
    for f in range(len(pl)):
        bits = _bits(pl, f)
        h = _header_at(pl, f)
        if not bits[h]:
            continue
        assert bits[h + 16] == 0            # the asset's headers lack extra2
        at = h + 17 + (5 if bits[h + 15] else 0)
        bits[h + 16] = 1
        rows[f] = np.concatenate([bits[:at], [1, 0, 1, 0, 1, 0], bits[at:]])
    return _rebuilt(pl, rows)


def _with_crc(s, gi, pl):
    """A 10-bit CRC field ahead of every payload (the parse skips it)."""
    rows = {f: np.concatenate([np.unpackbits(np.array([0xA5 ^ f],
                                                      np.uint8))[:2],
                               np.ones(8, np.uint8), _bits(pl, f)])
            for f in range(len(pl))}
    return _rebuilt(pl, rows, crc=np.ones(len(pl), np.int32))


def _flips(seed):
    """One bit flipped in one frame of a third of the streams' groups, as
    the seed draws them."""
    rng = np.random.default_rng(seed)

    def edit(s, gi, pl):
        if rng.random() > 1 / 3:
            return pl
        f = int(rng.integers(len(pl)))
        bits = _bits(pl, f)
        bits[int(rng.integers(len(bits)))] ^= 1
        return _rebuilt(pl, {f: bits})
    return edit


def _cuts(seed):
    rng = np.random.default_rng(seed)

    def edit(s, gi, pl):
        f = int(rng.integers(len(pl)))
        bits = _bits(pl, f)
        return _rebuilt(pl, {f: bits[:int(rng.integers(1, len(bits) // 2))]})
    return edit


# -- the two chains side by side -------------------------------------------

def _outcome(fn):
    try:
        return fn(), None
    except (ValueError, IndexError) as e:
        return None, (type(e), str(e))


def _prev_equal(a, b) -> bool:
    for x, y in zip(a[:2], b[:2]):
        if (x is None) != (y is None):
            return False
        if x is not None and not (np.array_equal(x[0], y[0])
                                  and x[1] == y[1]
                                  and np.array_equal(x[2], y[2])):
            return False
    return True


#: The native chain's own errors, on a group the Python chain takes.
NATIVE_ONLY = re.compile(r"stream (\d+): SBR group outside the serving "
                         r"chain|device batch needs one SBR header config")


def _native_only(err, parsed: list, decs_py: list, chain) -> None:
    """``err`` is one of the native chain's own errors, raised on a stream
    whose group the Python chain parsed."""
    m = NATIVE_ONLY.fullmatch(err[1])
    assert err[0] is ValueError and m, err
    if m.group(1) is not None:
        assert int(m.group(1)) in parsed, err
    else:
        assert any(decs_py[s].header != chain.header for s in parsed), err


def run_both(streams: list, G: int, edit=None) -> dict:
    """Both chains over ``streams`` in groups of G, as
    ``decode_he_streams_device`` runs them (the batch header from the first
    launch on), compared after every group.  ``edit(s, g, payloads)``
    rewrites stream s's payloads of group g.  Returns what happened: the
    groups compared, and the error both raised, or (``native_only``) the
    native chain's own on a group the Python chain parsed."""
    _host.sbr_native()
    C = len(streams) * NCH
    decs_py = [_host.aac_sbr.SbrDecoder(RATE) for _ in streams]
    chain = sbr_chain.SbrChain(len(streams), NCH, RATE)
    ref = static = state = None
    hdr0 = None
    groups = 0
    for gi, (planes, counts) in enumerate(
            serving.iter_groups(streams, G, sbr=True)):
        pls = planes["sbr"] if edit is None else \
            [edit(s, gi, pl) for (s, _), pl in zip(counts, planes["sbr"])]
        parsed = []

        def python_side():
            per_ch = [([], [], []) for _ in range(C)]
            for (s, _), pl in zip(counts, pls):
                sbr_chain.sbr_frames(decs_py[s], s, pl, NCH, hdr0,
                                     per_ch[s * NCH:(s + 1) * NCH])
                parsed.append(s)
            if hdr0 is None:            # the serving call's first launch
                lead = next(d.header for d in decs_py
                            if d.header is not None)
                if any(d.header not in (None, lead) for d in decs_py):
                    raise ValueError("device batch needs one SBR header "
                                     "config")
            return per_ch

        per_ch, err_py = _outcome(python_side)
        grp, err = _outcome(lambda: chain.parse_group(0, counts, pls, C, G))
        if err is not None and err != err_py:
            _native_only(err, parsed, decs_py, chain)
            return {"groups": groups, "error": err, "native_only": True}
        assert err == err_py, gi
        if err:
            return {"groups": groups, "error": err, "native_only": False}
        for s, d in enumerate(decs_py):
            assert bool(chain.have[s]) == (d.header is not None)
            assert d.header in (None, chain.header)
        if ref is None:
            hdr0 = chain.header
            lead = next(s for s, d in enumerate(decs_py)
                        if d.header is not None)
            ref = sbrd.SbrDeviceRunner(decs_py[lead], C, device="cpu")
            dec = chain.decoder()
            static = sbrd.SbrStatic(dec)
            state = sbr_chain.CondState(C)
        want = ref._build_stacked_cond(C, G, per_ch)
        have = grp.cond(static, state)
        assert list(have) == list(want)
        for k in want:
            assert have[k].dtype == want[k].dtype, k
            assert have[k].shape == want[k].shape, k
            for ch in range(C):
                np.testing.assert_array_equal(
                    have[k][ch].view(np.uint8), want[k][ch].view(np.uint8),
                    err_msg=f"group {gi}, {k}, channel {ch}")
        for ch, st in enumerate(ref.state_host):
            np.testing.assert_array_equal(state.prev_invf[ch], st.prev_invf)
            np.testing.assert_array_equal(state.bw[ch].view(np.uint64),
                                          st.bw.view(np.uint64))
            assert int(state.noise_index[ch]) == st.noise_index
            assert int(state.sine_index[ch]) == st.sine_index
            assert set(np.flatnonzero(state.prev_harm[ch])) \
                == st.prev_harm_bins
            assert int(state.prev_tran[ch]) == st.prev_tran_env
            assert bool(state.first[ch]) == ref.first[ch]
        for s, d in enumerate(decs_py):
            assert _prev_equal(chain.parse_prev(s),
                               getattr(d, "_parse_prev", [None, None])), s
        groups += 1
    return {"groups": groups, "error": None, "native_only": False}


CASES = {"asset": (lambda: [DATA], None),
         "joins": (_joins, None),
         "smoothing": (_joins, _smoothing_on),
         "crc": (lambda: [DATA] + _joins()[:2], _with_crc)}


@pytest.mark.parametrize("G", [48, 16, 7])
@pytest.mark.parametrize("case", sorted(CASES))
def test_native_chain_equals_the_python_chain(case, G):
    streams, edit = CASES[case]
    out = run_both(streams(), G, edit)
    assert out["error"] is None
    assert out["groups"] >= (1 if G == 48 else 2)


def _cond(chain, grp, C: int) -> dict:
    """``grp``'s cond planes from a new block of C channels."""
    dec = chain.decoder()
    static = sbrd.SbrStatic(dec)
    return grp.cond(static, sbr_chain.CondState(C))


def test_cases_reach_what_they_name():
    """The asset codes coupled and uncoupled frames; the rewrites give
    smoothing ratios and CRC fields that both chains read."""
    _host.sbr_native()
    n, _, b = _host.aac_native().aac_parse_group_sbr(
        DATA, 0, channels=NCH, max_frames=64)
    dec = _host.aac_sbr.SbrDecoder(RATE)
    coupled = [dec.parse_payload(*b["sbr"][f][:2], stereo=True,
                                 crc=b["sbr"][f][2])[1] for f in range(n)]
    assert any(coupled) and not all(coupled)
    planes, counts = next(serving.iter_groups(_joins(), 16, sbr=True))
    pls = [_smoothing_on(s, 0, pl) for (s, _), pl in zip(counts,
                                                         planes["sbr"])]
    C = len(counts) * NCH
    chain = sbr_chain.SbrChain(len(counts), NCH, RATE)
    grp = chain.parse_group(0, counts, pls, C, 16)
    assert chain.header.smoothing_mode == 0
    assert _cond(chain, grp, C)["r"].any()
    crc = _with_crc(0, 0, planes["sbr"][0])
    assert crc.crc.all() and (crc.nbits == planes["sbr"][0].nbits + 10).all()


#: Seeds whose rewrite the native chain alone raises on (a group the
#: Python chain takes).
FLIPS_NATIVE_ONLY: set = set()
CUTS_NATIVE_ONLY: set = set()


@pytest.mark.parametrize("seed", range(12))
def test_flipped_bits_match_or_fall_back(seed):
    """The chains match, or raise alike, or the native chain alone raises
    ``ValueError`` (on the seeds of ``FLIPS_NATIVE_ONLY``); nothing falls
    back."""
    out = run_both(_joins(), 16, _flips(seed))
    assert out["native_only"] == (seed in FLIPS_NATIVE_ONLY)


@pytest.mark.parametrize("seed", range(4))
def test_cut_payloads_match_or_fall_back(seed):
    """A cut payload raises alike in both chains, or in the native chain
    alone on the seeds of ``CUTS_NATIVE_ONLY``; nothing falls back."""
    out = run_both(_joins(), 16, _cuts(seed))
    assert out["error"] is not None
    assert out["native_only"] == (seed in CUTS_NATIVE_ONLY)


def test_fuzzed_payloads_reach_both_outcomes():
    """Over the flips, some groups still parse and are compared, and some
    fail in both chains."""
    outs = [run_both(_joins(), 16, _flips(seed)) for seed in range(12)]
    assert any(o["error"] is None for o in outs)
    assert any(o["error"] is not None and not o["native_only"]
               for o in outs)
    assert sum(o["groups"] for o in outs) >= 8


# -- groups the Python chain takes and the native chain raises on -----------

def _smoothing_at(f: int):
    """Frame f of the first group given a header with smoothing, the
    others kept."""
    def edit(s, gi, pl):
        return pl if gi else _rebuilt(pl, {f: _bits(_smoothing_on(s, gi, pl),
                                                    f)})
    return edit


def _short_grid(s, gi, pl):
    """Frame 2 (coupled, four envelopes) given a VARVAR grid of four
    envelopes whose border sets meet at slot 8: four borders, not five.
    The fields after the grid read as before."""
    if gi:
        return pl
    bits = _bits(pl, 2)
    b = _host.aac_sbr.Bits(pl[2][0], 0, int(pl.nbits[2]))
    assert b.read(1) == 0 and b.read(1) == 0 and b.read(1) == 1
    at = b.pos
    assert _host.aac_sbr.parse_grid(b).n_env == 4
    # class 3, bord0 0, bord1 0, nrel0 2, nrel1 1, rel0 4 4, rel1 8,
    # pointer 0, freq_res 1 0 0 1
    grid = [1, 1, 0, 0, 0, 0, 1, 0, 0, 1, 0, 1, 0, 1, 1, 1, 0, 0, 0,
            1, 0, 0, 1]
    return _rebuilt(pl, {2: np.concatenate([bits[:at], grid,
                                            bits[b.pos:]])})


def _header_change_in_first_group():
    """The header of frame 10 of 46 given smoothing, all in one group: the
    stream ends on the call's header, and the Python chain holds a stream
    to that header only from the first launch on."""
    out = run_both([DATA], 48, _smoothing_at(10))
    assert out["native_only"]
    return out["error"]


def _level_off_the_tables():
    """Stream 0's channel-0 envelope row set to the tables' top level
    before frame 3, whose first envelope is coded in time against it: a
    level lands on 512, outside the tables, which the Python chain raises
    to the power of two."""
    _host.sbr_native()
    chain = sbr_chain.SbrChain(1, NCH, RATE)
    (p0, c0), (p1, c1) = list(serving.iter_groups([DATA], 3, sbr=True))[:2]
    chain.parse_group(0, c0, p0["sbr"], NCH, 3)
    top = native._SBR_LEVELS - 1
    chain.pstate[0, :chain.pstate[0, sbr_chain._P_LEN]] = top
    dec = chain.decoder()
    dec._parse_prev, dec._ps_prev = chain.parse_prev(0), None
    per_ch = [([], [], []) for _ in range(NCH)]
    sbr_chain.sbr_frames(dec, 0, p1["sbr"][0], NCH, chain.header, per_ch)
    assert per_ch[0][0][0].env[0].max() == top + 1
    return _outcome(lambda: chain.parse_group(0, c1, p1["sbr"], NCH, 3))[1]


def _grid_short_of_borders():
    """``_short_grid``: the Python chain parses the group and its cond
    build then indexes past the borders."""
    _host.sbr_native()
    planes, counts = next(serving.iter_groups([DATA], 16, sbr=True))
    dec = _host.aac_sbr.SbrDecoder(RATE)
    per_ch = [([], [], []) for _ in range(NCH)]
    sbr_chain.sbr_frames(dec, 0, _short_grid(0, 0, planes["sbr"][0]), NCH,
                         None, per_ch)
    with pytest.raises(IndexError):
        sbrd.SbrDeviceRunner(dec, NCH, device="cpu")._build_stacked_cond(
            NCH, 16, per_ch)
    out = run_both([DATA], 16, _short_grid)
    assert out["native_only"]
    return out["error"]


MALFORMED = {"header_change_in_first_group": _header_change_in_first_group,
             "level_off_the_tables": _level_off_the_tables,
             "grid_short_of_borders": _grid_short_of_borders}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_groups_the_python_chain_takes_raise(case):
    """Three malformed groups the Python chain decodes, or fails on at
    launch with ``IndexError``, raise ``ValueError`` when parsed."""
    assert MALFORMED[case]() == (
        ValueError, "stream 0: SBR group outside the serving chain")
