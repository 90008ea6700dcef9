"""The HE-AAC serving call's native SBR chain (``codecs/aac/sbr_chain.py``
over ``host/native/sbr_chain.cc``) against the Python chain it replaces
there, ``serving._sbr_frames`` and ``SbrDeviceRunner._build_stacked_cond``
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
cut short, are decoded by both chains: the native one either matches or
hands the stream's group to the Python chain, and the two then raise the
same error or give the same planes.  Groups the native chain is made to
decline hand the state across in both directions."""

import pathlib

import numpy as np
import pytest

from ohpipeline_tpu_torch import _host, tracing
from ohpipeline_tpu_torch.codecs.aac import sbr as sbrd
from ohpipeline_tpu_torch.codecs.aac import sbr_chain, serving

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


def run_both(streams: list, G: int, edit=None, decline=None) -> dict:
    """Both chains over ``streams`` in groups of G, as
    ``decode_he_streams_device`` runs them (the batch header from the first
    launch on), compared after every group.  ``edit(s, g, payloads)``
    rewrites stream s's payloads of group g; ``decline(s, g)`` makes the
    native chain hand that group to the Python chain.  Returns what
    happened: the groups, the fallbacks, the error both raised."""
    _host.sbr_native()
    C = len(streams) * NCH
    decs_py = [_host.aac_sbr.SbrDecoder(RATE) for _ in streams]
    decs = [_host.aac_sbr.SbrDecoder(RATE) for _ in streams]
    chain = sbr_chain.SbrChain(decs, NCH, serving._sbr_frames)
    if decline is not None:
        parse, group_of = chain._parse, [0]

        def _parse(g, pl, grp, col, G_):
            return not decline(g, group_of[0]) and parse(g, pl, grp, col, G_)
        chain._parse = _parse
    before = tracing.snapshot().get("fallback.sbr", 0)
    ref = got = None
    hdr0 = None
    groups = 0
    for gi, (planes, counts) in enumerate(
            serving.iter_groups(streams, G, sbr=True)):
        pls = planes["sbr"] if edit is None else \
            [edit(s, gi, pl) for (s, _), pl in zip(counts, planes["sbr"])]

        def python_side():
            per_ch = [([], [], []) for _ in range(C)]
            for (s, _), pl in zip(counts, pls):
                serving._sbr_frames(decs_py[s], s, pl, NCH, hdr0,
                                    per_ch[s * NCH:(s + 1) * NCH])
            return per_ch

        if decline is not None:
            group_of[0] = gi
        per_ch, err_py = _outcome(python_side)
        grp, err = _outcome(lambda: chain.parse_group(0, counts, pls, C, G,
                                                      hdr0))
        assert err == err_py, gi
        if err:
            return {"groups": groups, "error": err,
                    "fallbacks": tracing.snapshot()["fallback.sbr"] - before}
        for a, b in zip(decs_py, decs):
            assert a.header == b.header
        if ref is None:
            lead = next(s for s, d in enumerate(decs_py)
                        if d.header is not None)
            hdr0 = decs_py[lead].header
            if any(d.header is not None and d.header != hdr0
                   for d in decs_py):
                return {"groups": groups, "error": "one header config",
                        "fallbacks": None}
            chain.set_header(hdr0, decs[lead].ft)
            ref = sbrd.SbrDeviceRunner(decs_py[lead], C, device="cpu")
            got = sbrd.SbrDeviceRunner(decs[lead], C, device="cpu")
        want, err_py = _outcome(lambda: ref._build_stacked_cond(C, G, per_ch))
        have, err = _outcome(lambda: grp.cond(got, G))
        assert err == err_py, gi
        if err:
            return {"groups": groups, "error": err,
                    "fallbacks": tracing.snapshot()["fallback.sbr"] - before}
        assert list(have) == list(want)
        for k in want:
            assert have[k].dtype == want[k].dtype, k
            assert have[k].shape == want[k].shape, k
            for ch in range(C):
                np.testing.assert_array_equal(
                    have[k][ch].view(np.uint8), want[k][ch].view(np.uint8),
                    err_msg=f"group {gi}, {k}, channel {ch}")
        cs = got.cond_state
        for ch, st in enumerate(ref.state_host):
            np.testing.assert_array_equal(cs.prev_invf[ch], st.prev_invf)
            np.testing.assert_array_equal(cs.bw[ch].view(np.uint64),
                                          st.bw.view(np.uint64))
            assert int(cs.noise_index[ch]) == st.noise_index
            assert int(cs.sine_index[ch]) == st.sine_index
            assert set(np.flatnonzero(cs.prev_harm[ch])) \
                == st.prev_harm_bins
            assert int(cs.prev_tran[ch]) == st.prev_tran_env
            assert bool(cs.first[ch]) == ref.first[ch]
        for s, d in enumerate(decs_py):
            assert _prev_equal(chain.parse_prev(s),
                               getattr(d, "_parse_prev", [None, None])), s
        groups += 1
    return {"groups": groups, "error": None,
            "fallbacks": tracing.snapshot()["fallback.sbr"] - before}


CASES = {"asset": (lambda: [DATA], None),
         "joins": (_joins, None),
         "smoothing": (_joins, _smoothing_on),
         "crc": (lambda: [DATA] + _joins()[:2], _with_crc)}


@pytest.mark.parametrize("G", [48, 16, 7])
@pytest.mark.parametrize("case", sorted(CASES))
def test_native_chain_equals_the_python_chain(case, G):
    streams, edit = CASES[case]
    out = run_both(streams(), G, edit)
    assert out["error"] is None and out["fallbacks"] == 0
    assert out["groups"] >= (1 if G == 48 else 2)


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
    decs = [_host.aac_sbr.SbrDecoder(RATE) for _ in counts]
    chain = sbr_chain.SbrChain(decs, NCH, serving._sbr_frames)
    grp = chain.parse_group(0, counts, pls, len(decs) * NCH, 16, None)
    assert decs[0].header.smoothing_mode == 0
    runner = sbrd.SbrDeviceRunner(decs[0], len(decs) * NCH, device="cpu")
    assert grp.cond(runner, 16)["r"].any()
    crc = _with_crc(0, 0, planes["sbr"][0])
    assert crc.crc.all() and (crc.nbits == planes["sbr"][0].nbits + 10).all()


@pytest.mark.parametrize("seed", range(12))
def test_flipped_bits_match_or_fall_back(seed):
    run_both(_joins(), 16, _flips(seed))


@pytest.mark.parametrize("seed", range(4))
def test_cut_payloads_match_or_fall_back(seed):
    out = run_both(_joins(), 16, _cuts(seed))
    assert out["error"] is not None and out["fallbacks"] >= 1


def test_fuzzed_payloads_reach_both_outcomes():
    """Over the flips, some groups still parse and are compared, and some
    fail in both chains."""
    outs = [run_both(_joins(), 16, _flips(seed)) for seed in range(12)]
    assert any(o["error"] is None for o in outs)
    assert any(o["error"] is not None for o in outs)
    assert sum(o["groups"] for o in outs) >= 8


DECLINES = {"every_other_group": lambda s, g: g % 2 == 0,
            "first_stream_later": lambda s, g: s == 0 and g > 0,
            "scattered": lambda s, g: (3 * s + g) % 4 == 1}


@pytest.mark.parametrize("how", sorted(DECLINES))
def test_declined_groups_hand_the_state_across(how):
    out = run_both(_joins(), 7, decline=DECLINES[how])
    assert out["error"] is None and out["fallbacks"] >= 2


def test_a_group_slices_and_joins_as_the_channel_list_does():
    """``SbrGroup`` is a sequence of channels, as the Python chain's
    per-channel list is: the cond of a reordered group (stream 1's channels
    ahead of stream 0's, one channel of them from the Python chain) equals
    the cond of the list reordered the same way."""
    _host.sbr_native()
    streams = _joins()[:3]
    C = len(streams) * NCH
    planes, counts = next(serving.iter_groups(streams, 16, sbr=True))
    decs_py = [_host.aac_sbr.SbrDecoder(RATE) for _ in streams]
    per_ch = [([], [], []) for _ in range(C)]
    for (s, _), pl in zip(counts, planes["sbr"]):
        serving._sbr_frames(decs_py[s], s, pl, NCH, None,
                            per_ch[s * NCH:(s + 1) * NCH])
    decs = [_host.aac_sbr.SbrDecoder(RATE) for _ in streams]
    chain = sbr_chain.SbrChain(decs, NCH, serving._sbr_frames)
    parse = chain._parse
    chain._parse = lambda g, *a: g != 2 and parse(g, *a)
    grp = chain.parse_group(0, counts, planes["sbr"], C, 16, None)
    assert list(grp.nf) == [16, 16, 16, 16, -1, -1] and len(grp) == C
    order = grp[2:4] + grp[0:2] + grp[4:]
    want = sbrd.SbrDeviceRunner(decs_py[0], C, device="cpu") \
        ._build_stacked_cond(C, 16, per_ch[2:4] + per_ch[0:2] + per_ch[4:])
    have = order.cond(sbrd.SbrDeviceRunner(decs[0], C, device="cpu"), 16)
    for k in want:
        np.testing.assert_array_equal(have[k].view(np.uint8),
                                      want[k].view(np.uint8), err_msg=k)
    assert len(grp[6:]) == 0
