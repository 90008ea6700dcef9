"""The HE-AAC serving call (``decode_he_streams_device``) with its native SBR
chain: ragged streams in groups of 48 and 16 frames, and streams whose
every header was rewritten to smoothing on, are held against
``SbrDecoder.process_frame`` (the numpy float64 chain) fed the core PCM
the call decoded; the counter ``frames.sbr`` counts the asset's frames.
The call's six ``ValueError`` cases raise their exact messages (payloads
rewritten at the bit level where no stream in the repo has the fault),
a logical mesh's blocks give what ``mesh=None`` gives, and the HE cell of
``ohp_bench`` comes out not correct where the host cond state is not
carried across groups."""

import pathlib

import numpy as np
import pytest

from ohpipeline_tpu_torch import _host, parallel, tracing
from ohpipeline_tpu_torch.codecs.aac import sbr as sbrd
from ohpipeline_tpu_torch.codecs.aac import sbr_chain, serving

ASSETS = pathlib.Path(__file__).resolve().parent / "assets"
DATA = (ASSETS / "dryrun_he.aac").read_bytes()
NCH = 2


def _offsets() -> list:
    out, pos = [], 0
    while (h := _host.aac_bitstream.parse_adts_header(DATA, pos)) \
            is not None:
        out.append(pos)
        pos += h.frame_bytes
    return out


def _ragged() -> list:
    """Three streams from header frames 0, 10 and 20, of 46, 82 and 118
    frames, and a fourth of 20: frames 20-29 then 10-19."""
    off = _offsets() + [len(DATA)]
    return [DATA, DATA[off[10]:] + DATA, DATA[off[20]:] + DATA * 2,
            DATA[off[20]:off[30]] + DATA[off[10]:off[20]]]


def _against_numpy_chain(streams: list, G: int, monkeypatch) -> None:
    """The serving call on ``streams`` in groups of G against
    ``SbrDecoder.process_frame`` fed the core PCM the call decoded and the
    SBR payloads its groups held: within the numpy chain's bound
    (``test_torch_aac_he_serving._against_numpy_sbr_chain``'s), and the
    int16 output that float output rounded and clipped."""
    seen, payloads = [], [[] for _ in streams]
    real_groups, real_decode = serving.iter_groups, sbrd.device_decode_group

    def iter_groups(streams_, G_, *, sbr=False):
        for planes, counts in real_groups(streams_, G_, sbr=sbr):
            for (s, _), pl in zip(counts, planes["sbr"]):
                payloads[s].extend(pl)
            yield planes, counts

    def record(static, pcm, cond, state):
        out, new_state = real_decode(static, pcm, cond, state)
        seen.append((pcm.numpy().copy(), out.numpy().copy()))
        return out, new_state

    monkeypatch.setattr(serving, "iter_groups", iter_groups)
    monkeypatch.setattr(sbrd, "device_decode_group", record)
    got = serving.decode_he_streams_device(streams, G, device="cpu")
    core = np.concatenate([p for p, _ in seen], axis=1)     # (C, F, 1024)
    out = np.concatenate([o for _, o in seen], axis=1)
    for s, pcm16 in enumerate(got):
        dec = _host.aac_sbr.SbrDecoder(22050)
        cols = slice(s * NCH, (s + 1) * NCH)
        ref = []
        for f, (payload, nbits, crc) in enumerate(payloads[s]):
            chans, coupling = dec.parse_payload(payload, nbits, stereo=True,
                                                crc=crc)
            ref.append(dec.process_frame(core[cols, f].astype(np.float64),
                                         chans, coupling))
        ref = np.concatenate(ref, axis=1)
        assert ref.shape == pcm16.shape == (NCH, len(payloads[s]) * 2048)
        err = out[cols, :ref.shape[1]] - ref
        assert np.abs(err).max() / max(np.abs(ref).max(), 1.0) < 2e-3, s
        assert np.sqrt((err ** 2).mean() / (ref ** 2).mean()) < 5e-4, s
        np.testing.assert_array_equal(
            pcm16, np.clip(np.rint(out[cols, :ref.shape[1]]), -32768,
                           32767).astype(np.int32))


@pytest.mark.parametrize("G", [48, 16])
def test_the_python_chain_gives_the_same_pcm(G, monkeypatch):
    """The ragged streams within the numpy chain's bound of it."""
    _against_numpy_chain(_ragged(), G, monkeypatch)


def test_the_counter_reads_zero_on_the_asset():
    """``frames.sbr`` counts the asset's 46 frames."""
    _host.sbr_native()
    before = tracing.snapshot()
    out, = serving.decode_he_streams_device([DATA], 48, device="cpu")
    after = tracing.snapshot()
    assert after["frames.sbr"] - before.get("frames.sbr", 0) == 46
    assert out.shape == (NCH, 46 * 2048) and out.any()


# -- the error cases --------------------------------------------------------

def _bits(pl, f) -> np.ndarray:
    return np.unpackbits(pl.bytes[f])[:int(pl.nbits[f])].copy()


def _with(pl, f, bits):
    data, nbits = pl.bytes.copy(), pl.nbits.copy()
    data[f] = 0
    nbits[f] = 0 if bits is None else len(bits)
    if bits is not None:
        packed = np.packbits(bits)
        data[f, :len(packed)] = packed
    return sbr_chain.SbrPayloads(data, nbits, pl.crc.copy())


def _no_payload(pl):
    return _with(pl, 3, None)


def _cut(pl):
    return _with(pl, 4, _bits(pl, 4)[:12])


def _smoothing_on(pl):
    """Every header of ``pl`` given extra2 fields, bs_smoothing_mode 0."""
    for f in range(len(pl)):
        bits = _bits(pl, f)
        if bits[0]:                                 # no CRC in the asset
            bits[16] = 1
            at = 17 + (5 if bits[15] else 0)
            pl = _with(pl, f, np.concatenate([bits[:at], [1, 0, 1, 0, 1, 0],
                                              bits[at:]]))
    return pl


def _parametric_stereo(pl):
    """Frame 2 given a PS extension (bs_extended_data, 2 bytes, id 2, a PS
    header with IID and ICC off and no envelope)."""
    SBR = _host.aac_sbr
    dec = SBR.SbrDecoder(22050)
    dec.parse_payload(*pl[0][:2], stereo=True, crc=pl[0][2])
    payload, nbits, _ = pl[2]
    b = SBR.Bits(payload, 0, nbits)
    assert b.read(1) == 0
    SBR.parse_sbr_data(b, dec.header, dec.ft, True)
    bits = _bits(pl, 2)
    assert bits[b.pos - 1] == 0
    ext = [1, 0, 0, 1, 0, 1, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]
    return _with(pl, 2, np.concatenate([bits[:b.pos - 1], ext]))


def _at(edit, stream, group=None):
    def on(s, gi, pl):
        return edit(pl) if s == stream and group in (None, gi) else pl
    return on


ERRORS = {
    "frame_without_payload": ([DATA, DATA], 16, _at(_no_payload, 1, 1),
                              "frame without SBR payload"),
    "data_before_header": (lambda: [DATA, DATA[_offsets()[5]:]], 16, None,
                           "stream 1: SBR data before header"),
    "header_changed": ([DATA, DATA], 8, _at(_smoothing_on, 0, 1),
                       "SBR header changed mid-stream"),
    "one_header_config": ([DATA, DATA], 16, _at(_smoothing_on, 1),
                          "device batch needs one SBR header config"),
    "parametric_stereo": ([DATA, DATA], 16, _at(_parametric_stereo, 0, 0),
                          r"PS \(v2\) stream: not served by this batch call"),
    "sbr_error": ([DATA, DATA], 16, _at(_cut, 1, 0),
                  "stream 1: SBR payload overrun"),
}


def _edited(monkeypatch, edit):
    real = serving.iter_groups

    def iter_groups(streams, G, *, sbr=False):
        for gi, (planes, counts) in enumerate(real(streams, G, sbr=sbr)):
            planes["sbr"] = [edit(s, gi, pl) for (s, _), pl in
                             zip(counts, planes["sbr"])]
            yield planes, counts
    monkeypatch.setattr(serving, "iter_groups", iter_groups)


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_errors_raise_as_the_python_chain_raises(case, monkeypatch):
    streams, G, edit, message = ERRORS[case]
    streams = streams() if callable(streams) else streams
    if edit is not None:
        _edited(monkeypatch, edit)
    with pytest.raises(ValueError, match=f"^{message}$"):
        serving.decode_he_streams_device(streams, G, device="cpu")


def test_rewritten_headers_decode_alike(monkeypatch):
    """Every header of every stream given smoothing: one header config, so
    the call decodes, within the numpy chain's bound."""
    _edited(monkeypatch, lambda s, gi, pl: _smoothing_on(pl))
    _against_numpy_chain(_ragged(), 16, monkeypatch)


# -- mesh= blocks -----------------------------------------------------------

@pytest.mark.parametrize("devices", [["cpu"] * 3, ["cpu"] * 8])
def test_mesh_blocks_equal_mesh_none(devices):
    streams = _ragged()
    want = serving.decode_he_streams_device(streams, 16, device="cpu")
    got = serving.decode_he_streams_device(
        streams, 16, mesh=parallel.make_mesh(devices=devices))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- the host cond state ----------------------------------------------------

def test_host_cond_state_not_carried_comes_out_not_correct(monkeypatch):
    """Every group's cond built from a new ``CondState``, the host half of
    the state ``ohp_bench``'s planted fault ``state_not_carried`` drops
    (that fault renews the device runner): the HE cell's comparison, at
    its CPU test size, fails on the PCM."""
    from ohp_bench import run

    real = sbr_chain.SbrGroup.cond
    monkeypatch.setattr(sbr_chain.SbrGroup, "cond",
                        lambda self, static, state: real(
                            self, static, sbr_chain.CondState(self.C)))
    cell = "he_aac_radio.batch"
    small = run.load_json(run.ROOT / "tests" / "small" / f"{cell}.json")
    line = run.run_cell(cell, 2 ** 31 + 11, 0.5, False, "cpu", small)
    gap = line["checks"]["pcm_gap_lsb"]
    assert not line["correct"] and gap["value"] > gap["limit"], gap
