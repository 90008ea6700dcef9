"""The HE-AAC serving call (``decode_he_streams_device``) with its native SBR
chain and without it: with the chain's native entry points made
unavailable, every stream's group runs through the Python chain, the PCM
is the same to the bit and the counter ``fallback.sbr`` counts each
stream's group that has frames; with the library built it reads 0 on the
asset.  The call's six ``ValueError`` cases raise the same message either
way (payloads rewritten at the bit level where no stream in the repo has
the fault), and a logical mesh's blocks give what ``mesh=None`` gives."""

import math
import pathlib

import numpy as np
import pytest

from ohpipeline_tpu_torch import _host, parallel, tracing
from ohpipeline_tpu_torch.codecs.aac import sbr_chain, serving
from ohpipeline_tpu_torch.host import native

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


def _fallbacks(fn):
    before = tracing.snapshot().get("fallback.sbr", 0)
    out = fn()
    return out, tracing.snapshot()["fallback.sbr"] - before


def _python_chain(monkeypatch):
    monkeypatch.setattr(native, "sbr_chain_lib", lambda: None)


@pytest.mark.parametrize("G", [48, 16])
def test_the_python_chain_gives_the_same_pcm(G, monkeypatch):
    streams = _ragged()
    got, n = _fallbacks(lambda: serving.decode_he_streams_device(
        streams, G, device="cpu"))
    assert n == 0
    _python_chain(monkeypatch)
    want, n = _fallbacks(lambda: serving.decode_he_streams_device(
        streams, G, device="cpu"))
    frames = [46, 82, 118, 20]
    assert n == sum(math.ceil(f / G) for f in frames)
    for g, w, f in zip(got, want, frames):
        assert g.shape == (NCH, f * 2048)
        np.testing.assert_array_equal(g, w)


def test_the_counter_reads_zero_on_the_asset():
    _host.sbr_native()
    before = tracing.snapshot()
    out, = serving.decode_he_streams_device([DATA], 48, device="cpu")
    after = tracing.snapshot()
    assert after["fallback.sbr"] == before.get("fallback.sbr", 0)
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
    with pytest.raises(ValueError, match=f"^{message}$") as native_err:
        serving.decode_he_streams_device(streams, G, device="cpu")
    _python_chain(monkeypatch)
    with pytest.raises(ValueError) as python_err:
        serving.decode_he_streams_device(streams, G, device="cpu")
    assert str(native_err.value) == str(python_err.value)


def test_rewritten_headers_decode_alike(monkeypatch):
    """Every header of every stream given smoothing: one header config, so
    the call decodes, natively and in Python alike."""
    _edited(monkeypatch, lambda s, gi, pl: _smoothing_on(pl))
    streams = _ragged()
    got, n = _fallbacks(lambda: serving.decode_he_streams_device(
        streams, 16, device="cpu"))
    assert n == 0
    _python_chain(monkeypatch)
    want = serving.decode_he_streams_device(streams, 16, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- mesh= blocks -----------------------------------------------------------

@pytest.mark.parametrize("devices", [["cpu"] * 3, ["cpu"] * 8])
def test_mesh_blocks_equal_mesh_none(devices):
    streams = _ragged()
    want = serving.decode_he_streams_device(streams, 16, device="cpu")
    got, n = _fallbacks(lambda: serving.decode_he_streams_device(
        streams, 16, mesh=parallel.make_mesh(devices=devices)))
    assert n == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
