"""The FLAC and AAC-LC serving calls parse each stream once and size each
group's wire planes from that group's own parse
(``codecs.flac.serving.iter_groups``, ``codecs.aac.serving.iter_groups``).

- Parse once: the native group parser runs once per (stream, group), plus
  one run per ``regrow.serve`` where a list had to grow (FLAC re-parses the
  stream; AAC unpacks it again from the parse it has).
- Forced regrow: with the lists' start capacities patched to 1, escape-rich
  content grows them during the call, and the output is the same as with
  the capacities left as they are.
- Per-group sizing: every list plane is its group's used prefix, padded to
  the next power of two (at least the plane's floor) with row -1 and zeros.
- Side rows: the AAC-LC and HE serving calls prepare their PNS and
  intensity rows natively, never through ``synthesis.prepare_group``;
  ``side_rows.serve`` counts the special rows of the call's parse.
"""

import os

import numpy as np
import pytest

from ohpipeline_tpu_torch import _host, tracing
from ohpipeline_tpu_torch.codecs.aac import serving as aac_serving
from ohpipeline_tpu_torch.codecs.aac import synthesis as aac_synthesis
from ohpipeline_tpu_torch.codecs.flac import serving as flac_serving
from test_torch_flac_rice import CONTENT

RATE = 44100
ASSET = os.path.join(os.path.dirname(__file__), "assets", "dryrun.aac")
GROUP = {"flac": 4, "aac": 8}


def _adts_frames(data: bytes) -> list:
    frames, pos = [], 0
    while pos + 7 <= len(data):
        n = ((data[pos + 3] & 3) << 11) | (data[pos + 4] << 3) \
            | (data[pos + 5] >> 5)
        frames.append(data[pos:pos + n])
        pos += n
    return frames


def _flac_content(name: str, lengths=(9000, 16000, 23000)):
    """Three FLAC streams of ``CONTENT[name]`` cut to ``lengths`` samples,
    blocksize 1024: (tracks, streams, frames per stream)."""
    full = CONTENT[name]()
    tracks = [full[:, :n] for n in lengths]
    streams = [_host.encode_flac(t, RATE, 16, blocksize=1024)
               for t in tracks]
    return tracks, streams, [-(-n // 1024) for n in lengths]


def _aac_content(lengths=(20, 33, 47)):
    """Three ADTS streams of dryrun.aac's frames from three starts:
    (streams, frames per stream)."""
    with open(ASSET, "rb") as f:
        frames = _adts_frames(f.read())
    streams = [b"".join(frames[(7 * i + k) % len(frames)] for k in range(n))
               for i, n in enumerate(lengths)]
    return streams, list(lengths)


def _serve(codec: str, streams: list) -> list:
    call = (flac_serving.decode_flac_streams_device if codec == "flac"
            else aac_serving.decode_aac_streams_device)
    return call(streams, GROUP[codec], device="cpu")


def _counting(monkeypatch, owner, name: str) -> list:
    """Wrap ``owner.name`` so that each call appends its result's frame
    count (or None) to the returned list."""
    real = getattr(owner, name)
    calls = []

    def counted(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(out[0] if isinstance(out, tuple) else out)
        return out

    monkeypatch.setattr(owner, name, counted)
    return calls


@pytest.mark.parametrize("codec", ["flac", "aac"])
def test_each_stream_parses_once_per_group(codec, monkeypatch):
    G = GROUP[codec]
    if codec == "flac":
        tracks, streams, nframes = _flac_content("tones_noise_stereo")
        parses = _counting(monkeypatch, flac_serving.native,
                           "flac_parse_group_rice")
    else:
        streams, nframes = _aac_content()
        native = _host.aac_native()
        parses = _counting(monkeypatch, native, "aac_parse_group")
        prepares = _counting(monkeypatch, native, "aac_prepare_rows_zz")
    with tracing.recording() as rec:
        out = _serve(codec, streams)
    regrow = rec.counters.get("regrow.serve", 0)
    # a stream is parsed in every group until a parse returns < G frames
    pairs = sum(n // G + 1 for n in nframes)
    with_frames = sum(-(-n // G) for n in nframes)
    if codec == "flac":
        assert len(parses) == pairs + regrow
        for got, track in zip(out, tracks):
            np.testing.assert_array_equal(got, track)
    else:
        assert len(parses) == pairs
        assert len(prepares) == with_frames + regrow
        assert [o.shape[1] for o in out] == [1024 * n for n in nframes]


@pytest.mark.parametrize("codec", ["flac", "aac"])
def test_lists_outgrown_in_a_call_regrow_to_the_same_output(codec,
                                                            monkeypatch):
    if codec == "flac":
        tracks, streams, _ = _flac_content("impulse_spikes_escape_codewords")
    else:
        streams, _ = _aac_content()
    want = _serve(codec, streams)
    module = flac_serving if codec == "flac" else aac_serving
    real = module._start_caps
    monkeypatch.setattr(module, "_start_caps",
                        lambda *a: tuple(1 for _ in real(*a)))
    with tracing.recording() as rec:
        got = _serve(codec, streams)
    assert rec.counters.get("regrow.serve", 0) > 0
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if codec == "flac":
        from ohpipeline_tpu.codecs.flac import decode_flac

        for a, data, track in zip(got, streams, tracks):
            np.testing.assert_array_equal(a, decode_flac(data)[1])
            np.testing.assert_array_equal(a, track)


#: Per codec: (row plane, the planes beside it, floor) of each list.
LISTS = {
    "flac": [("orow", ("ocur", "okk", "omode", "ocnt", "opos"), 256),
             ("cfrow", ("cfval", "cfn"), 64),
             ("esc_row", ("esc_pos", "esc_val"), 64)],
    "aac": [("epak", ("eva2",), 256), ("ssr", ("ssf",), 64),
            ("trow", ("tfi", "tco", "tdir"), 64), ("srow", ("side",), 8)],
}


@pytest.mark.parametrize("codec", ["flac", "aac"])
def test_each_list_plane_is_its_groups_used_prefix(codec):
    if codec == "flac":
        _, streams, _ = _flac_content("silence_constant_subframes",
                                      (22050, 22050, 22050))
        groups = list(flac_serving.iter_groups(streams, 16))
    else:
        streams, _ = _aac_content((89, 60, 75))
        groups = list(aac_serving.iter_groups(streams, 32))
    sizes = {}
    for planes, _ in groups:
        for row, beside, floor in LISTS[codec]:
            rows = planes[row]
            n = int((rows >= 0).sum())
            assert (rows[:n] >= 0).all() and (rows[n:] == -1).all(), row
            want = max(floor, 1 << (n - 1).bit_length())
            assert len(rows) == want, row
            for key in beside:
                assert len(planes[key]) == want, key
                assert not planes[key][n:].any(), key
            sizes.setdefault(row, set()).add(len(rows))
    # the groups' lengths differ: each is sized by its own parse
    assert any(len(s) > 1 for s in sizes.values()), sizes


def _no_prepare_group(*args, **kwargs):
    raise AssertionError("a serving call ran synthesis.prepare_group")


def test_side_rows_are_native_and_counted(monkeypatch):
    """An AAC-LC call over content with dryrun.aac's PNS frames (87-88):
    ``side_rows.serve`` is the special rows its parse handed back, and
    ``prepare_group`` never runs."""
    streams, nframes = _aac_content((89, 60, 75))
    special = []
    native = _host.aac_native()
    real = native.aac_prepare_rows_zz

    def prepare(*args, **kwargs):
        out = real(*args, **kwargs)
        if out is not None:
            special.append(len(out))
        return out

    monkeypatch.setattr(native, "aac_prepare_rows_zz", prepare)
    monkeypatch.setattr(aac_synthesis, "prepare_group", _no_prepare_group)
    with tracing.recording() as rec:
        out = _serve("aac", streams)
    assert [o.shape[1] for o in out] == [1024 * n for n in nframes]
    assert sum(special) > 0
    assert rec.counters["side_rows.serve"] == sum(special)


def test_side_rows_read_zero_in_an_he_call(monkeypatch):
    """dryrun_he.aac has no PNS or intensity row: the HE call counts none,
    and runs no ``prepare_group`` either."""
    with open(os.path.join(os.path.dirname(ASSET), "dryrun_he.aac"),
              "rb") as f:
        data = f.read()
    monkeypatch.setattr(aac_synthesis, "prepare_group", _no_prepare_group)
    with tracing.recording() as rec:
        out, = aac_serving.decode_he_streams_device([data], 16, device="cpu")
    assert out.shape[1] == 46 * 2048
    assert rec.counters.get("frames.sbr") == 46
    assert rec.counters.get("side_rows.serve", 0) == 0
