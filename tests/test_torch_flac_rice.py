"""The port's rice decode and rice-wire synthesis
(ohpipeline_tpu_torch.codecs.flac) against the JAX package's
``rice_jax.decode_units`` and ``_synthesise_group_rice``, on wire planes
from ``native.flac_parse_group_rice``, over the content mix of
tests/test_flac_rice_device.py: tones, silence and constant subframes, DC,
white noise (large k), impulse escapes, wasted bits, a short final frame in
mono.  Every comparison is bit-exact.  The kernel itself runs only on the
card (marker ``gpu``), against the plain version; on the CPU
``window_model`` follows its bit window step by step, on those planes and on
``chip_smoke.rice_worst_case``."""

import numpy as np
import pytest
import torch

import chip_smoke
from ohpipeline_tpu_torch import _host, _kernels
from ohpipeline_tpu_torch.codecs import flac
from ohpipeline_tpu_torch.codecs.flac import rice
from ohpipeline_tpu_torch.codecs.flac.serving import iter_groups
from ohpipeline_tpu_torch.ops.lpc import wrap32

RATE = 44100
WORST_SEEDS = (0, 1, 2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tones(n=22050, seed=7):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / RATE
    x = (0.5 * np.sin(2 * np.pi * 523 * t) + 0.2 * np.sin(2 * np.pi * 97 * t)
         + 0.02 * rng.standard_normal(n))
    st = np.stack([x, np.roll(x, 17) * 0.8])
    return np.clip(st * 32000, -32768, 32767).astype(np.int32)


def _silence_burst():
    x = np.zeros((2, 22050), np.int32)
    x[0, 15000:15100] = 12000
    return x


def _impulses():
    rng = np.random.default_rng(4)
    x = rng.integers(-2, 3, (2, 22050)).astype(np.int32)
    pos = rng.integers(0, 22050, 12)
    x[0, pos], x[1, pos] = 32000, -32000
    return x


def _short_final_mono():
    rng = np.random.default_rng(6)
    n = 1024 * 9 + 777
    t = np.arange(n) / RATE
    return np.clip(20000 * np.sin(2 * np.pi * 441 * t)
                   + 300 * rng.standard_normal(n),
                   -32768, 32767).astype(np.int32)[None, :]


CONTENT = {
    "tones_noise_stereo": _tones,
    "silence_constant_subframes": _silence_burst,
    "dc_constant_value": lambda: np.full((2, 10000), -1234, np.int32),
    "white_noise_large_k": lambda: np.random.default_rng(3).integers(
        -32768, 32768, (2, 11025)).astype(np.int32),
    "impulse_spikes_escape_codewords": _impulses,
    "wasted_bits": lambda: (np.random.default_rng(5).integers(
        -2048, 2048, (2, 15000)) << 4).astype(np.int32),
    "short_final_frame_and_mono": _short_final_mono,
}


def _groups(name, frames_per_group=16):
    track = CONTENT[name]()
    data = _host.encode_flac(track, RATE, 16, blocksize=1024)
    return track, list(iter_groups([data], frames_per_group))


@pytest.mark.parametrize("name", sorted(CONTENT))
def test_decode_units_matches_jax(name):
    from ohpipeline_tpu.codecs.flac import rice_jax

    _, groups = _groups(name)
    for planes, _meta in groups:
        args = [planes[k] for k in flac.RICE_PLANES[:12]]
        want = np.asarray(rice_jax.decode_units(*args))
        t = flac.to_device(planes, "cpu")
        got = rice.decode_units(*(t[k] for k in flac.RICE_PLANES[:12]))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", sorted(CONTENT))
def test_synthesise_group_rice_matches_jax(name):
    from ohpipeline_tpu.codecs.flac import _synthesise_group_rice

    track, groups = _groups(name)
    nch = track.shape[0]
    pcm = []
    for planes, meta in groups:
        want = np.asarray(_synthesise_group_rice(
            *(planes[k] for k in flac.RICE_PLANES), nch))
        t = flac.to_device(planes, "cpu")
        got = flac.synthesise_group_rice(*(t[k] for k in flac.RICE_PLANES),
                                         nch).numpy()
        np.testing.assert_array_equal(got, want)
        (_s, n, sizes), = meta
        pcm += [got[f, :, :sizes[f]] for f in range(n)]
    np.testing.assert_array_equal(np.concatenate(pcm, axis=1), track)


def test_escapes_and_overflow_units_are_exercised():
    _, groups = _groups("impulse_spikes_escape_codewords")
    assert any((p["esc_row"] >= 0).any() for p, _ in groups)
    assert any((p["orow"] >= 0).any() for p, _ in groups)
    _, groups = _groups("silence_constant_subframes")
    assert any((p["cfrow"] >= 0).any() for p, _ in groups)


def test_cpu_tensors_take_plain_version():
    _kernels.reset_launches()
    _, groups = _groups("dc_constant_value")
    t = flac.to_device(groups[0][0], "cpu")
    rice.decode_units(*(t[k] for k in flac.RICE_PLANES[:12]))
    assert _kernels.launches["rice"] == 0


def window_model(words, cur, kk, mode, counts, record=None):
    """numpy model of csrc/rice.cu's walk: each unit keeps a 64-bit window
    holding the stream's bits from its cursor on at the top (zeros below)
    and the index of the next word to load; before each live step it tops
    the window up to at least 32 valid bits, one word at a time (at most
    two), word j read as words[clip(j, 0, nw - 1)]; the step decodes from
    the window's top 32 bits and shifts the consumed bits out.  Lanes past
    their count neither refill nor advance.  With ``record`` (a dict) it
    also keeps each step's quotient and codeword length and each unit's
    highest word index read (unclipped)."""
    w = words.astype(np.int64) & 0xFFFFFFFF
    nw, U = len(w), len(cur)
    c = cur.astype(np.int64)
    k = kk.astype(np.int64)
    raw = mode == 1
    buf = np.zeros(U, np.uint64)
    nb = -(c & 31)
    nx = c >> 5
    top = np.full(U, np.iinfo(np.int64).min)
    out = np.zeros((U, 64), np.int32)
    unary_at = np.zeros((U, 64), np.int64)
    span_at = np.zeros((U, 64), np.int64)
    for i in range(64):
        live = i < counts
        for _ in range(2):
            need = live & (nb < 32)
            word = w[np.clip(nx, 0, nw - 1)].astype(np.uint64)
            sh = np.where(need, 32 - nb, 0).astype(np.uint64)
            buf = np.where(need, buf | (word << sh), buf)
            top = np.where(need, np.maximum(top, nx), top)
            nb = np.where(need, nb + 32, nb)
            nx = np.where(need, nx + 1, nx)
        wnd = (buf >> np.uint64(32)).astype(np.int64)
        top16 = wnd >> 16
        unary = np.where(top16 > 0, 16 - np.frexp(top16.astype(float))[1], 16)
        low = np.where(k > 0, ((wnd << (unary + 1)) & 0xFFFFFFFF)
                       >> np.clip(32 - k, 0, 32), 0)
        zz = wrap32((unary << k) | low)
        rice_v = (zz >> 1) ^ -(zz & 1)
        raw_v = np.where(k > 0, wrap32(wnd) >> np.clip(32 - k, 0, 31), 0)
        adv = np.where(raw, k, unary + 1 + k)
        out[:, i] = np.where(live, np.where(raw, raw_v, rice_v), 0)
        unary_at[:, i], span_at[:, i] = unary, unary + 1 + k
        buf = np.where(live, buf << adv.astype(np.uint64), buf)
        nb = np.where(live, nb - adv, nb)
    if record is not None:
        record.update(unary=unary_at, span=span_at, top_word=top)
    return out


def _jax_scan_units(words, cur, kk, mode, counts):
    import jax
    import jax.numpy as jnp
    from ohpipeline_tpu.codecs.flac import rice_jax

    return np.asarray(jax.jit(rice_jax._scan_units)(
        jnp.asarray(words.view(np.uint32)), *map(jnp.asarray,
                                                 (cur, kk, mode, counts))))


def _window_model_agrees(lanes):
    want = _jax_scan_units(*lanes)
    np.testing.assert_array_equal(window_model(*lanes), want)
    np.testing.assert_array_equal(
        rice.scan_units_torch(*map(torch.from_numpy, lanes)).numpy(), want)


@pytest.mark.parametrize("name", sorted(CONTENT))
def test_window_model_matches_jax_and_plain(name):
    """The kernel's bit window is bit for bit the JAX ``_scan_units`` and
    the plain version on the parser's planes of every content group."""
    _, groups = _groups(name)
    for planes, _meta in groups:
        t = flac.to_device(planes, "cpu")
        _window_model_agrees([x.numpy() for x in rice.unit_lanes(
            *(t[k] for k in flac.RICE_PLANES[:7]))])


@pytest.mark.parametrize("seed", WORST_SEEDS)
def test_window_model_matches_jax_and_plain_on_worst_case(seed):
    _window_model_agrees(chip_smoke.rice_worst_case(seed))


@pytest.mark.parametrize("seed", WORST_SEEDS)
def test_rice_worst_case_reaches_every_trap(seed):
    """Every rice k 0-30 meets every quotient 0-16 on a live step, some
    codewords are longer than the 32-bit window, verbatim units are live at
    widths 0-32, live units start at every phase, walks read past the
    slab's last word, one cursor is negative, and counts 0, 1, 63 and 64
    all occur."""
    words, cur, kk, mode, counts = chip_smoke.rice_worst_case(seed)
    rec = {}
    window_model(words, cur, kk, mode, counts, rec)
    live = (np.arange(64)[None, :] < counts[:, None])
    rice_live = live & (mode == 0)[:, None]
    seen = set(zip(np.broadcast_to(kk[:, None], live.shape)[rice_live],
                   rec["unary"][rice_live]))
    assert seen == {(k, q) for k in range(31) for q in range(17)}
    assert (rec["span"][rice_live] > 32).any()
    assert set(kk[(mode == 1) & (counts > 0)]) == set(range(33))
    assert set(cur[counts > 0] & 31) == set(range(32))
    assert (rec["top_word"][counts > 0] >= len(words)).sum() >= 3
    assert (cur[counts > 0] < 0).any()
    assert {0, 1, 63, 64} <= set(counts)


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(cuda):
    streams = [_host.encode_flac(CONTENT[name](), RATE, 16)
               for name in sorted(CONTENT) if name != "short_final_frame_and_mono"]
    cases = []
    for planes, _meta in iter_groups(streams, 32):
        t = flac.to_device(planes, cuda)
        cases.append(rice.unit_lanes(*(t[k] for k in flac.RICE_PLANES[:7])))
    cases += [[torch.from_numpy(a).to(cuda)
               for a in chip_smoke.rice_worst_case(seed)]
              for seed in WORST_SEEDS]
    for lanes in cases:
        _kernels.reset_launches()
        got = rice.scan_units(*lanes)
        torch.cuda.synchronize()
        assert _kernels.launches["rice"] == 1
        assert torch.equal(got, rice.scan_units_torch(*lanes))
