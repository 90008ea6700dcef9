"""The port's PCM DSP (ohpipeline_tpu_torch.ops.pcm) against
ohpipeline_tpu.ops.pcm on the same seeded inputs, bit-exact: the integer
ops are exact, and apply_gain / to_float run their float32 operations in
the JAX package's order.  Unity rows pass through unchanged.  The ``gpu``
tests hold the card's apply_gain, to_float, attenuate and
bit_depth_convert to the CPU's, bit for bit."""

from fractions import Fraction

import numpy as np
import pytest
import torch

from ohpipeline_tpu_torch.ops import pcm


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _jpcm():
    from ohpipeline_tpu.ops import pcm as jpcm
    return jpcm


def _tile(rng, B=6, C=2, N=257, bits=24):
    half = 1 << (bits - 1)
    return rng.integers(-half, half, (B, C, N)).astype(np.int32)


def _gain_case(rng, B=6):
    rs = rng.uniform(0.0, 1.2, B).astype(np.float32)
    re = rng.uniform(0.0, 1.2, B).astype(np.float32)
    g = rng.uniform(0.0, 1.0, B).astype(np.float32)
    rs[:2], re[:2], g[:2] = 1.0, 1.0, 1.0            # unity rows
    rs[2], re[2] = 1.0, 1.0                           # gain only
    g[3] = 0.0                                        # muted row
    return rs, re, g


def _both(fn_name, *args, device="cpu"):
    jax_out = getattr(_jpcm(), fn_name)(*args)
    port_out = getattr(pcm, fn_name)(
        *(torch.from_numpy(np.asarray(a)).to(device) for a in args))
    return jax_out, port_out


def _equal(jax_out, port_out):
    want = np.asarray(jax_out)
    got = port_out.cpu().numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [16, 24])
def test_apply_gain(bits):
    rng = np.random.default_rng(bits)
    tile = _tile(rng, bits=bits)
    _equal(*_both("apply_gain", tile, *_gain_case(rng)))


@pytest.mark.parametrize("N", [2047, 2918, 5666])
def test_apply_gain_at_widths_whose_reciprocal_is_inexact(N):
    """XLA compiles n / N as n * float32(1 / N); at these widths that
    differs from a division in hundreds of positions of the ramp line."""
    rng = np.random.default_rng(N)
    tile = _tile(rng, N=N, bits=24)
    _equal(*_both("apply_gain", tile, *_gain_case(rng)))


def _round_f32(x: Fraction) -> np.float32:
    """Exact value -> nearest float32, ties to even."""
    f = np.float32(float(x))
    cands = (np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(v.view(np.int32)) & 1))


def test_fma32_rounds_once():
    rng = np.random.default_rng(7)
    a, b, c = (rng.uniform(-1.5, 1.5, 3000).astype(np.float32)
               for _ in range(3))
    c[:1000] *= np.float32(2.0 ** -30)    # far exponents: float64 rounds
    # a * b exactly halfway between two float32 values, c below float64's
    # ulp: rounding the float64 sum to float32 would tie to even
    half = np.float32(1 + 2.0 ** -12)
    a[:2], b[:2], c[:2] = half, half, [2.0 ** -80, -(2.0 ** -80)]
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    got = pcm.fma32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] > got[1]


def test_apply_gain_unity_rows_pass_through():
    rng = np.random.default_rng(1)
    tile = _tile(rng, bits=32)          # 32-bit content: float32 would round
    rs, re, g = _gain_case(rng)
    _, out = _both("apply_gain", tile, rs, re, g)
    np.testing.assert_array_equal(out[:2].numpy(), tile[:2])


def test_attenuate():
    rng = np.random.default_rng(2)
    tile = _tile(rng)
    att = rng.integers(0, pcm.UNITY_ATTENUATION + 1, 6).astype(np.int32)
    att[0] = pcm.UNITY_ATTENUATION
    _equal(*_both("attenuate", tile, att))


def test_to_float():
    rng = np.random.default_rng(3)
    tile = _tile(rng)
    _equal(*_both("to_float", tile,
                  np.array([16, 24, 8, 24, 32, 16], np.int32)))


def test_bit_depth_convert():
    rng = np.random.default_rng(4)
    tile = _tile(rng, bits=16)
    frm = np.array([16, 16, 24, 24, 16, 8], np.int32)
    to = np.array([24, 16, 16, 32, 8, 16], np.int32)
    _equal(*_both("bit_depth_convert", tile, frm, to))


def test_silence_tile():
    # the JAX function is jitted without static shapes, so it is called
    # unjitted here
    out = pcm.silence_tile(3, 2, 5, device="cpu")
    _equal(_jpcm().silence_tile.__wrapped__(3, 2, 5), out)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_stereo_decorrelate(mode):
    rng = np.random.default_rng(10 + mode)
    ch0 = rng.integers(-(1 << 23), 1 << 23, (4, 300)).astype(np.int32)
    ch1 = rng.integers(-(1 << 23), 1 << 23, (4, 300)).astype(np.int32)
    modes = np.array([mode, mode, 3 - mode, (mode + 1) % 4], np.int32)
    (jl, jr), (pl, pr) = _both("stereo_decorrelate", ch0, ch1, modes)
    _equal(jl, pl)
    _equal(jr, pr)


@pytest.mark.gpu
def test_card_matches_cpu(cuda):
    rng = np.random.default_rng(20)
    tile = _tile(rng, B=64, N=4096)
    gains = _gain_case(rng, B=64)
    args = [torch.from_numpy(a) for a in (tile, *gains)]
    assert torch.equal(pcm.apply_gain(*[a.to(cuda) for a in args]).cpu(),
                       pcm.apply_gain(*args))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["to_float", "attenuate",
                                  "bit_depth_convert"])
def test_card_matches_cpu_bit_for_bit(name, cuda):
    """Rows of bit depths 8, 16, 24 and 32; to_float's scale goes through
    exp on the card, which must round as the CPU's does."""
    rng = np.random.default_rng(21)
    bits = np.tile(np.array([8, 16, 24, 32], np.int32), 4)
    tile = (rng.integers(-(1 << 31), 1 << 31, (16, 2, 4096))
            >> (32 - bits)[:, None, None]).astype(np.int32)
    args = {"to_float": (tile, bits),
            "attenuate": (tile, rng.integers(0, pcm.UNITY_ATTENUATION + 1,
                                             16).astype(np.int32)),
            "bit_depth_convert": (tile, bits, np.roll(bits, 1))}[name]
    fn = getattr(pcm, name)
    want = fn(*(torch.from_numpy(a) for a in args))
    got = fn(*(torch.from_numpy(a).to(cuda) for a in args))
    assert got.device.type == "cuda" and got.dtype == want.dtype
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


PACK_CASES = [(bits, be, True, False) for bits in (8, 16, 24, 32)
              for be in (False, True)] + [(8, False, False, False),
                                          (32, False, True, True),
                                          (64, True, True, True)]


@pytest.mark.parametrize("bits,big_endian,signed,float_format", PACK_CASES)
def test_host_byte_packers_match_jax(bits, big_endian, signed,
                                     float_format):
    """The port's host copy of the byte packers (host/ops/pcm.py, which the
    WAV, AIFF and raw PCM plug-ins use) against the JAX package's, byte for
    byte: unpack from seeded bytes, pack back (floats unpack to 24-bit)."""
    from ohpipeline_tpu_torch.host.ops import pcm as hpcm

    jpcm = _jpcm()
    rng = np.random.default_rng(bits + 2 * big_endian + 4 * signed)
    if float_format:
        dt = (">" if big_endian else "<") + ("f4" if bits == 32 else "f8")
        data = rng.uniform(-1.1, 1.1, 600).astype(dt).tobytes()
    else:
        data = rng.integers(0, 256, 600 * bits // 8, dtype=np.uint8).tobytes()
    kw = dict(big_endian=big_endian, signed=signed, float_format=float_format)
    got = hpcm.unpack_pcm_bytes(data, bits, 2, **kw)
    want = jpcm.unpack_pcm_bytes(data, bits, 2, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    out_bits = 24 if float_format else bits
    assert hpcm.pack_pcm_bytes(got, out_bits, big_endian) \
        == jpcm.pack_pcm_bytes(want, out_bits, big_endian)
    assert hpcm.native_limits(out_bits) == jpcm.native_limits(out_bits)
