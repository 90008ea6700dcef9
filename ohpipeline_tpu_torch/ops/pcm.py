"""Batched PCM DSP on tensors: the device half of the render path.

Ports the device functions of ``ohpipeline_tpu.ops.pcm`` with their layouts
and exactness contract: tiles are (B, C, N) int32 in the native range of
their bit depth, gains are per-row float32, and a row whose combined gain is
exactly 1.0 passes through bit for bit.  The host byte packers stay numpy in
the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

UNITY_ATTENUATION = 1 << 14   # Msg.h MsgAudioPcm::kUnityAttenuation

# Channel-assignment codes of the batch metadata: 0 = independent,
# 1 = left/side, 2 = right/side, 3 = mid/side.
CH_INDEPENDENT, CH_LEFT_SIDE, CH_RIGHT_SIDE, CH_MID_SIDE = 0, 1, 2, 3


#: float32(ln 2): ``jnp.exp2(x)`` is defined as ``exp(ln2 * x)``.
_LN2_F32 = float(np.float32(math.log(2.0)))


def fma32(a, b, c):
    """float32 ``a * b + c`` rounded once, like a fused multiply-add.

    The product of two float32 values is exact in float64; the sum is
    rounded to odd (a float64 TwoSum gives the rounding error, and an even
    result with an error moves one ulp toward the exact value), and the
    final rounding to float32 is then correct, since float64 carries more
    than 24 + 2 bits.  The same on every device.
    """
    a, b, c = (x.to(torch.float64) for x in (a, b, c))
    p = a * b
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, math.inf, -math.inf)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def apply_gain(tile, ramp_start, ramp_end, gain):
    """Fused ramp x scalar gain over a (B, C, N) int32 tile.

    ramp_start, ramp_end, gain: (B,) float32.  Sample n of N gets
    start + (end - start) * n / N, times gain, rounded half to even.  The
    float32 operations run in the JAX package's order, as XLA compiles them:
    n / N as n times the float32 reciprocal of N (XLA's rewrite of a
    division by a constant), and the ramp line's multiply-add fused, so the
    result is bit-exact with it.  Unity rows pass through unchanged.
    """
    B, C, N = tile.shape
    recip = float(np.float32(1.0) / np.float32(max(N, 1)))
    t = torch.arange(N, dtype=torch.float32, device=tile.device) * recip
    line = fma32((ramp_end - ramp_start)[:, None], t[None, :],
                 ramp_start[:, None])
    g = line * gain[:, None]
    out = torch.round(tile.to(torch.float32) * g[:, None, :]).to(torch.int32)
    unity = (ramp_start == 1.0) & (ramp_end == 1.0) & (gain == 1.0)
    return torch.where(unity[:, None, None], tile, out)


def attenuate(tile, attenuation):
    """Integer attenuation (s * a) >> 14 with a in [0, 1 << 14], exact in
    int32 through a 16-bit split of s (the reference Attenuator's math)."""
    a = attenuation.to(torch.int32)[:, None, None]
    lo = tile & 0xFFFF
    hi = tile >> 16
    return ((hi * a) << 2) + ((lo * a) >> 14)


def to_float(tile, bit_depth):
    """Native-range int32 -> float32 in [-1, 1); bit_depth per row (B,).
    The scale 2^(1 - bits) is computed as the JAX package computes it."""
    scale = torch.exp(_LN2_F32 * (1.0 - bit_depth.to(torch.float32)))
    scale = scale[:, None, None]
    return tile.to(torch.float32) * scale * 0.5


def bit_depth_convert(tile, from_bits, to_bits):
    """Shift native-range samples between bit depths per row: widening is
    exact, narrowing truncates toward -inf."""
    d = (to_bits - from_bits).to(torch.int32)[:, None, None]
    return (tile << d.clamp(min=0)) >> (-d).clamp(min=0)


def silence_tile(b: int, c: int, n: int, *, device):
    return torch.zeros((b, c, n), dtype=torch.int32, device=device)


def stereo_decorrelate(ch0, ch1, mode):
    """Undo FLAC stereo decorrelation: ch0, ch1 (B, N) int32, mode (B,) one
    of the CH_* codes.  Returns (left, right), bit-exact with flac-1.2.1."""
    m = mode[:, None]
    side = ch1
    mid2 = (ch0 << 1) | (side & 1)
    left = torch.where(m == CH_LEFT_SIDE, ch0,
                       torch.where(m == CH_RIGHT_SIDE, ch0 + ch1,
                                   torch.where(m == CH_MID_SIDE,
                                               (mid2 + side) >> 1, ch0)))
    right = torch.where(m == CH_LEFT_SIDE, ch0 - ch1,
                        torch.where(m == CH_RIGHT_SIDE, ch1,
                                    torch.where(m == CH_MID_SIDE,
                                                (mid2 - side) >> 1, ch1)))
    return left, right
