"""The flagship decode->render step on one device.

Port of ``decode_render_step`` and ``example_step_args`` of
``ohpipeline_tpu.parallel``.  The mesh functions (sharding, room fan-out,
per-room render grid) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codecs.flac import synthesise_group
from ..ops import lpc as lpc_ops
from ..ops import pcm as pcm_ops


def decode_render_step(data, coeffs, shift, order, wasted, assign,
                       ramp_start, ramp_end, gain, num_channels: int = 2):
    """FLAC-family subframe batch -> rendered PCM.

    B = F * num_channels rows of subframe data: LPC synthesis -> wasted-bit
    shift -> inter-channel decorrelation -> fused ramp x volume gain.
    Returns (F, num_channels, N) int32 PCM and the per-frame peak meters
    (F,) int32.
    """
    chans = synthesise_group(data, coeffs, shift, order, wasted, assign,
                             num_channels)
    rendered = pcm_ops.apply_gain(chans, ramp_start, ramp_end, gain)
    peaks = torch.amax(rendered.abs(), dim=(1, 2))
    return rendered, peaks


def example_step_args(nframes: int = 8, n: int = 1024, num_channels: int = 2,
                      seed: int = 0):
    """Small, realistic example inputs (numpy), the same as the JAX
    package's for the same arguments."""
    rng = np.random.default_rng(seed)
    B = nframes * num_channels
    data = rng.integers(-1000, 1000, size=(B, n)).astype(np.int32)
    coeffs = np.zeros((B, lpc_ops.MAX_ORDER), np.int32)
    coeffs[:, :4] = [4, -6, 4, -1]
    shift = np.zeros(B, np.int32)
    order = np.full(B, 4, np.int32)
    wasted = np.zeros(B, np.int32)
    assign = np.full(nframes, 10, np.int32)   # mid/side
    ramp_start = np.ones(nframes, np.float32)
    ramp_end = np.ones(nframes, np.float32)
    gain = np.full(nframes, 0.8, np.float32)
    return (data, coeffs, shift, order, wasted, assign, ramp_start,
            ramp_end, gain)
