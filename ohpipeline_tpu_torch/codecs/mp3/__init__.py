"""MP3 (MPEG-1/2/2.5 Layer III): the filterbank's group decode and the
multi-stream serving call, on tensors.

Port of the device half of ``ohpipeline_tpu.codecs.mp3``: the parallel path
of ``decode_frames_lazy`` (``mp3/__init__.py:115-134``) and
``decode_frames``.  The host entropy decode (headers, side info, bit
reservoir, scalefactors, the native Huffman core) and the numpy prep
(requantize, stereo, alias reduction: ``prepare_granules``) are the port's
copies under ``host/codecs/mp3``; the hybrid filterbank runs on the device
(``synthesis``), with its overlap and V-FIFO state kept there between
groups.  ``serving.decode_mp3_streams_device`` is the serving call.
"""

from __future__ import annotations

import numpy as np
import torch

from ...host.codecs.mp3 import bitstream as BS
from ...host.codecs.mp3.prep import parse_vbr_header, prepare_granules
from . import synthesis as SYN

__all__ = ["StreamState", "decode_frames", "decode_frames_lazy",
           "parse_vbr_header", "prepare_granules"]


class StreamState:
    """One stream's filterbank state on ``device``: overlap (C, 576) and
    vfifo (C, 16, 64)."""

    def __init__(self, channels: int, device="cuda"):
        self.device = torch.device(device)
        self.overlap, self.vfifo = SYN.init_state(channels, self.device)


def decode_frames_lazy(frames: list[BS.Mp3Frame], state: StreamState,
                       channels: int, bit_depth: int = 16):
    """Host prep of a group of parsed frames and the filterbank's launch on
    the state's device, now (the state advances at once); returns a
    zero-argument function that copies the PCM back as (channels, n) int32
    in the bit_depth range.  Unlike the JAX path, which pads a group to a
    granule bucket (32, 64, ...) so that jit compiles few shapes, the group
    runs at its own length: nothing here compiles per shape, and the PCM of
    a granule does not depend on the padding after it."""
    xr_t, bt_t = prepare_granules(frames, channels)
    n_real = xr_t.shape[0]
    if not n_real:
        return lambda: np.zeros((channels, 0), np.int32)
    dev = state.device
    pcm, state.overlap, state.vfifo = SYN.hybrid_synthesis_parallel(
        torch.from_numpy(xr_t).to(dev), torch.from_numpy(bt_t).to(dev),
        state.overlap, state.vfifo, n_real, bit_depth)
    return lambda: pcm.cpu().numpy().transpose(1, 0, 2).reshape(channels, -1)


def decode_frames(frames: list[BS.Mp3Frame], state: StreamState,
                  channels: int, bit_depth: int = 16) -> np.ndarray:
    """Decode parsed frames -> (channels, n) int32 in the bit_depth range."""
    return decode_frames_lazy(frames, state, channels, bit_depth)()
