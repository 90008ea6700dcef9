"""PCM byte packing at the framework edges, in numpy.

The port's copy of the host half of the JAX package's ``ops/pcm.py``, whose
module loads JAX when imported: ``native_limits``, ``unpack_pcm_bytes`` and
``pack_pcm_bytes``, which the WAV, AIFF and raw PCM plug-ins use.  The
device half is ``ohpipeline_tpu_torch.ops.pcm``.
"""

from __future__ import annotations

import numpy as np


def native_limits(bit_depth: int) -> tuple[int, int]:
    """[min, max] sample values at a native bit depth."""
    hi = 1 << (bit_depth - 1)
    return -hi, hi - 1


def unpack_pcm_bytes(data: bytes, bit_depth: int, num_channels: int,
                     big_endian: bool = False, signed: bool = True,
                     float_format: bool = False) -> np.ndarray:
    """Interleaved PCM bytes -> (channels, samples) int32 in native range.

    Handles 8/16/24/32-bit integer (either endianness, signed/unsigned 8-bit)
    and 32/64-bit float (scaled to 24-bit native range), i.e. the format
    space of the reference's CodecPcm/CodecWav/CodecAiff.
    """
    bps = bit_depth // 8
    if float_format:
        dt = (">" if big_endian else "<") + ("f4" if bit_depth == 32 else "f8")
        f = np.frombuffer(data, dtype=dt).astype(np.float64)
        x = np.clip(np.rint(f * (1 << 23)), -(1 << 23), (1 << 23) - 1)
        x = x.astype(np.int32)
    elif bit_depth == 8:
        x = np.frombuffer(data, dtype=np.int8 if signed else np.uint8)
        x = x.astype(np.int32) - (0 if signed else 128)
    elif bit_depth == 24:
        raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        if big_endian:
            x = ((raw[:, 0].astype(np.int32) << 16)
                 | (raw[:, 1].astype(np.int32) << 8)
                 | raw[:, 2].astype(np.int32))
        else:
            x = ((raw[:, 2].astype(np.int32) << 16)
                 | (raw[:, 1].astype(np.int32) << 8)
                 | raw[:, 0].astype(np.int32))
        x = (x << 8) >> 8   # sign-extend from 24 bits
    else:
        dt = (">" if big_endian else "<") + f"i{bps}"
        x = np.frombuffer(data, dtype=dt).astype(np.int32)
    n = (len(x) // num_channels) * num_channels
    return np.ascontiguousarray(x[:n].reshape(-1, num_channels).T)


def pack_pcm_bytes(samples: np.ndarray, bit_depth: int,
                   big_endian: bool = False) -> bytes:
    """(channels, samples) int32 native range -> interleaved bytes.

    The animator-edge inverse of `unpack_pcm_bytes` (reference:
    MsgPlayablePcm::Read -> IPcmProcessor, Msg.cpp).
    """
    inter = np.ascontiguousarray(samples.T)        # (n, ch)
    lo, hi = native_limits(bit_depth)
    inter = np.clip(inter, lo, hi)
    if bit_depth == 8:
        return inter.astype(np.int8).tobytes()
    if bit_depth == 24:
        flat = inter.reshape(-1)
        out = np.empty((flat.size, 3), np.uint8)
        b0, b1, b2 = flat & 0xFF, (flat >> 8) & 0xFF, (flat >> 16) & 0xFF
        if big_endian:
            out[:, 0], out[:, 1], out[:, 2] = b2, b1, b0
        else:
            out[:, 0], out[:, 1], out[:, 2] = b0, b1, b2
        return out.tobytes()
    dt = (">" if big_endian else "<") + f"i{bit_depth // 8}"
    return inter.astype(dt).tobytes()
