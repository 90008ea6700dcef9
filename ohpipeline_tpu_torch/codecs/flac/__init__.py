"""FLAC device synthesis on tensors.

Port of the device half of ``ohpipeline_tpu.codecs.flac``: the host parser
(``native.flac_parse_group`` / ``flac_parse_group_rice``) yields numpy wire
planes, :func:`to_device` puts them on a device, and one pass per group of
frames runs rice decode (rice wire only) -> escape and warm-up patch -> LPC
recurrence -> wasted-bit shift -> inter-channel decorrelation.  On the card
the rice decode and the LPC recurrence are the hand-written kernels in
``csrc/``; on the CPU their plain PyTorch versions.
"""

from __future__ import annotations

import numpy as np
import torch

from ..._host import frames as FF
from ...ops import lpc as lpc_ops
from ...ops import pcm as pcm_ops
from . import rice

#: Argument order of :func:`synthesise_group_rice` (before num_channels).
RICE_PLANES = ("bits", "gcur", "gk", "ocur", "okk", "omode", "ocnt", "orow",
               "opos", "cfrow", "cfval", "cfn", "warm", "esc_row", "esc_pos",
               "esc_val", "coeffs", "shift", "order", "wasted", "assign")

#: Per-frame metadata the host keeps; :func:`to_device` leaves it out.
HOST_KEYS = ("blocksize", "sample_number")


def to_device(batch: dict, device) -> dict:
    """Numpy wire planes -> tensors on ``device``: the uint8 byte slab
    ``bits`` stays uint8, every other plane becomes int32 (the parser's
    int8 planes such as ``gk`` included).  Host-only keys are left out."""
    out = {}
    for key, arr in batch.items():
        if key in HOST_KEYS:
            continue
        arr = np.ascontiguousarray(arr)
        if arr.dtype != np.uint8:
            arr = arr.astype(np.int32, copy=False)
        out[key] = torch.from_numpy(arr).to(device)
    return out


def channel_modes(assign):
    """Frame-header assignment codes (F,) -> ``ops.pcm`` CH_* modes."""
    return torch.where(
        assign == FF.ASSIGN_LEFT_SIDE, pcm_ops.CH_LEFT_SIDE,
        torch.where(assign == FF.ASSIGN_RIGHT_SIDE, pcm_ops.CH_RIGHT_SIDE,
                    torch.where(assign == FF.ASSIGN_MID_SIDE,
                                pcm_ops.CH_MID_SIDE,
                                pcm_ops.CH_INDEPENDENT)))


def synthesise_group(data, coeffs, shift, order, wasted, assign,
                     num_channels: int):
    """One device pass over a group of FLAC frames.

    data (B, N) int32 with B = nframes * num_channels (rows frame-major);
    coeffs (B, 32), shift/order/wasted (B,), assign (nframes,) raw channel
    assignment codes.  Returns (nframes, num_channels, N) int32 PCM.
    """
    synth = lpc_ops.lpc_synthesize(data, coeffs, shift, order)
    synth = synth << wasted[:, None]
    B, N = data.shape
    chans = synth.reshape(B // num_channels, num_channels, N)
    if num_channels != 2:
        return chans
    left, right = pcm_ops.stereo_decorrelate(chans[:, 0], chans[:, 1],
                                             channel_modes(assign))
    return torch.stack([left, right], dim=1)


def synthesise_group_rice(bits, gcur, gk, ocur, okk, omode, ocnt, orow,
                          opos, cfrow, cfval, cfn, warm,
                          esc_row, esc_pos, esc_val,
                          coeffs, shift, order, wasted, assign,
                          num_channels: int):
    """:func:`synthesise_group` fed by the rice wire: decode the rice codes
    (``rice.decode_units``), write the host's escape triples and warm-up
    samples over the residual plane, then synthesise."""
    d = rice.decode_units(bits, gcur, gk, ocur, okk, omode, ocnt, orow, opos,
                          cfrow, cfval, cfn)
    B, stride = d.shape
    flat = torch.cat([d.reshape(-1), d.new_zeros(1)])
    # padding triples (row -1) land on the extra slot, which is dropped
    eidx = torch.where(esc_row >= 0, esc_row * stride + esc_pos, B * stride)
    flat[eidx.to(torch.int64)] = esc_val
    d = flat[:B * stride].reshape(B, stride)
    pos = torch.arange(lpc_ops.MAX_ORDER, device=d.device)[None, :]
    d[:, :lpc_ops.MAX_ORDER] = torch.where(pos < order[:, None], warm,
                                           d[:, :lpc_ops.MAX_ORDER])
    return synthesise_group(d, coeffs, shift, order, wasted, assign,
                            num_channels)


def synthesise_batch(batch: dict, num_channels: int, nframes: int, *,
                     device) -> np.ndarray:
    """Run one device pass over a parsed batch dict (layout of
    ``native.flac_parse_group``) and reassemble (channels, samples) int32
    PCM as numpy."""
    if nframes == 0:
        return np.zeros((num_channels, 0), np.int32)
    B = nframes * num_channels
    rows = {k: batch[k][:B] for k in ("data", "coeffs", "shift", "order",
                                      "wasted")}
    rows["assign"] = batch["assign"][:nframes]
    t = to_device(rows, device)
    out = synthesise_group(t["data"], t["coeffs"], t["shift"], t["order"],
                           t["wasted"], t["assign"], num_channels).cpu()
    out = out.numpy()
    bs = batch["blocksize"]
    if all(bs[i] == out.shape[2] for i in range(nframes)):
        return out.transpose(1, 0, 2).reshape(num_channels, -1)
    return np.concatenate([out[fi, :, :bs[fi]] for fi in range(nframes)],
                          axis=1)
