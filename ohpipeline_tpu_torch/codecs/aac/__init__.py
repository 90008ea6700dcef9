"""AAC-LC device decode hooks on tensors.

Port of the array-native hooks of ``ohpipeline_tpu.codecs.aac``: the host
parser (``native.aac_parse_group``) yields numpy arrays, the host prepares
them (``synthesis.prepare_group`` or :func:`prepare_device_group`), and one
device pass per group runs the filterbank (``synthesis.filterbank_fast``) or
the device dequantization plus filterbank
(``synthesis.dequant_filterbank``).  A stream's overlap and window shape
carry across groups in :class:`_StreamState`, as numpy arrays like the JAX
package's; each hook takes the ``device`` its pass runs on.  The per-frame
object path (``decode_frames``, ``CodecAacAdts``) is not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..._host import aac_bitstream as BS
from ..._host import aac_tables as T
from . import synthesis as SYN

NCFG = 4
MAX_SIDE = 16


class _StreamState:
    """Carries filterbank overlap + window shape across groups."""

    def __init__(self, channels: int):
        self.prev_shape = np.zeros(channels, np.int32)
        self.overlap = np.zeros((channels, 1024), np.float32)


def _tensors(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in arrays]


def _to_pcm(pcm, channels: int, bit_depth: int) -> np.ndarray:
    """(T, C, 1024) float PCM -> (C, T*1024) int32 rounded half to even and
    clipped to the bit depth's range, as the JAX package's host does."""
    lo, hi = -(1 << (bit_depth - 1)), (1 << (bit_depth - 1)) - 1
    out = torch.round(pcm).clamp(lo, hi).to(torch.int32).cpu().numpy()
    return out.transpose(1, 0, 2).reshape(channels, -1)


def decode_group_arrays(batch: dict, nframes: int, channels: int,
                        state: _StreamState, bit_depth: int = 16, *,
                        device) -> np.ndarray:
    """Array-native decode: host spectral prep (``prepare_group``) feeding
    the filterbank on ``device``.  Returns (channels, nframes*1024) int32 and
    advances ``state``."""
    specs, opidx = SYN.prepare_group(batch, nframes, channels,
                                     state.prev_shape)
    spec_t, op_t, ov = _tensors(device, specs, opidx, state.overlap)
    pcm, new_ov = SYN.filterbank_fast(spec_t, op_t, ov,
                                      *SYN.filterbank_constants(device=device))
    state.overlap = new_ov.cpu().numpy()
    return _to_pcm(pcm, channels, bit_depth)


def prepare_device_group(batch: dict, nframes: int, channels: int,
                         prev_shape: np.ndarray,
                         cfg_map: Optional[dict] = None
                         ) -> Optional[dict]:
    """Assemble the numpy inputs of SYN.dequant_filterbank for one parsed
    group (shared cfg_map lets callers batch multiple streams into one
    dispatch).  Returns None when the group doesn't fit the fast path:
    mono, more than NCFG layout configs, or more than MAX_SIDE special
    rows."""
    ri = batch["rate_index"]
    F, C = nframes, channels
    R = F * C
    if R == 0 or C != 2:
        return None
    if cfg_map is None:
        cfg_map = {}
    ics = batch["ics"][:R]
    cb = batch["cb"][:R]
    sf = batch["sf"][:R]
    quant = batch["quant"][:R]
    # layout configs (cfg_map is shared across streams by callers that
    # stack several parses into one dispatch — do not rebind it)
    cfg_idx = np.zeros(R, np.int32)
    for r in range(R):
        seq = int(ics[r][0])
        short = seq == BS.EIGHT_SHORT
        key = (ri, seq if short else 0, int(ics[r][3]) if short else 0,
               int(ics[r][2]))
        if key not in cfg_map and len(cfg_map) >= NCFG:
            return None
        cfg_idx[r] = cfg_map.setdefault(key, len(cfg_map))
    # cb/sf rows are SFB_SLOTS (=128) wide; band indices span [0, 120)
    coded = np.zeros((R, 128), np.uint8)
    coded[:, :120] = (cb[:, :120] >= 1) & (cb[:, :120] <= 11)
    sf128 = np.zeros((R, 128), np.int16)
    sf128[:, :120] = np.clip(sf[:, :120], -32768, 32767)
    # M/S band mask per pair (excluding intensity/noise bands), vectorized
    ms = batch["msmask"][:F]
    ms_flag = np.zeros((F, 128), np.uint8)
    flag = ms[:, 0]
    ms_flag[flag == 2, :120] = 1
    per_band = flag == 1
    if per_band.any():
        ms_flag[per_band, :120] = ms[per_band, 1:121] != 0
    cbr = cb[1::C, :120]                  # right-channel codebooks (F, 120)
    bad = ((cbr == T.NOISE_CB) | (cbr == T.INTENSITY_CB)
           | (cbr == T.INTENSITY_CB2))
    ms_flag[:, :120][bad] = 0
    # exception rows: TNS / intensity / PNS / int16 overflow
    special = (batch["tnsn"][:R].any(axis=1)
               | (cb >= T.NOISE_CB).any(axis=1))
    frames_special = np.unique(np.where(special)[0] // C)
    if len(frames_special) * C > MAX_SIDE:
        return None
    side_spec = np.zeros((MAX_SIDE, 1024), np.float32)
    side_row = np.full(MAX_SIDE, -1, np.int32)
    dummy_shape = np.zeros(C, np.int32)
    for si, f in enumerate(frames_special):
        sub = {k: (v[f * C:(f + 1) * C] if k not in ("msmask", "rate_index")
                   else (v[f:f + 1] if k == "msmask" else v))
               for k, v in batch.items()}
        sp, _ = SYN.prepare_group(sub, 1, C, dummy_shape.copy())
        for c in range(C):
            side_spec[si * C + c] = sp[0, c]
            side_row[si * C + c] = f * C + c
    # opidx + shape tracking (prev window shape chains frame to frame)
    seqs = ics[:R, 0].astype(np.int32).reshape(F, C)
    shapes = ics[:R, 1].astype(np.int32).reshape(F, C)
    prevs = np.vstack([prev_shape[None, :C], shapes[:-1]])
    opidx = seqs * 4 + prevs * 2 + shapes
    prev_shape[:C] = shapes[-1]
    qt = quant.reshape(F, C, 1024)
    return dict(quant=qt, sf=sf128.reshape(F, C, 128),
                coded=coded.reshape(F, C, 128),
                cfg_idx=cfg_idx.reshape(F, C),
                ms_flag=ms_flag.reshape(F, C // 2, 128),
                side_spec=side_spec, side_row=side_row, opidx=opidx,
                cfg_map=cfg_map)


def cfg_tables(cfg_map: dict,
               ncfg: Optional[int] = None) -> tuple[np.ndarray, np.ndarray]:
    """(perm_tab, band_tab) (max(ncfg, configs), 1024) int32: per layout
    config, dst -> transmission position and dst -> band slot (127 =
    silent)."""
    rows = max(ncfg or NCFG, len(cfg_map))
    perm_tab = np.zeros((rows, 1024), np.int32)
    band_tab = np.full((rows, 1024), 127, np.int32)
    for key, i in cfg_map.items():
        if key[3] == 0:
            continue
        src, dst, band = SYN._layout(*key)
        perm_tab[i][dst] = src
        band_tab[i][dst] = band
    return perm_tab, band_tab


def run_device_group(prep: dict, overlap: np.ndarray, bit_depth: int = 16,
                     *, device) -> tuple[np.ndarray, np.ndarray]:
    """Dispatch one assembled group on ``device``; returns (pcm (C, n)
    int32, overlap (C, 1024) float32)."""
    perm_tab, band_tab = cfg_tables(prep["cfg_map"])
    args = _tensors(device, prep["quant"], prep["sf"], prep["coded"],
                    prep["cfg_idx"], perm_tab, band_tab, prep["ms_flag"],
                    prep["side_spec"], prep["side_row"], prep["opidx"],
                    overlap)
    pcm, new_ov = SYN.dequant_filterbank(
        *args, *SYN.filterbank_constants(device=device))
    return (_to_pcm(pcm, prep["quant"].shape[1], bit_depth),
            new_ov.cpu().numpy())


def decode_group_device(batch: dict, nframes: int, channels: int,
                        state: _StreamState, bit_depth: int = 16, *,
                        device) -> Optional[np.ndarray]:
    """Device-dequant decode path (single stream); None -> the caller falls
    back to decode_group_arrays."""
    prep = prepare_device_group(batch, nframes, channels, state.prev_shape)
    if prep is None:
        return None
    out, state.overlap = run_device_group(prep, state.overlap, bit_depth,
                                          device=device)
    return out
