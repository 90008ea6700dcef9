"""AAC-LC and HE-AAC decode on tensors: the device hooks and the ADTS codec
plug-in.

Port of ``ohpipeline_tpu.codecs.aac``.  The array-native hooks: the host
parser (``native.aac_parse_group``) yields numpy arrays, the host prepares
them (``synthesis.prepare_group`` or :func:`prepare_device_group`), and one
device pass per group runs the filterbank (``synthesis.filterbank_fast``) or
the device dequantization plus filterbank
(``synthesis.dequant_filterbank``).  A stream's overlap and window shape
carry across groups in :class:`_StreamState`, as numpy arrays like the JAX
package's; each hook takes the ``device`` its pass runs on.

:class:`CodecAacAdts` is the ADTS plug-in (``recognise``,
``stream_initialise``, ``process``): AAC-LC groups of :data:`GROUP_FRAMES`
frames through the native unpacker and ``decode_group_arrays``, or through
the Python parser and the per-frame object path (:func:`decode_frames`);
HE-AAC groups of :data:`SBR_GROUP_FRAMES` frames through the SBR device
runners of ``sbr``, one group in flight: v1 through
``SbrDeviceRunner.decode_group_multi_lazy_spec``, v2 (parametric stereo)
through ``SbrPsDeviceRunner.decode_group_lazy_spec``, both with the LC core's
IMDCT fused on the device.  A group the device path does not take (a frame
without an SBR payload, a header change inside the group, PS before the
first PS parameters) is the content the reference also routes through the
per-frame numpy chain (``sbr.py``'s ``SbrDecoder``), which stays here as it
is there.  :class:`CodecAacMp4` is the MP4 plug-in: the sample tables of
the host ``containers/mpeg4.py``, the AudioSpecificConfig
(:func:`parse_audio_specific_config`), AAC-LC groups of
:data:`GROUP_FRAMES` frames as deferred batches (:func:`decode_frames`) and
HE-AAC groups of :data:`SBR_GROUP_FRAMES` frames through the same SBR
runners as the ADTS plug-in.  The ADTS plug-in's AAC-LC spans are
``codec.parse`` (the native group parse) and, in :func:`decode_group_arrays`,
``codec.prep`` (the host spectral prep, TNS included) and ``codec.device``
(upload, filterbank, copy back of PCM and overlap).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ... import _kernels
from ..._host import aac_bitstream as BS
from ..._host import aac_native, sbr_native
from ..._host import aac_sbr as SBR
from ..._host import aac_tables as T
from ...host.codecs.base import (BufferReader, CodecBase, CodecStreamCorrupt,
                                 DecodedBatch, EndOfStream, StreamReader)
from ...host.codecs.flac.bitreader import BitReader
from ...host.core.jiffies import Jiffies
from ...host.core.streaminfo import PcmStreamInfo
from ...tracing import count, nbytes, span
from . import sbr as SBRD
from . import synthesis as SYN

GROUP_FRAMES = 32
#: HE-AAC groups are larger: the SBR device pass runs whole groups, so fewer,
#: larger groups cost fewer dispatches and copies.
SBR_GROUP_FRAMES = 96


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


def decode_frames(frames: list, state: _StreamState, bit_depth: int = 16, *,
                  device) -> np.ndarray:
    """Decode parsed frames (``BS.FrameData``) -> (channels, T*1024) int32:
    the host prep of :func:`group_specs_from_frames`, then
    ``synthesis.filterbank`` over the operator banks on ``device``."""
    if not frames:
        return np.zeros((len(state.prev_shape), 0), np.int32)
    specs, opidx = group_specs_from_frames(frames, state)
    spec_t, op_t, ov = _tensors(device, specs, opidx,
                                np.asarray(state.overlap, np.float32))
    pcm, new_ov = SYN.filterbank(spec_t, op_t, ov,
                                 *SYN.operator_bank_constants(device=device))
    state.overlap = new_ov.cpu().numpy()
    return _to_pcm(pcm, specs.shape[1], bit_depth)


def decode_frames_float(frames: list, state: _StreamState) -> np.ndarray:
    """decode_frames without the final integer clip, in float64 numpy: the
    core signal the per-frame SBR chain consumes ((C, T*1024))."""
    if not frames:
        return np.zeros((len(state.prev_shape), 0))
    nch = len(frames[0].channels)
    W, SW = SYN.window_bank()
    ML = SYN._imdct_matrix(2048).astype(np.float64)
    MS = SYN._imdct_matrix(256).astype(np.float64)
    if state.overlap is None or np.ndim(state.overlap) != 2:
        state.overlap = np.zeros((nch, 1024))
    out = np.zeros((nch, len(frames) * 1024))
    for t, frame in enumerate(frames):
        chs = frame.channels
        sp = [SYN.dequantize(ch, frame.rate_index) for ch in chs]
        SYN.apply_spectral_tools(frame, sp)
        for ci, ch in enumerate(chs):
            SYN.apply_tns(ch, sp[ci], frame.rate_index)
            mode = ch.ics.window_sequence
            opidx = (mode * 4 + int(state.prev_shape[ci]) * 2
                     + ch.ics.window_shape)
            state.prev_shape[ci] = ch.ics.window_shape
            if mode == BS.EIGHT_SHORT:
                xs = sp[ci].reshape(8, 128) @ MS * SW[opidx & 3]
                x = np.zeros(2048)
                for w in range(8):
                    x[448 + w * 128:448 + w * 128 + 256] += xs[w]
            else:
                x = sp[ci] @ ML * W[opidx]
            out[ci, t * 1024:(t + 1) * 1024] = x[:1024] \
                + state.overlap[ci]
            state.overlap[ci] = x[1024:]
    return out


def group_specs_from_frames(frames: list, state: _StreamState) -> tuple:
    """Prepared spectra + operator indices for a group of parsed frames
    (host dequant, spectral tools and TNS only; the IMDCT runs wherever the
    caller wants it).  Returns (specs (F, C, 1024) f32, ops (F, C) i32);
    advances state.prev_shape."""
    nch = len(frames[0].channels)
    F = len(frames)
    specs = np.zeros((F, nch, 1024), np.float32)
    ops = np.zeros((F, nch), np.int32)
    for t, frame in enumerate(frames):
        chs = frame.channels
        sp = [SYN.dequantize(ch, frame.rate_index) for ch in chs]
        SYN.apply_spectral_tools(frame, sp)
        for ci, ch in enumerate(chs):
            SYN.apply_tns(ch, sp[ci], frame.rate_index)
            mode = ch.ics.window_sequence
            ops[t, ci] = (mode * 4 + int(state.prev_shape[ci]) * 2
                          + ch.ics.window_shape)
            state.prev_shape[ci] = ch.ics.window_shape
            specs[t, ci] = sp[ci]
    return specs, ops


def _core_float_from_specs(specs: np.ndarray, ops: np.ndarray,
                           state: _StreamState) -> np.ndarray:
    """Batched float32 numpy IMDCT + window + overlap-add from prepared
    spectra: specs (F, C, 1024) f32, ops (F, C) i32 operator indices.
    Updates state.overlap; returns float64 (C, F*1024)."""
    F, nch = specs.shape[:2]
    W, SW = SYN.window_bank()
    ML = SYN._imdct_matrix(2048).astype(np.float32)
    MS = SYN._imdct_matrix(256).astype(np.float32)
    if state.overlap is None or np.ndim(state.overlap) != 2:
        state.overlap = np.zeros((nch, 1024))
    flat = specs.reshape(F * nch, 1024)
    x_long = (flat @ ML) * W[ops.reshape(-1)].astype(np.float32)
    is_short = (ops.reshape(-1) >> 2) == BS.EIGHT_SHORT
    if is_short.any():
        xs = np.einsum("rwk,kn->rwn", flat.reshape(-1, 8, 128), MS) \
            * SW[ops.reshape(-1) & 3].astype(np.float32)
        x_short = np.zeros((F * nch, 2048), np.float32)
        for w in range(8):
            x_short[:, 448 + w * 128:448 + w * 128 + 256] += xs[:, w]
        x_long = np.where(is_short[:, None], x_short, x_long)
    x = x_long.reshape(F, nch, 2048).astype(np.float64)
    out = np.zeros((nch, F * 1024))
    for t in range(F):
        out[:, t * 1024:(t + 1) * 1024] = x[t, :, :1024] + state.overlap
        state.overlap = x[t, :, 1024:]
    return out


def decode_group_arrays(batch: dict, nframes: int, channels: int,
                        state: _StreamState, bit_depth: int = 16, *,
                        device) -> np.ndarray:
    """Array-native decode: host spectral prep (``prepare_group``) feeding
    the filterbank on ``device``.  Returns (channels, nframes*1024) int32 and
    advances ``state``."""
    with span("codec.prep"):
        specs, opidx = SYN.prepare_group(batch, nframes, channels,
                                         state.prev_shape)
    with span("codec.device"):
        spec_t, op_t, ov = _tensors(device, specs, opidx, state.overlap)
        consts = SYN.filterbank_constants(device=device)
        count("h2d_bytes.codec.upload", nbytes(spec_t, op_t, ov))
        count("h2d_bytes.codec.constants", nbytes(*consts))
        count("groups.codec")
        pcm, new_ov = SYN.filterbank_fast(spec_t, op_t, ov, *consts)
        # the PCM comes back as int32 (_to_pcm), as wide as the float32
        count("d2h_bytes.codec.copy_back", new_ov.nbytes + pcm.nbytes)
        state.overlap = new_ov.cpu().numpy()
        return _to_pcm(pcm, channels, bit_depth)


NCFG = 4
MAX_SIDE = 16


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


def frames_from_arrays(batch: dict, nframes: int, channels: int) -> list:
    """Rehydrate ``BS.FrameData`` from the native unpacker's dense arrays."""
    frames = []
    ri = batch["rate_index"]
    for f in range(nframes):
        chs = []
        for c in range(channels):
            r = f * channels + c
            ics_row = batch["ics"][r]
            ch = BS.ChannelData()
            ch.ics = BS.IcsInfo(int(ics_row[0]), int(ics_row[1]),
                                int(ics_row[2]), int(ics_row[3]))
            ngroups = len(ch.ics.window_groups())
            msfb = max(ch.ics.max_sfb, 1)
            cb = np.zeros((ngroups, msfb), np.int8)
            sf = np.zeros((ngroups, msfb), np.int32)
            for g in range(ngroups):
                cb[g, :ch.ics.max_sfb] = \
                    batch["cb"][r][g * 15:g * 15 + ch.ics.max_sfb]
                sf[g, :ch.ics.max_sfb] = \
                    batch["sf"][r][g * 15:g * 15 + ch.ics.max_sfb]
            ch.band_cb = cb
            ch.scalefactors = sf
            ch.quant = batch["quant"][r]
            if batch["tnsn"][r].any():
                tns = BS.TnsData()
                for w in range(ch.ics.num_windows):
                    filters = []
                    for fi in range(int(batch["tnsn"][r][w])):
                        length, order, direction = (
                            int(x) for x in batch["tnsp"][r][w * 3 + fi])
                        coeffs = batch["tnsc"][r][w * 3 + fi][:order]
                        filters.append((length, order, direction, coeffs))
                    tns.filters.append(filters)
                ch.tns = tns
            chs.append(ch)
        ms = batch["msmask"][f]
        mask = None
        if channels == 2 and ms[0] != 0xFF and ms[0] != 0:
            ics0 = chs[0].ics
            ngroups = len(ics0.window_groups())
            msfb = max(ics0.max_sfb, 1)
            if ms[0] == 2:
                mask = np.ones((ngroups, msfb), bool)
            else:
                mask = np.zeros((ngroups, msfb), bool)
                for g in range(ngroups):
                    mask[g, :ics0.max_sfb] = \
                        ms[1 + g * 15:1 + g * 15 + ics0.max_sfb] != 0
        frames.append(BS.FrameData(chs, mask, ri))
    return frames


class CodecAacAdts(CodecBase):
    """ADTS-framed AAC-LC and HE-AAC (v1, and v2 with parametric stereo)
    (reference CodecAacFdkAdts), decoding on ``device``.  ``use_native``
    None or True parses with the port's native unpacker (built on first
    use; a failed build raises), False with the Python parser."""

    name = "AAC"
    recognition_cost = 30
    mime_types = ("audio/aac", "audio/aacp", "audio/mp4")

    def __init__(self, use_native: Optional[bool] = None, *, device="cuda"):
        self._info: Optional[PcmStreamInfo] = None
        self._buf = b""
        self._state: Optional[_StreamState] = None
        self._hdr: Optional[BS.AdtsHeader] = None
        self._sample_pos = 0
        self._sbr_pending: Optional[tuple] = None
        self._use_native = use_native is None or use_native
        self._device = torch.device(device)

    def recognise(self, header: bytes) -> bool:
        # two consecutive valid ADTS headers (the reference requires the
        # same double-sync to avoid false positives)
        h1 = BS.parse_adts_header(header)
        if h1 is None:
            return False
        h2 = BS.parse_adts_header(header, h1.frame_bytes)
        return h2 is not None and h2.rate_index == h1.rate_index

    def stream_initialise(self, reader: StreamReader) -> PcmStreamInfo:
        self._buf = reader.read(64 * 1024)
        self._reader = reader
        hdr = BS.parse_adts_header(self._buf)
        if hdr is None:
            raise CodecStreamCorrupt("no ADTS sync")
        self._hdr = hdr
        self._state = _StreamState(hdr.channels)
        self._sample_pos = 0
        # HE-AAC: a low core rate with SBR extension payloads doubles the
        # output rate (reference: AacFdkBase.cpp decodes HE via libSBRdec)
        self._sbr = None
        self._ps = False
        if hdr.sample_rate <= 24000:
            try:
                br = BitReader(self._buf, hdr.header_bytes * 8)
                fr = BS.parse_raw_data_block(br, hdr.rate_index)
                if fr.sbr is not None:
                    sbr_native()
                    self._sbr = SBR.SbrDecoder(hdr.sample_rate)
                    if hdr.channels == 1:
                        # Probe with a throwaway decoder: parse_payload
                        # advances delta-coding state (_parse_prev/_ps_prev)
                        # and process() re-parses this same first frame.
                        probe = SBR.SbrDecoder(hdr.sample_rate)
                        chans, _c = probe.parse_payload(
                            fr.sbr[0], fr.sbr[1], stereo=False,
                            crc=fr.sbr[2])
                        # PS rides the SBR extension: implicit v2
                        self._ps = chans[0].ps is not None
            except (BS.AacError, SBR.SbrError, ValueError, EOFError):
                # a first frame that does not parse: plain AAC-LC
                self._sbr = None
                self._ps = False
        rate = hdr.sample_rate * (2 if self._sbr else 1)
        spf = 1024 * (2 if self._sbr else 1)
        total = reader.stream_bytes
        length_j = 0
        if total:
            # estimate duration from first-frame size (CBR-ish)
            frames = total // max(hdr.frame_bytes, 1)
            length_j = frames * spf * Jiffies.per_sample(rate)
        name = "AAC"
        if self._sbr:
            name = "HE-AAC v2" if self._ps else "HE-AAC"
        self._info = PcmStreamInfo(
            sample_rate=rate, bit_depth=16,
            num_channels=2 if self._ps else hdr.channels,
            codec_name=name, lossless=False,
            seekable=False,
            bitrate=hdr.frame_bytes * 8 * hdr.sample_rate // 1024,
            track_length_jiffies=length_j)
        return self._info

    def _fill(self, want: int) -> None:
        while len(self._buf) < want:
            chunk = self._reader.read(128 * 1024)
            if not chunk:
                return
            self._buf += chunk

    def process(self, reader: StreamReader) -> DecodedBatch:
        group = SBR_GROUP_FRAMES if self._sbr is not None else GROUP_FRAMES
        self._fill(self._hdr.frame_bytes * (group + 2))
        if self._sbr is not None:
            return self._process_sbr()
        state, ch, dev = self._state, self._hdr.channels, self._device
        if self._use_native:
            with span("codec.parse"):
                n, pos, batch = aac_native().aac_parse_group(
                    self._buf, 0, channels=ch, max_frames=GROUP_FRAMES)
            self._buf = self._buf[pos:]
            if n == 0:
                raise EndOfStream
            first = self._sample_pos
            self._sample_pos += n * 1024
            return DecodedBatch(
                self._info,
                defer=lambda: decode_group_arrays(batch, n, ch, state,
                                                  device=dev),
                track_offset_samples=first)
        frames = self._parse_python_frames(GROUP_FRAMES)
        if not frames:
            raise EndOfStream
        first = self._sample_pos
        self._sample_pos += len(frames) * 1024
        return DecodedBatch(
            self._info, defer=lambda: decode_frames(frames, state, device=dev),
            track_offset_samples=first)

    def _parse_python_frames(self,
                             max_frames: int = SBR_GROUP_FRAMES) -> list:
        """Up to ``max_frames`` frames from the buffer through the Python
        parser, resyncing past damage; frames that do not parse, or carry
        another channel count, are dropped."""
        frames: list = []
        pos = 0
        while len(frames) < max_frames:
            hdr = BS.parse_adts_header(self._buf, pos)
            if hdr is None:
                nxt = self._buf.find(b"\xff", pos + 1)
                if nxt == -1 or nxt + 7 > len(self._buf):
                    break
                pos = nxt
                continue
            if pos + hdr.frame_bytes > len(self._buf):
                break
            br = BitReader(self._buf, (pos + hdr.header_bytes) * 8)
            try:
                frame = BS.parse_raw_data_block(br, hdr.rate_index)
                if len(frame.channels) == self._hdr.channels:
                    frames.append(frame)
            except (BS.AacError, ValueError, EOFError):
                pass
            pos += hdr.frame_bytes
        self._buf = self._buf[pos:]
        return frames

    def _parse_native_sbr_group(self) -> tuple:
        """HE-AAC group parse through the native unpacker (the LC parse
        plus each frame's SBR fill payload): (nframes, batch) with the dense
        arrays kept as they are; the decode preps spectra from them and
        rehydrates frame objects only for the per-frame numpy chain."""
        n, pos, batch = aac_native().aac_parse_group_sbr(
            self._buf, 0, channels=self._hdr.channels,
            max_frames=SBR_GROUP_FRAMES)
        self._buf = self._buf[pos:]
        return n, batch

    def _parse_dispatch_sbr_group(self) -> Optional[tuple]:
        """Parse one SBR group and queue its decode.  Returns (resolve,
        track offset, nsamples), or None at the end of the stream."""
        self._fill(self._hdr.frame_bytes * (SBR_GROUP_FRAMES + 2))
        frames = batch = None
        if self._use_native:
            n, batch = self._parse_native_sbr_group()
        else:
            frames = self._parse_python_frames()
            n = len(frames)
        if not n:
            return None
        resolve, ns = _sbr_decode_frames_lazy(
            frames, self._state, self._sbr, self._hdr.channels, ps=self._ps,
            batch=batch, nframes=n, device=self._device)
        first = self._sample_pos
        self._sample_pos += ns
        return resolve, first, ns

    def _process_sbr(self) -> DecodedBatch:
        """One group in flight: group k's device pass runs while this call
        parses and queues group k+1; the returned batch is the oldest group
        queued (offsets carried per group, so timing is exact, one group
        of added latency)."""
        if self._sbr_pending is None:
            self._sbr_pending = self._parse_dispatch_sbr_group()
            if self._sbr_pending is None:
                raise EndOfStream
        nxt = self._parse_dispatch_sbr_group()
        resolve, first, _ns = self._sbr_pending
        self._sbr_pending = nxt
        return DecodedBatch(self._info, samples=resolve(),
                            track_offset_samples=first)


def _sbr_decode_frames(frames, state, sbr, nch, ps: bool = False,
                       batch: Optional[dict] = None, nframes: int = 0, *,
                       device) -> np.ndarray:
    """Core decode + SBR reconstruction for a group of parsed frames, as
    (C, F*2048) int32 (2 channels with ``ps``: the mono core becomes stereo
    through the parametric-stereo tool).  A regular group runs on
    ``device``; an irregular one through the per-frame numpy chain (see
    :func:`_sbr_decode_frames_lazy`)."""
    resolve, _ns = _sbr_decode_frames_lazy(frames, state, sbr, nch, ps=ps,
                                           batch=batch, nframes=nframes,
                                           device=device)
    return resolve()


def _sbr_decode_frames_lazy(frames, state, sbr, nch, ps: bool = False,
                            batch: Optional[dict] = None, nframes: int = 0,
                            *, device) -> tuple:
    """:func:`_sbr_decode_frames` with the device pass queued: returns
    (resolve, nsamples_out), where ``resolve()`` copies the PCM back, so the
    caller can parse and queue the next group first.  Groups the device
    path declines (a frame without an SBR payload, a header change inside
    the group, or, with PS, no PS parameters yet) take the per-frame numpy
    chain of ``sbr.py``, as in the reference; that output is made at once
    (resolve is then free)."""
    if not ps:
        out = _sbr_decode_frames_device(frames, state, sbr, nch, batch=batch,
                                        nframes=nframes, lazy=True,
                                        device=device)
    else:
        out = _sbr_decode_frames_device_ps(frames, state, sbr, batch=batch,
                                           nframes=nframes, lazy=True,
                                           device=device)
    if out is not None:
        F = nframes if batch is not None else len(frames)
        return out, F * 2048
    # the device path fused the LC core: its overlap tail must come
    # back to the host before the per-frame numpy chain continues
    _sync_core_overlap(sbr, state)
    if frames is None:
        # a native-parsed group: rehydrate objects for the numpy chain
        frames = frames_from_arrays(batch, nframes, nch)
        for f, fr in enumerate(frames):
            fr.sbr = batch["sbr"][f]
    outs = []
    for fr in frames:
        core = decode_frames_float([fr], state)
        if fr.sbr is not None:
            payload, nbits, crc = fr.sbr
            try:
                chans, coupling = sbr.parse_payload(
                    payload, nbits, stereo=(nch == 2), crc=crc)
                if ps:
                    outs.append(sbr.process_frame_ps(core, chans))
                else:
                    outs.append(sbr.process_frame(core, chans, coupling))
                continue
            except SBR.SbrError:
                pass
        # no/invalid payload: plain 2x hold upsample keeps timing
        up = np.repeat(core, 2, axis=1)
        outs.append(np.repeat(up, 2, axis=0) if ps else up)
    pcm = np.concatenate(outs, axis=1)
    pcm = np.clip(np.rint(pcm), -32768, 32767).astype(np.int32)
    return (lambda: pcm), pcm.shape[1]


def _sync_core_overlap(sbr, state: _StreamState) -> None:
    """Pull the fused core-overlap tail back from any device runner into the
    host _StreamState: called before a group of the numpy chain (or a
    runner rebuild), so the LC filterbank chain stays continuous across
    path switches."""
    for attr in ("_device_runner", "_ps_device_runner"):
        r = getattr(sbr, attr, None)
        if r is not None:
            ov = r.fetch_core_overlap()
            if ov is not None:
                nch = len(state.prev_shape)
                state.overlap = np.asarray(ov, np.float64) \
                    .reshape(-1, 1024)[:nch]


def _parse_group(sbr, payloads: list, nch: int, ps: bool) -> Optional[list]:
    """Parse and dequantise a group's SBR payloads for the device path, or
    return None (with the decoder's delta-coding state restored, so the
    numpy chain re-parses the same payloads) for a group it does not take:
    a missing payload, a header change inside the group, or a PS frame in
    a v1 group.  Returns per frame (channel data, dequantised levels per
    channel)."""
    header0 = sbr.header
    # shallow list copy: parsing REPLACES _parse_prev items (tuples of
    # fresh rows), never mutates them, so restoring the list restores the
    # state
    pp = getattr(sbr, "_parse_prev", None)
    snap = (list(pp) if pp is not None else None,
            getattr(sbr, "_ps_prev", None))
    parsed = []
    try:
        for pl in payloads:
            if pl is None:
                raise SBR.SbrError("missing payload in group")
            payload, nbits, crc = pl
            chans, coupling = sbr.parse_payload(payload, nbits,
                                                stereo=(nch == 2), crc=crc)
            if header0 is not None and sbr.header != header0:
                raise SBR.SbrError("header change mid-group")
            header0 = sbr.header
            if not ps and chans[0].ps is not None and nch == 1:
                raise SBR.SbrError("PS stream")
            EQ = [sbr.dequant(sbr.header, chans[i].grid, chans[i].env,
                              chans[i].noise) for i in range(nch)]
            if nch == 2 and coupling:
                a = EQ[0][2]
                (EL, QL), (ER, QR) = sbr.unmap_coupled(
                    EQ[0][0], EQ[0][1], chans[1].env, chans[1].noise, a)
                EQ = [(EL, QL, a), (ER, QR, a)]
            parsed.append((chans, EQ))
    except SBR.SbrError:
        if snap[0] is not None:
            sbr._parse_prev = snap[0]
        sbr._ps_prev = snap[1]
        return None
    return parsed


def _group_specs(frames, state, batch, F: int, nch: int) -> tuple:
    """A group's prepared core spectra and operator indices, from the
    native arrays or the frame objects; advances state.prev_shape."""
    if batch is not None:
        return SYN.prepare_group(batch, F, nch, state.prev_shape)
    return group_specs_from_frames(frames, state)


def _sbr_decode_frames_device_ps(frames, state, sbr,
                                 batch: Optional[dict] = None,
                                 nframes: int = 0, lazy: bool = False, *,
                                 device):
    """HE-AAC v2 group on ``device``: mono core + SBR + parametric stereo
    (``SbrPsDeviceRunner``), the core's IMDCT fused there.  Returns None for
    a group the numpy chain takes; with ``lazy`` a zero-argument function
    that copies the (2, F*2048) int32 PCM back, else the PCM."""
    payloads = (batch["sbr"][:nframes] if batch is not None
                else [fr.sbr for fr in frames])
    parsed = _parse_group(sbr, payloads, 1, True)
    if parsed is None:
        return None
    header0 = sbr.header
    runner = getattr(sbr, "_ps_device_runner", None)
    if runner is None or runner.dec is not sbr \
            or runner.static_header != header0:
        _sync_core_overlap(sbr, state)  # old runner may hold the tail
        runner = SBRD.SbrPsDeviceRunner(sbr, device=device)
        runner.static_header = header0
        sbr._ps_device_runner = runner
    if runner.pdec_host.last_ps is None and parsed[0][0][0].ps is None:
        return None              # no PS parameters yet: numpy handles it
    F = nframes if batch is not None else len(frames)
    specs, ops = _group_specs(frames, state, batch, F, 1)
    resolve = runner.decode_group_lazy_spec(
        specs[:, 0], ops[:, 0], [c[0] for c, _ in parsed],
        [eq[0][0] for _, eq in parsed], [eq[0][1] for _, eq in parsed],
        [c[0].ps for c, _ in parsed], state.overlap[0])
    if lazy:
        return lambda: resolve().astype(np.int32)
    return resolve().astype(np.int32)


def _sbr_decode_frames_device(frames, state, sbr, nch,
                              batch: Optional[dict] = None, nframes: int = 0,
                              lazy: bool = False, *, device):
    """HE-AAC v1 group on ``device`` (every frame carries a payload, one
    header): ``SbrDeviceRunner`` in spec mode, the core's IMDCT fused there.
    Returns None for a group the numpy chain takes; with ``lazy`` a
    zero-argument function that copies the (C, F*2048) int32 PCM back,
    else the PCM."""
    payloads = (batch["sbr"][:nframes] if batch is not None
                else [fr.sbr for fr in frames])
    parsed = _parse_group(sbr, payloads, nch, False)
    if parsed is None:
        return None
    header0 = sbr.header
    runner = getattr(sbr, "_device_runner", None)
    if runner is None or runner.dec is not sbr \
            or runner.static_header != header0:
        _sync_core_overlap(sbr, state)  # old runner may hold the tail
        runner = SBRD.SbrDeviceRunner(sbr, nch, device=device)
        runner.static_header = header0
        sbr._device_runner = runner
    F = nframes if batch is not None else len(frames)
    specs, ops = _group_specs(frames, state, batch, F, nch)
    per_ch = [([c[ch] for c, _ in parsed], [eq[ch][0] for _, eq in parsed],
               [eq[ch][1] for _, eq in parsed]) for ch in range(nch)]
    resolve = runner.decode_group_multi_lazy_spec(
        np.ascontiguousarray(specs.transpose(1, 0, 2)),
        np.ascontiguousarray(ops.T), per_ch, state.overlap)
    return resolve if lazy else resolve()


def parse_audio_specific_config(asc: bytes) -> tuple:
    """AudioSpecificConfig -> (rate_index, channels, sbr_explicit,
    ps_explicit).  Accepts AOT 2 (LC) and the AOT 5/29 explicit-SBR
    hierarchy whose core is LC (tpdec_asc.cpp AudioSpecificConfig_Parse:
    aot, samplingFrequencyIndex, channelConfiguration, then for 5/29 the
    extension rate and the core AOT).  AOT 29 signals the parametric-stereo
    tool: the caller forces 2-channel output even if the first frame
    carries no ps_data yet, as fdk's tpdec_asc does."""
    br = BitReader(asc)
    aot = br.read(5)
    rate_idx = br.read(4)
    if rate_idx == 0xF:
        br.read(24)
        raise CodecStreamCorrupt("explicit AAC sample rate unsupported")
    channels = br.read(4)
    sbr_explicit = False
    ps_explicit = aot == 29
    if aot in (5, 29):
        ext_idx = br.read(4)
        if ext_idx == 0xF:
            br.read(24)
        aot = br.read(5)
        sbr_explicit = True
    if aot != 2:
        raise CodecStreamCorrupt(f"not AAC-LC (AOT {aot})")
    return rate_idx, channels, sbr_explicit, ps_explicit


class CodecAacMp4(CodecBase):
    """AAC-LC / HE-AAC (v1, v2) in MP4 (reference CodecAacFdkMp4), decoding
    on ``device``: the ISO-BMFF sample tables of the host
    ``containers/mpeg4.py``; SBR is found explicitly (an AOT 5/29
    AudioSpecificConfig) and implicitly (a low-rate LC track whose first
    sample carries an SBR payload).  Frames parse with the Python parser, as
    in the JAX plug-in.  Every error of the probes goes on as the JAX
    plug-in's does (not recognised, plain AAC-LC), except a device fault,
    which is raised."""

    name = "AAC-MP4"
    recognition_cost = 25
    mime_types = ("audio/mp4", "audio/m4a")

    def __init__(self, *, device="cuda"):
        self._info = None
        self._track = None
        self._samples = None
        self._index = 0
        self._state = None
        self._data = b""
        self._device = torch.device(device)

    def recognise(self, header: bytes) -> bool:
        if len(header) < 12 or header[4:8] != b"ftyp":
            return False
        from ...host.containers.mpeg4 import find_audio_track
        try:
            track = find_audio_track(header)
        except Exception as exc:                          # noqa: BLE001
            if _kernels.is_device_fault(exc):
                raise
            return False
        return track is not None and track.codec == "mp4a"

    def stream_initialise(self, reader: StreamReader) -> PcmStreamInfo:
        from ...host.containers.mpeg4 import find_audio_track
        self._data = reader.read(reader.stream_bytes or (1 << 30))
        track = find_audio_track(self._data)
        if track is None or track.codec != "mp4a":
            raise CodecStreamCorrupt("no mp4a track")
        asc = track.codec_config
        if len(asc) < 2:
            raise CodecStreamCorrupt("missing AudioSpecificConfig")
        rate_idx, channels, sbr_explicit, ps_explicit = \
            parse_audio_specific_config(asc)
        self._track = track
        self._rate_index = rate_idx
        self._samples = list(track.sample_offsets())
        self._index = 0
        self._sample_pos = 0
        self._state = _StreamState(channels)
        rate = T.SAMPLE_RATES[rate_idx]
        self._sbr = None
        self._ps = False
        if sbr_explicit or rate <= 24000:
            try:
                off, size = self._samples[0]
                br = BitReader(self._data[off:off + size])
                fr = BS.parse_raw_data_block(br, rate_idx)
                if fr.sbr is not None:
                    sbr_native()
                    self._sbr = SBR.SbrDecoder(rate)
                    if channels == 1:
                        # Throwaway probe decoder: parse_payload mutates
                        # delta-coding state and process() re-parses this
                        # same first sample.
                        probe = SBR.SbrDecoder(rate)
                        chs, _c = probe.parse_payload(
                            fr.sbr[0], fr.sbr[1], stereo=False,
                            crc=fr.sbr[2])
                        self._ps = chs[0].ps is not None
            except Exception as exc:                      # noqa: BLE001
                if _kernels.is_device_fault(exc):
                    raise
                self._sbr = None
                self._ps = False
        if ps_explicit and channels == 1:
            # AOT 29 signals PS: HE-AAC v2 stereo even when the first sample
            # carries no ps_data (the header may come later) or the probe
            # failed, as fdk's tpdec_asc does
            if self._sbr is None:
                sbr_native()
                self._sbr = SBR.SbrDecoder(rate)
            self._ps = True
        spf = 1024 * (2 if self._sbr else 1)
        out_rate = rate * (2 if self._sbr else 1)
        name = "AAC"
        if self._sbr:
            name = "HE-AAC v2" if self._ps else "HE-AAC"
        self._info = PcmStreamInfo(
            sample_rate=out_rate, bit_depth=16,
            num_channels=2 if self._ps else channels,
            codec_name=name,
            lossless=False, seekable=self._sbr is None,
            track_length_jiffies=track.total_samples * spf
            * Jiffies.per_sample(out_rate) if track.stts else 0)
        return self._info

    def process(self, reader: StreamReader) -> DecodedBatch:
        if self._index >= len(self._samples):
            raise EndOfStream
        frames = []
        group = SBR_GROUP_FRAMES if self._sbr is not None else GROUP_FRAMES
        while self._index < len(self._samples) and len(frames) < group:
            off, size = self._samples[self._index]
            self._index += 1
            br = BitReader(self._data[off:off + size])
            try:
                frames.append(BS.parse_raw_data_block(br, self._rate_index))
            except (BS.AacError, ValueError, EOFError):
                continue
        if not frames:
            raise EndOfStream
        first = self._sample_pos
        dev = self._device
        if self._sbr is not None:
            pcm = _sbr_decode_frames(
                frames, self._state, self._sbr,
                1 if self._ps else self._info.num_channels, ps=self._ps,
                device=dev)
            self._sample_pos += pcm.shape[1]
            return DecodedBatch(self._info, samples=pcm,
                                track_offset_samples=first)
        self._sample_pos += len(frames) * 1024
        state = self._state
        return DecodedBatch(
            self._info, defer=lambda: decode_frames(frames, state, device=dev),
            track_offset_samples=first)

    def try_seek(self, sample: int) -> Optional[int]:
        idx, pcm0 = self._track.seek_sample(sample)
        self._index = idx
        self._sample_pos = pcm0
        self._state = _StreamState(self._info.num_channels)
        return 0   # data already buffered; no upstream reposition needed


def decode_adts(data: bytes, *, device="cuda") -> tuple:
    """Whole-buffer ADTS decode through :class:`CodecAacAdts` on ``device``:
    returns (PcmStreamInfo, (channels, n) int32 PCM)."""
    codec = CodecAacAdts(device=device)
    r = BufferReader(data)
    info = codec.stream_initialise(r)
    parts = []
    while True:
        try:
            parts.append(codec.process(r).resolve())
        except EndOfStream:
            break
    return info, (np.concatenate(parts, axis=1) if parts
                  else np.zeros((info.num_channels, 0), np.int32))
