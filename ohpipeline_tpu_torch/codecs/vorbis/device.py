"""Batched Vorbis synthesis on tensors: the serving call.

Port of ``ohpipeline_tpu.codecs.vorbis.vorbis_jax``.  The entropy decode
(floors and residues, the native ``vorbis_core.cc`` walk) stays on the host,
in the port's copies under ``host/codecs/vorbis``.  Everything after the
per-channel spectra runs on the device for a group of blocks of every
stream at once:

* for a fixed window configuration (block size, previous and next window
  full or not) the map from a spectrum to its windowed time block is
  linear, and a stream uses five of them (short, and long under the four
  neighbour cases), so each block is one row of a product with its
  configuration's (bs1 / 2, bs1) operator (short operators zero-padded into
  the long layout).  The configuration of each block is known on the host,
  so the rows split by configuration and each meets only its own operator:
  at most five products a group;
* block placement (each centre advances by n_prev / 4 + n / 4) is host
  integer math, shipped as an offset per block; the overlap-add is one
  ``index_add_`` into the group timeline of every stream;
* the group-to-group lap is carried as a fixed (ch, bs1 / 2) tail per
  stream, and the samples are rounded half to even and clipped to int16.

The stream axis is a batch dimension where the JAX package ``vmap``s.
Spectra go up as int16 with a float scale per block and channel (the JAX
package's wire).  Products stay ``torch.matmul`` in full float32, as the
reference runs ``Precision.HIGHEST``: :func:`group_step` first calls
``_kernels.require_full_fp32``, which raises ``KernelError`` when TF32 is on
for float32 matmuls on the card.  The path has no kernel: nothing in it is sequential.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from ... import _kernels
from ...host.codecs.base import BufferReader
from ...host.codecs.vorbis.codebook import VorbisError
from ...host.codecs.vorbis.headers import (parse_comment,
                                           parse_identification, parse_setup)
from ...host.codecs.vorbis.synthesis import (PacketDecoder, _imdct_op,
                                             window_vector)
from ...host.containers.ogg import OggReader

#: config ids: 0 = short block; long blocks 1..4 by (prev_full, next_full)
N_CONFIGS = 5


def _config_id(n: int, bs1: int, prev_full: bool, next_full: bool) -> int:
    if n != bs1:
        return 0
    return 1 + (0 if prev_full else 2) + (0 if next_full else 1)


@functools.lru_cache(maxsize=None)
def _operators(bs0: int, bs1: int) -> np.ndarray:
    """(5, bs1/2, bs1) stacked IMDCT+window linear maps, short padded
    into the long layout (zero rows/cols beyond bs0/2 x bs0)."""
    if bs1 > 4096:
        raise VorbisError(f"device path supports bs1 <= 4096, got {bs1}")
    half1 = bs1 // 2
    ops = np.zeros((N_CONFIGS, half1, bs1), np.float32)
    w0 = window_vector(bs0, True, True, bs0)
    ops[0, :bs0 // 2, :bs0] = _imdct_op(bs0) * w0[None, :].astype(np.float32)
    for cid, (pf, nf) in ((1, (True, True)), (2, (True, False)),
                          (3, (False, True)), (4, (False, False))):
        w = window_vector(bs1, pf, nf, bs0)
        ops[cid] = _imdct_op(bs1) * w[None, :].astype(np.float32)
    return ops


_OPS: dict = {}


def device_operators(bs0: int, bs1: int, device="cuda") -> torch.Tensor:
    """:func:`_operators` as a (5, bs1 / 2, bs1) float32 tensor on
    ``device``, made once per device and block sizes."""
    dev = torch.device(device)
    key = (bs0, bs1, str(dev))
    if key not in _OPS:
        _OPS[key] = torch.from_numpy(_operators(bs0, bs1)).to(dev)
    return _OPS[key]


def capture_stream_iter(data: bytes):
    """Host entropy decode of an Ogg Vorbis stream, streamed ->
    (VorbisInfo, iterator of (n, prev_full, next_full, spectra (ch,
    n/2) f64)).  Lazy so multi-stream decode holds only one group of
    float64 spectra per stream at a time."""
    ogg = OggReader(BufferReader(data))
    pk = ogg.packets()
    info = parse_identification(next(pk))
    parse_comment(next(pk))
    setup = parse_setup(next(pk), info.channels)
    dec = PacketDecoder(info, setup)

    def gen():
        for p in pk:
            try:
                r = dec.decode_spectrum(p)
            except VorbisError:
                r = None
            if r is not None:
                yield r

    return info, gen()


def capture_stream(data: bytes):
    """Eager variant of capture_stream_iter (tests, dryrun)."""
    info, gen = capture_stream_iter(data)
    return info, list(gen)


def _pack_group(blocks, cursor, bs0: int, bs1: int, ch: int, G: int):
    """blocks: up to G captured blocks continuing a stream whose lap
    walk is at `cursor` = (center, prev_quarter), or None at stream
    start.  Returns (Xq, scale, onehot, lo_abs, center, prev_quarter,
    start_center) host arrays for one stream's group slot; rows past
    len(blocks) are inert (zero onehot/spectra)."""
    half1 = bs1 // 2
    Xq = np.zeros((G, ch, half1), np.int16)
    scale = np.zeros((G, ch), np.float32)
    onehot = np.zeros((G, N_CONFIGS), np.float32)
    lo = np.zeros((G,), np.int64)
    center, prev_quarter = (None, None) if cursor is None else cursor
    start_center = None
    for i, (n, pf, nf, spec) in enumerate(blocks):
        if center is None:
            center = n // 2
            start_center = center
        else:
            center = center + prev_quarter + n // 4
        prev_quarter = n // 4
        onehot[i, _config_id(n, bs1, pf, nf)] = 1.0
        half = n // 2
        mx = np.abs(spec).max(axis=1)                    # (ch,)
        sc_enc = np.where(mx > 0, 32767.0 / np.maximum(mx, 1e-30), 1.0)
        Xq[i, :, :half] = np.clip(
            np.rint(spec * sc_enc[:, None]), -32768, 32767).astype(np.int16)
        scale[i] = (1.0 / sc_enc).astype(np.float32)
        lo[i] = center - half                            # absolute
    return Xq, scale, onehot, lo, center, prev_quarter, start_center


def group_step(ops: torch.Tensor, Xq, scale, onehot, lo, shift, carry):
    """One group of G blocks of S streams -> (pcm16 (S, ch, (G + 3) h1)
    int16, new carry (S, ch, h1)), h1 = bs1 / 2; the caller keeps pcm16[:,
    :, h1:h1 + shift[s]] of stream s.  Xq (S, G, ch, h1) int16, scale (S,
    G, ch) float32, lo (S, G) int64 offsets into the group timeline, shift
    (S,) int64 and carry (S, ch, h1) float32 on the device of ``ops`` (5,
    h1, bs1); onehot (S, G, 5), the configuration of each block (all zero
    for an inert row), stays on the host (a numpy array), so the row split
    never waits on the card."""
    _kernels.require_full_fp32(Xq.device)
    S, G, ch, h1 = Xq.shape
    bs1 = 2 * h1
    lpad = (G + 3) * h1
    dev = Xq.device
    X = (Xq.float() * scale[..., None]).reshape(S * G * ch, h1)
    cfg = np.repeat(np.asarray(onehot).reshape(S * G, N_CONFIGS), ch, axis=0)
    Y = torch.zeros((S * G * ch, bs1), device=dev)
    for cid in range(N_CONFIGS):
        rows = np.flatnonzero(cfg[:, cid] > 0)
        if len(rows):
            idx = torch.from_numpy(rows).to(dev)
            Y[idx] = torch.matmul(X[idx], ops[cid])
    # overlap-add: one flat scatter into every stream's group timeline
    # (inert rows sit at offset 0 and add zeros)
    base = (torch.arange(S, device=dev)[:, None] * ch
            + torch.arange(ch, device=dev)[None, :]) * lpad    # (S, ch)
    idx = (base[:, None, :, None] + lo[:, :, None, None]
           + torch.arange(bs1, device=dev))                    # (S,G,ch,bs1)
    out = torch.zeros(S * ch * lpad, device=dev)
    out.index_add_(0, idx.reshape(-1), Y.reshape(-1))
    out = out.reshape(S, ch, lpad)
    # group-to-group lap: the carry-in sits at local [h1, 2 h1)
    out[:, :, h1:2 * h1] += carry
    take = (h1 + shift[:, None, None]
            + torch.arange(h1, device=dev)).expand(S, ch, h1)
    carry_out = out.gather(2, take)
    pcm16 = torch.round(out * 32768.0).clamp_(-32768, 32767) \
        .to(torch.int16)
    return pcm16, carry_out


def decode_vorbis_streams_device(streams: list, group: int = 64, *,
                                 device="cuda") -> list:
    """Multi-stream serving call: S Ogg Vorbis streams sharing block sizes
    and channel count (mismatches raise ``ValueError``), entropy on the
    host, IMDCT, window and overlap-add of every stream's group of
    ``group`` blocks in one device pass.  Output is [(ch, n) int16] per
    stream, n = samples from the stream's first block centre to its last
    (the host Lapper's emission window).  The host captures group g + 1
    while the device runs group g, whose PCM is copied back after the next
    group is queued; the capture generators are closed on the way out."""
    caps = [capture_stream_iter(s) for s in streams]
    gens = [c[1] for c in caps]
    try:
        return _decode_groups([c[0] for c in caps], gens, group,
                              torch.device(device))
    finally:
        for g in gens:
            g.close()


def next_group(gens, cursors: list, bs0: int, bs1: int, ch: int,
               group: int):
    """Capture the next ``group`` blocks of every stream (its generator in
    ``gens``, its lap walk in ``cursors``, advanced here) -> the group's
    numpy wire (Xq (S, G, ch, h1) int16, scale (S, G, ch) float32, onehot
    (S, G, 5), lo (S, G) int64 offsets into the group timeline, shift (S,)
    int64 samples each stream emits), or None when every stream has
    ended."""
    half1 = bs1 // 2
    packed, any_blocks = [], False
    for s, gen in enumerate(gens):
        blk = list(itertools.islice(gen, group))
        any_blocks = any_blocks or bool(blk)
        Xq, scale, onehot, lo, center, pq, start_c = _pack_group(
            blk, cursors[s], bs0, bs1, ch, group)
        if blk:
            emit_from = start_c if cursors[s] is None else cursors[s][0]
            cursors[s] = (center, pq)
            shift = center - emit_from
        else:
            emit_from = 0 if cursors[s] is None else cursors[s][0]
            shift = 0
        # offsets relative to the group origin (emit_from - half1)
        lo = lo - (emit_from - half1)
        lo[onehot.sum(axis=1) == 0] = 0
        packed.append((Xq, scale, onehot, lo, shift))
    if not any_blocks:
        return None
    return tuple(np.stack(a) for a in zip(*packed))


def _decode_groups(infos, gens, group: int, dev) -> list:
    bs0, bs1 = infos[0].blocksize
    ch = infos[0].channels
    for inf in infos[1:]:
        if inf.blocksize != (bs0, bs1) or inf.channels != ch:
            raise ValueError("device batch needs uniform blocksizes "
                             "and channel count")
    S = len(gens)
    half1 = bs1 // 2
    ops = device_operators(bs0, bs1, dev)
    cursors = [None] * S                  # (center, prev_quarter)
    outs: list[list[np.ndarray]] = [[] for _ in range(S)]
    carry = torch.zeros((S, ch, half1), device=dev)

    def sink(pcm16, shifts):
        pcm16 = pcm16.cpu().numpy()
        for s, sh in enumerate(shifts.tolist()):
            if sh > 0:
                outs[s].append(pcm16[s, :, half1:half1 + sh])

    pending = None
    while (wire := next_group(gens, cursors, bs0, bs1, ch, group)) \
            is not None:
        Xq, scale, onehot, lo, shift = wire
        Xq_t, scale_t, lo_t, shift_t = (torch.from_numpy(a).to(dev)
                                        for a in (Xq, scale, lo, shift))
        pcm16, carry = group_step(ops, Xq_t, scale_t, onehot, lo_t, shift_t,
                                  carry)
        if pending is not None:
            sink(*pending)
        pending = (pcm16, shift)
    if pending is not None:
        sink(*pending)
    return [np.concatenate(o, axis=1) if o else np.zeros((ch, 0), np.int16)
            for o in outs]


def decode_vorbis_stream_device(data: bytes, group: int = 64, *,
                                device="cuda") -> np.ndarray:
    """Whole-stream decode of one Ogg Vorbis stream -> (ch, n) int16 PCM
    (the synthesis path's surface; see the streams variant)."""
    return decode_vorbis_streams_device([data], group, device=device)[0]
