"""Multi-stream MP3 decode on the device: the serving call.

Port of ``ohpipeline_tpu.codecs.mp3.serving.decode_mp3_streams_device``
(``mp3/serving.py:35-140``).  MP3 streams that share MPEG version, sample
rate and channel count decode in groups of ``frames_per_group`` frames:
each stream's frames parse on the host (the native Layer III Huffman core),
requantize, stereo and alias reduction run per granule in numpy
(``prepare_granules``), and every stream's channels stack on the batch axis
of one filterbank pass per group
(``synthesis.hybrid_synthesis_parallel_i16``: the filterbank couples no
channels).  Spectra go up as int16 with a scale per granule and channel
(half the bytes of float32, ~3e-5 of the granule's peak), as the JAX
package ships them.  Overlap and V-FIFO state stay on the device between
groups.  The host parses group g + 1 while the device runs group g, whose
PCM is copied back after the next group is queued: one group in flight and
no drain thread (the reference's ``ThreadedDrainer`` hangs when its sink
raises while its queue is full).

With ``mesh=`` (``parallel.make_mesh``; ``device`` then stays at its
default, and naming another raises) the streams split into contiguous
blocks, one a dp row, each served on its row's first device with its own
parsers, overlap and V-FIFO state and its own ``n_real``; the batch checks
run over all the streams first, so ``mesh=`` raises where ``mesh=None``
does.  The blocks advance in lockstep, group g packed and launched on every
block before group g - 1 is collected; ``mesh=None`` is the one-block case
of the same loop.
"""

from __future__ import annotations

import numpy as np
import torch

from .._serving import serve_blocks, stream_blocks
from ...host.codecs.mp3 import bitstream as BS
from . import parse_vbr_header, prepare_granules
from . import synthesis as SYN


def _check_batch(streams: list) -> list:
    """The streams' first frame headers; raises ``ValueError`` on a stream
    that is not MP3 and on mixed version, rate or channel count."""
    hdrs = [BS.parse_frame_header(s) for s in streams]
    if not hdrs or any(h is None for h in hdrs):
        raise ValueError("not an MP3 stream")
    h0 = hdrs[0]
    for h in hdrs[1:]:
        if (h.version, h.sample_rate, h.channels) \
                != (h0.version, h0.sample_rate, h0.channels):
            raise ValueError(
                "device batch needs uniform version/rate/channels")
    return hdrs


def pack_group(parsers: list, live: list, G: int, nch: int, Tg: int):
    """Parse and prepare the next G frames of every live stream -> the
    group's wire (q16 (Tg, S * nch, 576) int16, scl (Tg, S * nch) float32,
    btp (Tg, S * nch, 32) uint8), the granules each stream filled and the
    largest of those (n_real).  A stream that yields fewer than G frames is
    marked dead in ``live``."""
    S = len(parsers)
    q16 = np.zeros((Tg, S * nch, 576), np.int16)
    scl = np.zeros((Tg, S * nch), np.float32)
    btp = np.zeros((Tg, S * nch, 32), np.uint8)
    counts = [0] * S
    for s in range(S):
        if not live[s]:
            continue
        frames = []
        while len(frames) < G:
            fr = parsers[s].next_frame()
            if fr is None:
                break
            frames.append(fr)
        if len(frames) < G:
            live[s] = False
        xr, bt = prepare_granules(frames, nch)
        tg = counts[s] = xr.shape[0]
        if not tg:
            continue
        c0 = s * nch
        peak = np.abs(xr).max(axis=-1)                     # (tg, nch)
        sc = np.where(peak > 0, peak, 1.0) * np.float32(1 / 32767.0)
        q16[:tg, c0:c0 + nch] = np.rint(xr / sc[..., None]).astype(np.int16)
        scl[:tg, c0:c0 + nch] = sc
        btp[:tg, c0:c0 + nch] = bt.astype(np.uint8)
    return (q16, scl, btp), counts, max(counts)


def decode_mp3_streams_device(streams: list, frames_per_group: int = 32, *,
                              device="cuda", mesh=None) -> list:
    """streams: MP3 files (bytes) sharing MPEG version, sample rate and
    channel count; mismatches raise ``ValueError``, as does a granule count
    per group (frames_per_group x granules per frame) that is not a power of
    two.  Returns [(channels, nsamples) int32 PCM] per stream.  A stream
    whose frames stop parsing early ends early.  Padding granules past a
    group's longest stream never advance the state; a stream that ends
    inside a group has its state advanced by the padding, and is not read
    again.  The work runs on ``device``, or, with ``mesh``, on the first
    device of each of its dp rows, a contiguous block of the streams a row
    (each block's longest stream sets its groups' length)."""
    hdrs = _check_batch(streams)
    h0 = hdrs[0]
    nch = h0.channels
    G = frames_per_group
    Tg = G * h0.granule_count
    if Tg <= 0 or Tg & (Tg - 1):
        raise ValueError("frames_per_group * granules must be a power "
                         "of two (one compiled shape per batch)")
    parsers = []
    for data, h in zip(streams, hdrs):
        st = BS.Mp3Stream(data)
        if parse_vbr_header(data, h):       # the Xing/VBRI frame: no audio
            st.pos = h.frame_bytes
        parsers.append(st)
    shards = stream_blocks(len(streams), mesh, device)
    states = [SYN.init_state((blk.stop - blk.start) * nch, dev)
              for dev, blk in shards]
    lives = [[True] * (blk.stop - blk.start) for _, blk in shards]
    outs: list[list[np.ndarray]] = [[] for _ in streams]

    def sink(pcm, s0, counts):                      # (n_real, S * nch, 576)
        pcm = pcm.cpu().numpy()
        for s, tg in enumerate(counts):
            if tg:
                cols = pcm[:tg, s * nch:(s + 1) * nch]
                outs[s0 + s].append(cols.transpose(1, 0, 2).reshape(nch, -1))

    def groups(i: int):
        """Shard i's groups: (wire, counts, n_real) until its streams end."""
        blk = shards[i][1]
        while any(lives[i]):
            wire, counts, n_real = pack_group(parsers[blk], lives[i], G, nch,
                                              Tg)
            if not n_real:
                return
            yield wire, counts, n_real

    def launch(i, item):
        (q16, scl, btp), counts, n_real = item
        dev, blk = shards[i]
        # the group's longest stream sets its length (the JAX program keeps
        # Tg for one compiled shape; the granules past n_real are zeros)
        q16, scl, btp = (torch.from_numpy(a[:n_real]).to(dev)
                         for a in (q16, scl, btp))
        pcm, *states[i] = SYN.hybrid_synthesis_parallel_i16(
            q16, scl, btp, *states[i], n_real)
        return pcm, blk.start, counts

    serve_blocks([groups(i) for i in range(len(shards))], launch, sink)
    return [np.concatenate(o, axis=1) if o else np.zeros((nch, 0), np.int32)
            for o in outs]
