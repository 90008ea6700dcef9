"""Multi-stream batched FLAC decode over the rice wire: the serving API.

Port of ``ohpipeline_tpu.codecs.flac.serving``.  A survey parse sizes the
shared planes once; then, per group, every stream's next
``frames_per_group`` frames parse through ``native.flac_parse_group_rice``
(the entropy-coded bytes go to the device as they are, with per-unit bit
cursors rebased into one shared slab) and one device pass
(``codecs.flac.synthesise_group_rice``) decodes all streams' rows at once.

The host parses group g + 1 while the device runs group g: the pass is
queued on the device's stream, and its PCM is copied back only after the
next group has been parsed and queued.  No drain thread is involved, so an
error (a corrupt stream, a failed launch) propagates from the loop with
nothing left running.

With ``mesh=`` (``parallel.make_mesh``; ``device`` then stays at its
default, and naming another raises) the streams split into contiguous
blocks, one a dp row, each served on its row's first device by its own
``iter_groups`` (JAX's ``P("dp")`` on the stream axis): every block's wire
is self-consistent, so no global row number is rebased.  The blocks advance
in lockstep, group g parsed and launched on every block before group g - 1
is collected; ``mesh=None`` is the one-block case of the same loop.
"""

from __future__ import annotations

import numpy as np

from .._serving import assemble, serve_blocks, stream_blocks
from ..._host import native, parse_metadata
from ...tracing import NEW, count, nbytes, span
from . import RICE_PLANES, synthesise_group_rice, to_device


def _check_status(s: int, st: int) -> None:
    if st < 0:
        raise ValueError(f"stream {s}: rice wire status {st}")


def _metas(streams: list) -> tuple[list, int]:
    """The streams' metadata and their channel count; raises
    ``ValueError`` unless every stream has the same."""
    metas = [parse_metadata(b) for b in streams]
    nch = metas[0].streaminfo.channels
    for m in metas[1:]:
        if m.streaminfo.channels != nch:
            raise ValueError("device batch needs a uniform channel count")
    return metas, nch


class _Layout:
    """Shapes shared by every group of one serving call."""

    def __init__(self, streams: list, frames_per_group: int):
        self.streams = streams
        self.metas, self.nch = _metas(streams)
        stride = max(m.streaminfo.max_blocksize for m in self.metas)
        self.stride = -(-stride // 64) * 64
        self.S = len(streams)
        self.Gc = frames_per_group
        self.rows = self.Gc * self.nch          # rows per stream
        self.slots = self.stride // 64
        self.scratch = np.zeros((self.rows, self.stride), np.int32)

    def parse(self, s: int, pos: int, gcur, gk, warm, ov, cf, es, row0):
        si = self.metas[s].streaminfo
        return native.flac_parse_group_rice(
            self.streams[s], pos, gcur, gk, warm, self.scratch, ov, cf, es,
            row0, sample_rate=si.sample_rate,
            bits_per_sample=si.bits_per_sample, max_blocksize=self.stride,
            channels=self.nch, max_frames=self.Gc)

    def start(self) -> list[int]:
        return [m.header_bytes * 8 for m in self.metas]

    def survey(self) -> tuple[int, int, int, int]:
        """Per-group plane capacities (overflow units, constant fills,
        escapes, slab bytes) that fit every group of the call."""
        ocap = ccap = ecap = bcap = 0
        pos = self.start()
        gc_t = np.zeros((self.rows, self.slots), np.int32)
        gk_t = np.zeros((self.rows, self.slots), np.int8)
        wm_t = np.zeros((self.rows, 32), np.int32)
        live = [True] * self.S
        while any(live):
            ob = cb = eb = bb = 0
            for s in range(self.S):
                if not live[s]:
                    continue
                ov = native.RiceOverflow(2 * self.rows * self.slots + 64)
                cf = native.RiceConstFill(self.rows + 64)
                es = native.EscapeList(self.rows * self.stride + 64)
                n, pos[s], st, _b, (b0, b1) = self.parse(
                    s, pos[s], gc_t, gk_t, wm_t, ov, cf, es, 0)
                _check_status(s, st)
                live[s] = n == self.Gc
                ob += ov.count.value
                cb += cf.count.value
                eb += es.count.value
                bb += b1 - b0
            ocap, ccap = max(ocap, ob), max(ccap, cb)
            ecap, bcap = max(ecap, eb), max(bcap, bb)
        return (max(256, ocap + 8), max(64, ccap + 8), max(64, ecap + 8),
                -(-(bcap + 64) // 4096) * 4096)


def iter_groups(streams: list, frames_per_group: int = 32):
    """Parse ``streams`` group by group.  Yields ``(planes, meta_rows)``:
    the numpy wire planes of one device pass, keyed by
    ``codecs.flac.RICE_PLANES``, and ``(stream, nframes, blocksizes)`` for
    every stream that has frames in it.  Rows of stream s start at
    s * frames_per_group * channels."""
    L = _Layout(streams, frames_per_group)
    with span("serve.survey"):
        OCAP, CCAP, ECAP, BITCAP = L.survey()
    Bf = L.S * L.rows
    pos = L.start()
    live = [True] * L.S
    while any(live):
        bits = np.zeros(BITCAP, np.uint8)
        gcur = np.zeros((Bf, L.slots), np.int32)
        gk = np.full((Bf, L.slots), -1, np.int8)
        warm = np.zeros((Bf, 32), np.int32)
        coeffs = np.zeros((Bf, 32), np.int32)
        shift = np.zeros(Bf, np.int32)
        order = np.zeros(Bf, np.int32)
        wasted = np.zeros(Bf, np.int32)
        assign = np.zeros(L.S * L.Gc, np.int32)
        ov = native.RiceOverflow(OCAP)
        cf = native.RiceConstFill(CCAP)
        es = native.EscapeList(ECAP)
        bbase = 0
        meta_rows = []
        for s in range(L.S):
            if not live[s]:
                continue
            r0 = s * L.rows
            rs = slice(r0, r0 + L.rows)
            oc0 = ov.count.value
            n, pos[s], st, b, (b0, b1) = L.parse(
                s, pos[s], gcur[rs], gk[rs], warm[rs], ov, cf, es, r0)
            _check_status(s, st)
            nb = b1 - b0
            bits[bbase:bbase + nb] = np.frombuffer(streams[s], np.uint8,
                                                   nb, b0)
            if bbase:       # rebase this stream's cursors into the slab
                gsl = gcur[rs]
                gsl[gk[rs] >= 0] += bbase * 8
                ov.cur[oc0:ov.count.value] += bbase * 8
            bbase += nb
            rows = n * L.nch
            for key, dst in (("coeffs", coeffs), ("shift", shift),
                             ("order", order), ("wasted", wasted)):
                dst[r0:r0 + rows] = b[key][:rows]
            assign[s * L.Gc:s * L.Gc + n] = b["assign"][:n]
            meta_rows.append((s, n, b["blocksize"][:n].copy()))
            live[s] = n == L.Gc
        planes = dict(bits=bits, gcur=gcur, gk=gk, ocur=ov.cur, okk=ov.k,
                      omode=ov.mode, ocnt=ov.cnt, orow=ov.row, opos=ov.pos,
                      cfrow=cf.row, cfval=cf.val, cfn=cf.n, warm=warm,
                      esc_row=es.row, esc_pos=es.pos, esc_val=es.val,
                      coeffs=coeffs, shift=shift, order=order, wasted=wasted,
                      assign=assign)
        yield planes, meta_rows


def decode_flac_streams_device(streams: list, frames_per_group: int = 32, *,
                               device="cuda", mesh=None) -> list[np.ndarray]:
    """streams: FLAC files (bytes) sharing a channel count (bit depths and
    lengths may differ).  Returns [(channels, nsamples) int32 PCM] per
    stream, bit-exact with the host decode.  The work runs on ``device``,
    or, with ``mesh``, on the first device of each of its dp rows, a
    contiguous block of the streams a row (the result is the same)."""
    Gc = frames_per_group
    _, nch = _metas(streams)
    shards = stream_blocks(len(streams), mesh, device)
    gens = [iter_groups(streams[blk], Gc) for _, blk in shards]
    outs: list[list[np.ndarray]] = [[] for _ in streams]

    def collect(pcm, s0, meta_rows):           # (S*Gc, nch, stride)
        count("d2h_bytes.serve.copy_back", pcm.nbytes)
        pcm = pcm.cpu().numpy()
        for s, n, sizes in meta_rows:
            for f in range(n):
                outs[s0 + s].append(pcm[s * Gc + f, :, :sizes[f]])

    def launch(i, item):
        planes, meta_rows = item
        dev, blk = shards[i]
        t = to_device(planes, dev)
        count("h2d_bytes.serve.upload", nbytes(*t.values()))
        count("groups.serve")
        pcm = synthesise_group_rice(*(t[k] for k in RICE_PLANES), nch)
        return pcm, blk.start, meta_rows

    with span("serve.call", request=NEW, codec="flac", streams=len(streams),
              blocks=len(shards)):
        serve_blocks(gens, launch, collect)
        return assemble(outs, nch)
