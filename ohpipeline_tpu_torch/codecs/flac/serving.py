"""Multi-stream batched FLAC decode over the rice wire: the serving API.

Port of ``ohpipeline_tpu.codecs.flac.serving``.  Per group, every stream's
next ``frames_per_group`` frames parse once through
``native.flac_parse_group_rice`` (the entropy-coded bytes go to the device
as they are, with per-unit bit cursors rebased into one shared slab) and one
device pass (``codecs.flac.synthesise_group_rice``) decodes all streams'
rows at once.

Each group's planes are sized from that group's own parse.  The JAX package
runs a survey parse first, to give every group of a call one compiled shape;
the port's kernels and ops take any length, so it has none.  The call's
overflow-unit, constant-fill and escape lists start at bounds taken from the
group's frame count, channels and stride (:func:`_start_caps`) and are
reused from group to group; a stream whose parse fills one (status -10,
-11, -9) doubles that list and parses again from where it started, with the
lists cut back to their entries before it (counter ``regrow.serve``).  A
list plane ships as its used prefix rounded up to a power of two, padded
with row -1; the byte slab holds this group's bytes.

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


def _start_caps(S: int, rows: int, slots: int) -> tuple[int, int, int]:
    """Start capacities of a call's overflow-unit, constant-fill and escape
    lists for groups of ``S`` streams of ``rows`` rows of ``slots`` 64-sample
    slots: two units a slot, one fill a row (a row is one subframe) and one
    escape a slot.  A list that fills up grows."""
    return (2 * S * rows * slots + 64, S * rows + 64, S * rows * slots + 64)


#: The parser's status for a full list -> that list's index in ``lists``.
_FULL = {-10: 0, -11: 1, -9: 2}


def _grown(lst, keep: int):
    """A list of ``lst``'s type with twice its capacity, holding its first
    ``keep`` entries."""
    new = type(lst)(2 * lst.cap)
    for name, arr in vars(lst).items():
        if isinstance(arr, np.ndarray):
            getattr(new, name)[:keep] = arr[:keep]
    new.count.value = keep
    return new


def _shipped(lst, floor: int, **fills) -> dict:
    """The first ``lst.count`` entries of each of ``lst``'s arrays named in
    ``fills`` (plane name -> (array name, padding value)), padded to the
    next power of two, at least ``floor``."""
    n = lst.count.value
    size = max(floor, 1 << (n - 1).bit_length())
    out = {}
    for key, (name, fill) in fills.items():
        src = getattr(lst, name)
        out[key] = np.full(size, fill, src.dtype)
        out[key][:n] = src[:n]
    return out


def iter_groups(streams: list, frames_per_group: int = 32):
    """Parse ``streams`` group by group.  Yields ``(planes, meta_rows)``:
    the numpy wire planes of one device pass, keyed by
    ``codecs.flac.RICE_PLANES``, and ``(stream, nframes, blocksizes)`` for
    every stream that has frames in it.  Rows of stream s start at
    s * frames_per_group * channels.  Every yielded array is the group's
    own."""
    L = _Layout(streams, frames_per_group)
    Bf = L.S * L.rows
    ocap, ccap, ecap = _start_caps(L.S, L.rows, L.slots)
    lists = [native.RiceOverflow(ocap), native.RiceConstFill(ccap),
             native.EscapeList(ecap)]
    pos = L.start()
    live = [True] * L.S
    while any(live):
        gcur = np.zeros((Bf, L.slots), np.int32)
        gk = np.full((Bf, L.slots), -1, np.int8)
        warm = np.zeros((Bf, 32), np.int32)
        coeffs = np.zeros((Bf, 32), np.int32)
        shift = np.zeros(Bf, np.int32)
        order = np.zeros(Bf, np.int32)
        wasted = np.zeros(Bf, np.int32)
        assign = np.zeros(L.S * L.Gc, np.int32)
        for lst in lists:
            lst.count.value = 0
        spans = []                  # (stream, first byte, bytes)
        bbase = 0
        meta_rows = []
        for s in range(L.S):
            if not live[s]:
                continue
            r0 = s * L.rows
            rs = slice(r0, r0 + L.rows)
            before = [lst.count.value for lst in lists]
            while True:
                n, end, st, b, (b0, b1) = L.parse(
                    s, pos[s], gcur[rs], gk[rs], warm[rs], *lists, r0)
                if st not in _FULL:
                    break
                count("regrow.serve")
                full = _FULL[st]
                lists[full] = _grown(lists[full], before[full])
                for lst, c in zip(lists, before):
                    lst.count.value = c
            _check_status(s, st)
            pos[s] = end
            nb = b1 - b0
            if bbase:       # rebase this stream's cursors into the slab
                gsl = gcur[rs]
                gsl[gk[rs] >= 0] += bbase * 8
                lists[0].cur[before[0]:lists[0].count.value] += bbase * 8
            spans.append((s, b0, nb))
            bbase += nb
            rows = n * L.nch
            for key, dst in (("coeffs", coeffs), ("shift", shift),
                             ("order", order), ("wasted", wasted)):
                dst[r0:r0 + rows] = b[key][:rows]
            assign[s * L.Gc:s * L.Gc + n] = b["assign"][:n]
            meta_rows.append((s, n, b["blocksize"][:n].copy()))
            live[s] = n == L.Gc
        bits = np.zeros(-(-(bbase + 64) // 4096) * 4096, np.uint8)
        at = 0
        for s, b0, nb in spans:
            bits[at:at + nb] = np.frombuffer(streams[s], np.uint8, nb, b0)
            at += nb
        ov, cf, es = lists
        planes = dict(
            bits=bits, gcur=gcur, gk=gk, warm=warm, coeffs=coeffs,
            shift=shift, order=order, wasted=wasted, assign=assign,
            **_shipped(ov, 256, ocur=("cur", 0), okk=("k", 0),
                       omode=("mode", 0), ocnt=("cnt", 0), orow=("row", -1),
                       opos=("pos", 0)),
            **_shipped(cf, 64, cfrow=("row", -1), cfval=("val", 0),
                       cfn=("n", 0)),
            **_shipped(es, 64, esc_row=("row", -1), esc_pos=("pos", 0),
                       esc_val=("val", 0)))
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
