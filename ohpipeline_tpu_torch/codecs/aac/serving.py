"""Multi-stream batched AAC-LC and HE-AAC v1 decode over the zigzag-nibble
wire: the serving API.

Port of ``decode_aac_streams_device`` and ``decode_he_streams_device`` of
``ohpipeline_tpu.codecs.aac.serving``.  ADTS streams sharing a sample rate
and channel count decode in groups of ``frames_per_group`` frames.  Per
group each stream parses once, and the native unpacker
(``native.aac_prepare_rows_zz``) lays its quantized coefficients at their
spectral positions as zigzag nibbles, with per-band scalefactor bytes, M/S
bitmasks, pooled short-window scalefactors, escape triples for |q| > 7 and
the TnsPool planes of TNS rows; the remaining exception rows (PNS,
intensity) are prepared natively on the host, one call a stream's group
(``native.aac_side_rows``, with the PNS noise numpy's), into a float32
side plane (counter ``side_rows.serve``).  One device
pass (``synthesis.decode_chunk_zz``) then synthesises every stream's frames,
with the overlap carried across groups on the device.

Each group's planes are sized from that group's own parse.  The JAX package
runs a survey parse first, to give every group of a call one compiled shape;
the port's kernels and ops take any length, so it has none.  The call's
escape list and short-window and TNS pools start at bounds taken from the
group's frame and channel counts (:func:`_start_caps`) and are reused from
group to group; a stream whose unpack fills one doubles the full list and
unpacks again from the parse it has, with the lists cut back to their
entries before it and its window shapes restored (counter
``regrow.serve``).  ``epak``/``eva2``, ``ssf``/``ssr``, the TNS planes and
``side``/``srow`` ship as their used prefix rounded up to a power of two,
padded with row -1.

HE-AAC v1 rides the same wire: the core's planes come from
``native.aac_parse_group_sbr``, which also captures each frame's SBR
payload; the host SBR chain (``sbr_chain``: native, a stream's group a
call, over dense arrays) parses and dequantises the payloads per stream
(span ``sbr.parse`` inside ``serve.parse``, counter ``frames.sbr``) and
builds the SBR cond planes at launch (span ``sbr.cond``), and one device
pass (``sbr.SbrDeviceRunner``) runs the LC core and the SBR group of every
stream's channels.  A stream's group the native chain declines raises
``ValueError``, in the Python chain's words where that chain raises
(``sbr_chain.sbr_frames``).

The host parses group g + 1 while the device runs group g; its PCM is
rounded on the device and copied back after the next group is queued.  No
drain thread is involved, so an error propagates from the loop with
nothing left running.

With ``mesh=`` (``parallel.make_mesh``; ``device`` then stays at its
default, and naming another raises) the streams split into contiguous
blocks, one a dp row, each served on its row's first device by its own
``iter_groups``, overlap and (HE) ``SbrDeviceRunner``, whose state rows are
its block's channels: a block's wire is self-consistent, so no global row
(``epak``, ``srow``, ``trow``) is rebased.  The batch's rate and channels
are validated over all the streams first, and every block's first group
is parsed, its SBR headers held to the call's, before any launch, so
``mesh=`` raises where ``mesh=None`` does.  The blocks advance in
lockstep, group g parsed and launched on every block before group g - 1
is collected; ``mesh=None`` is the one-block case of the same loop.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._serving import assemble, serve_blocks, stream_blocks
from ..._host import aac_bitstream, aac_native, sbr_native
from ...tracing import NEW, count, nbytes, span
from . import sbr as SBRD
from . import synthesis as SYN
from .sbr_chain import CondState, SbrChain, SbrPayloads
from .synthesis import decode_planes


def _header(streams: list) -> tuple[int, int]:
    hdrs = [aac_bitstream.parse_adts_header(s) for s in streams]
    if any(h is None for h in hdrs):
        raise ValueError("not an ADTS stream")
    nch, ri = hdrs[0].channels, hdrs[0].rate_index
    for h in hdrs[1:]:
        if (h.channels, h.rate_index) != (nch, ri):
            raise ValueError("device batch needs uniform rate/channels")
    return nch, ri


def _start_caps(rows: int) -> tuple[int, int, int]:
    """Start capacities of a call's escape list, short-window pool and TNS
    pool for groups of ``rows`` (frame, channel) rows: one escape in 64
    coefficients, one pooled row in eight."""
    return 16 * rows + 64, rows // 8 + 64, rows // 8 + 64


def _grown(lst, keep: int):
    """A list of ``lst``'s type with twice its capacity, holding its first
    ``keep`` entries."""
    new = type(lst)(2 * lst.cap)
    for name, arr in vars(lst).items():
        if isinstance(arr, np.ndarray):
            getattr(new, name)[:keep] = arr[:keep]
    new.count.value = keep
    return new


def _padded(src: np.ndarray, n: int, floor: int, fill) -> np.ndarray:
    """``src[:n]`` padded with ``fill`` along its first axis to the next
    power of two, at least ``floor``."""
    out = np.full((max(floor, 1 << (n - 1).bit_length()),) + src.shape[1:],
                  fill, src.dtype)
    out[:n] = src[:n]
    return out


def _side(native, pbuf: dict, special, nch: int, SC: int, col0: int):
    """One stream's side rows of a group, prepared natively from its parse
    buffer: (side (n, 1024) float32, srow (n,) int32), with the PNS noise
    drawn by ``synthesis._pns_noise``."""
    draws = native.aac_side_draws(pbuf, special, nch)
    noise = np.concatenate([np.zeros(0)] + [SYN._pns_noise(r, p, n)
                                            for r, p, n in draws.tolist()])
    count("side_rows.serve", len(special))
    return native.aac_side_rows(pbuf, special, nch, noise, sc=SC, col0=col0)


def iter_groups(streams: list, frames_per_group: int = 64, *,
                sbr: bool = False):
    """Parse ``streams`` group by group.  Yields ``(planes, counts)``: the
    numpy wire planes of one device pass, keyed by ``synthesis.ZZ_PLANES``,
    ``ZZ_PLANES_AFTER_ESC`` and ``TNS_PLANES`` (plus ``rate_index``), and
    ``(stream, nframes)`` for every stream still live in the group.
    Columns of stream s are s * channels ... (s + 1) * channels - 1.  With
    ``sbr`` the streams are HE-AAC: planes["sbr"] then lists, in the order
    of ``counts``, each stream's ``sbr_chain.SbrPayloads``: its frames'
    captured payload planes, which give the (payload, nbits, crc) or None
    of a frame when indexed.  Every yielded array is the group's own."""
    native = aac_native()
    nch, ri = _header(streams)
    S, G = len(streams), frames_per_group
    SC = S * nch
    parse = (functools.partial(native.aac_parse_group_sbr, payloads=False)
             if sbr else native.aac_parse_group)
    ecap, scap, tcap = _start_caps(G * SC)
    lists = [native.EscapeList(ecap), native.ShortSfPool(scap),
             native.TnsPool(tcap)]
    pos = [0] * S
    live = [True] * S
    pshape = [np.zeros(nch, np.int32) for _ in range(S)]
    pbuf = None
    while any(live):
        q4 = np.zeros((G, SC, 512), np.uint8)
        sfb = np.zeros((G, SC, 64), np.uint8)
        msb = np.zeros((G, SC // 2, 128), np.uint8)
        opx = np.zeros((G, SC), np.uint8)
        for lst in lists:
            lst.count.value = 0
        sides, srows = [], []
        counts, payloads = [], []
        for s in range(S):
            if not live[s]:
                continue
            n, pos[s], pbuf = parse(streams[s], pos[s], channels=nch,
                                    max_frames=G, out=pbuf)
            live[s] = n == G
            counts.append((s, n))
            if sbr:
                # copies: the next stream's parse reuses pbuf's arrays
                payloads.append(SbrPayloads(pbuf["_sbr_bytes"][:n].copy(),
                                            pbuf["_sbr_nbits"][:n].copy(),
                                            pbuf["_sbr_crc"][:n].copy()))
            if n == 0:
                continue
            before = [lst.count.value for lst in lists]
            shape0 = pshape[s].copy()
            while (special := native.aac_prepare_rows_zz(
                    pbuf, n, G, nch, pshape[s], lists[0], lists[1],
                    q4=q4, sfb=sfb, msb=msb, opx=opx, col0=s * nch,
                    max_special=G * nch, tns=lists[2])) is None:
                if all(lst.count.value < lst.cap for lst in lists):
                    raise ValueError(f"stream {s}: zz unpack failed with "
                                     f"room in every list")
                count("regrow.serve")
                lists = [_grown(lst, c) if lst.count.value >= lst.cap
                         else lst for lst, c in zip(lists, before)]
                for lst, c in zip(lists, before):
                    lst.count.value = c
                pshape[s][:] = shape0
            if len(special):
                side, srow = _side(native, pbuf, special, nch, SC, s * nch)
                sides.append(side)
                srows.append(srow)
        esc, ssfv, tnsv = lists
        ne = esc.count.value
        side = np.concatenate([np.zeros((0, 1024), np.float32)] + sides)
        srow = np.concatenate([np.zeros(0, np.int32)] + srows)
        ns, nt = ssfv.count.value, tnsv.count.value
        planes = dict(
            q4=q4, sfb=sfb, ssf=_padded(ssfv.sf, ns, 64, 0),
            ssr=_padded(ssfv.row, ns, 64, -1), msb=msb, opx=opx,
            epak=_padded(esc.row[:ne] * 1024 + esc.pos[:ne], ne, 256, -1),
            eva2=_padded(esc.val[:ne].astype(np.int16), ne, 256, 0),
            side=_padded(side, len(side), 8, 0),
            srow=_padded(srow, len(srow), 8, -1),
            tfi=_padded(tnsv.tfi, nt, 64, 0),
            tco=_padded(tnsv.tco, nt, 64, 0),
            tdir=_padded(tnsv.tdir, nt, 64, 0),
            trow=_padded(tnsv.row, nt, 64, -1), rate_index=ri)
        if sbr:
            planes["sbr"] = payloads
        yield planes, counts


def to_device(planes: dict, device) -> dict:
    """Numpy wire planes -> tensors on ``device``, dtypes unchanged
    (``rate_index`` and ``sbr`` stay on the host)."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v)).to(device)
                if isinstance(v, np.ndarray) else v)
            for k, v in planes.items()}


def _upload(planes: dict, device) -> dict:
    """:func:`to_device` of one serving group, counted."""
    t = to_device(planes, device)
    count("h2d_bytes.serve.upload",
          nbytes(*(v for v in t.values() if isinstance(v, torch.Tensor))))
    count("groups.serve")
    return t


def decode_aac_streams_device(streams: list, frames_per_group: int = 64, *,
                              device="cuda", mesh=None) -> list[np.ndarray]:
    """streams: ADTS AAC-LC files (bytes) sharing rate and channel count.
    Returns [(channels, nsamples) int32 PCM] per stream, rounded half to
    even and clipped to the int16 range like the host decode path.  The
    work runs on ``device``, or, with ``mesh``, on the first device of each
    of its dp rows, a contiguous block of the streams a row."""
    nch, ri = _header(streams)
    shards = stream_blocks(len(streams), mesh, device)
    consts = [SYN.device_constants(ri, device=dev) for dev, _ in shards]
    ovs = [torch.zeros(((blk.stop - blk.start) * nch, 1024),
                       dtype=torch.float32, device=dev)
           for dev, blk in shards]
    gens = [iter_groups(streams[blk], frames_per_group) for _, blk in shards]
    outs: list[list[np.ndarray]] = [[] for _ in streams]

    def collect(pcm16, s0, counts):             # (G, S*C, 1024) int32
        count("d2h_bytes.serve.copy_back", pcm16.nbytes)
        pcm16 = pcm16.cpu().numpy()
        for s, n in counts:
            if n:
                cols = pcm16[:n, s * nch:(s + 1) * nch]
                outs[s0 + s].append(cols.transpose(1, 0, 2).reshape(nch, -1))

    def launch(i, item):
        planes, counts = item
        dev, blk = shards[i]
        pcm, ovs[i] = decode_planes(_upload(planes, dev), ovs[i], consts[i])
        pcm16 = torch.round(pcm).clamp_(-32768, 32767).to(torch.int32)
        return pcm16, blk.start, counts

    with span("serve.call", request=NEW, codec="aac_lc",
              streams=len(streams), blocks=len(shards)):
        serve_blocks(gens, launch, collect)
        return assemble(outs, nch)


def decode_he_streams_device(streams: list, frames_per_group: int = 48, *,
                             device="cuda", mesh=None) -> list[np.ndarray]:
    """streams: ADTS HE-AAC v1 files (bytes) sharing sample rate, channel
    count and SBR header configuration.  Every stream's channels ride one
    device pass per group (the LC core, then the SBR group on the
    ``S * channels`` channel axis).  Parametric-stereo (v2) streams, frames
    without an SBR payload, SBR data before the first SBR header, a header
    that changes mid-stream (also inside a stream's first group), and a
    group whose envelope or noise levels leave the dequantisation tables'
    range or whose grid has too few borders raise ``ValueError``.  Returns
    [(channels, nsamples) int32 PCM] per stream at twice the ADTS rate,
    rounded half to even and clipped to the int16 range.  The work runs on
    ``device``, or, with ``mesh``, on the first device of each of its dp
    rows, a contiguous block of the streams a row with its own
    ``SbrDeviceRunner``."""
    nch, ri = _header(streams)
    rate = aac_bitstream.parse_adts_header(streams[0]).sample_rate
    shards = stream_blocks(len(streams), mesh, device)
    consts = [SYN.device_constants(ri, device=dev) for dev, _ in shards]
    sbr_native()
    chain = SbrChain(len(streams), nch, rate)
    runners: list = []
    states: list = []
    outs: list[list[np.ndarray]] = [[] for _ in streams]

    def collect(pcm16, s0, counts):             # (S*C, G*2048) int16
        count("d2h_bytes.serve.copy_back", pcm16.nbytes)
        pcm16 = pcm16.cpu().numpy()
        for s, n in counts:
            if n:
                outs[s0 + s].append(pcm16[s * nch:(s + 1) * nch, :n * 2048]
                                    .astype(np.int32))

    def parsed(i: int):
        """Block i's groups, with its streams' SBR payloads parsed and
        dequantised: (planes, counts, sbr_chain.SbrGroup)."""
        blk = shards[i][1]
        for planes, counts in iter_groups(streams[blk], frames_per_group,
                                          sbr=True):
            # dead or short channels have no frames: they stay inactive
            # and their output is cut off in collect()
            with span("sbr.parse"):
                group = chain.parse_group(
                    blk.start, counts, planes["sbr"],
                    (blk.stop - blk.start) * nch, frames_per_group)
            yield planes, counts, group

    def launch(i, item):
        if not runners:     # every block's first group is parsed by now
            if chain.header is None:
                raise ValueError("no SBR header in any stream")
            dec = chain.decoder()
            for dev, blk in shards:
                C = (blk.stop - blk.start) * nch
                runners.append(SBRD.SbrDeviceRunner(dec, C, device=dev))
                states.append(CondState(C))
        planes, counts, group = item
        dev, blk = shards[i]
        runner = runners[i]
        cond = SBRD.ChannelCond(group.cond(runner.static, states[i]))
        pcm16 = runner.decode_group_multi_zz(_upload(planes, dev), cond,
                                             consts[i])
        return pcm16, blk.start, counts

    with span("serve.call", request=NEW, codec="he_aac",
              streams=len(streams), blocks=len(shards)):
        serve_blocks([parsed(i) for i in range(len(shards))], launch, collect)
        return assemble(outs, nch)
