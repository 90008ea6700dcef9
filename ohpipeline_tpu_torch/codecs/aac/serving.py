"""Multi-stream batched AAC-LC and HE-AAC v1 decode over the zigzag-nibble
wire: the serving API.

Port of ``decode_aac_streams_device`` and ``decode_he_streams_device`` of
``ohpipeline_tpu.codecs.aac.serving``.  ADTS streams sharing a sample rate
and channel count decode in groups of ``frames_per_group`` frames.  A survey
parse sizes the shared planes once (escape list, side plane, short-window
and TNS pools), as the reference does, so the wire planes match it plane by
plane.  Per group the native unpacker (``native.aac_prepare_rows_zz``) lays
every stream's quantized coefficients at their spectral positions as zigzag
nibbles, with per-band scalefactor bytes, M/S bitmasks, pooled short-window
scalefactors, escape triples for |q| > 7 and the TnsPool planes of TNS
rows; the remaining exception rows (PNS, intensity) are prepared on the
host into a float32 side plane.  One device pass
(``synthesis.decode_chunk_zz``) then synthesises every stream's frames,
with the overlap carried across groups on the device.

HE-AAC v1 rides the same wire: the core's planes come from
``native.aac_parse_group_sbr``, which also hands back each frame's SBR
payload; the host parses and dequantises the payloads per stream
(``sbr.py``'s ``SbrDecoder``) and builds the SBR cond planes, and one device
pass (``sbr.SbrDeviceRunner``) runs the LC core and the SBR group of every
stream's channels.

The host parses group g + 1 while the device runs group g; its PCM is
rounded on the device and copied back after the next group is queued.  No
drain thread is involved, so an error propagates from the loop with
nothing left running.

With ``mesh=`` (``parallel.make_mesh``; ``device`` then stays at its
default, and naming another raises) the streams split into contiguous
blocks, one a dp row, each served on its row's first device by its own
``iter_groups``, overlap and (HE) ``SbrDeviceRunner``, whose state rows are
its block's channels: a block's wire is self-consistent, so no global row
(``epak``, ``srow``, ``trow``) is rebased.  The batch is validated over all
the streams first (rate and channels, one SBR header, no PS), so ``mesh=``
raises where ``mesh=None`` does.  The blocks advance in lockstep, group g
parsed and launched on every block before group g - 1 is collected;
``mesh=None`` is the one-block case of the same loop.
"""

from __future__ import annotations

import numpy as np
import torch

from .._serving import serve_blocks, stream_blocks
from ..._host import aac_bitstream, aac_native, sbr_native
from ..._host import aac_sbr as SBR
from . import sbr as SBRD
from . import synthesis as SYN
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


def _survey(streams: list, nch: int, G: int,
            parse) -> tuple[int, int, int, int]:
    """Per-group capacities (escapes, side rows, short rows, TNS rows)
    that fit every group of the call, sized as the reference sizes them;
    ``parse`` is the native group parser of the call."""
    esc_cap = side_cap = ssf_cap = tns_cap = 0
    S = len(streams)
    pos = [0] * S
    live = [True] * S
    pbuf = None                  # reused parse arrays (~1 MB/call)
    while any(live):
        eb = sb = hb = tb = 0
        for s in range(S):
            if not live[s]:
                continue
            n, pos[s], pbuf = parse(streams[s], pos[s], channels=nch,
                                    max_frames=G, out=pbuf)
            live[s] = n == G
            if n == 0:
                continue
            R = n * nch
            eb += int((np.abs(pbuf["quant"][:R]) > 7).sum())
            exotic = (pbuf["cb"][:R] >= 13).any(axis=1)
            has_tns = pbuf["tnsn"][:R].any(axis=1)
            sb += int(exotic.sum())
            tb += int((has_tns & ~exotic).sum())
            hb += int((pbuf["ics"][:R, 0] == 2).sum())
        esc_cap = max(esc_cap, eb)
        side_cap = max(side_cap, sb)
        ssf_cap = max(ssf_cap, hb)
        tns_cap = max(tns_cap, tb)
    return (max(256, 1 << int(np.ceil(np.log2(esc_cap + 64)))),
            int(max(8, side_cap + 8)), int(max(64, ssf_cap + 8)),
            int(max(64, tns_cap + 8)))


def _side_rows(b: dict, special, nch: int, SC: int, col0: int, side, srow,
               n_side: int) -> int:
    """Host-prepare one stream's special rows into the side plane from
    slot ``n_side`` on; returns the next free slot."""
    frames = np.unique(np.asarray(special) // nch)
    idx = np.asarray([f * nch + cc for f in frames for cc in range(nch)])
    sub = {key: b[key][idx] for key in
           ("ics", "cb", "sf", "quant", "tnsn", "tnsp", "tnsc")}
    sub["msmask"] = b["msmask"][frames]
    sub["rate_index"] = b["rate_index"]
    sp, _ = SYN.prepare_group(sub, len(frames), nch,
                              np.zeros(nch, np.int32))
    fmap = {int(f): j for j, f in enumerate(frames)}
    for r in special:
        f, cc = divmod(int(r), nch)
        side[n_side] = sp[fmap[f], cc]
        srow[n_side] = f * SC + col0 + cc
        n_side += 1
    return n_side


def iter_groups(streams: list, frames_per_group: int = 64, *,
                sbr: bool = False):
    """Parse ``streams`` group by group.  Yields ``(planes, counts)``: the
    numpy wire planes of one device pass, keyed by ``synthesis.ZZ_PLANES``,
    ``ZZ_PLANES_AFTER_ESC`` and ``TNS_PLANES`` (plus ``rate_index``), and
    ``(stream, nframes)`` for every stream still live in the group.
    Columns of stream s are s * channels ... (s + 1) * channels - 1.  With
    ``sbr`` the streams are HE-AAC: planes["sbr"] then lists, in the order
    of ``counts``, each stream's (payload, nbits, crc) or None per frame."""
    native = aac_native()
    nch, ri = _header(streams)
    S, G = len(streams), frames_per_group
    SC = S * nch
    parse = native.aac_parse_group_sbr if sbr else native.aac_parse_group
    ACAP, MAXS, SSCAP, TNSCAP = _survey(streams, nch, G, parse)
    pos = [0] * S
    live = [True] * S
    pshape = [np.zeros(nch, np.int32) for _ in range(S)]
    pbuf = None
    while any(live):
        q4 = np.zeros((G, SC, 512), np.uint8)
        sfb = np.zeros((G, SC, 64), np.uint8)
        msb = np.zeros((G, SC // 2, 128), np.uint8)
        opx = np.zeros((G, SC), np.uint8)
        epak = np.full(ACAP, -1, np.int32)
        eva2 = np.zeros(ACAP, np.int16)
        side = np.zeros((MAXS, 1024), np.float32)
        srow = np.full(MAXS, -1, np.int32)
        esc = native.EscapeList(ACAP)
        ssfv = native.ShortSfPool(SSCAP)
        tnsv = native.TnsPool(TNSCAP)
        n_side = 0
        counts, payloads = [], []
        for s in range(S):
            if not live[s]:
                continue
            n, pos[s], pbuf = parse(streams[s], pos[s], channels=nch,
                                    max_frames=G, out=pbuf)
            live[s] = n == G
            counts.append((s, n))
            if sbr:
                # a new list of new bytes objects per parse: the next
                # stream's parse reuses pbuf's arrays but not these
                payloads.append(pbuf["sbr"])
            if n == 0:
                continue
            special = native.aac_prepare_rows_zz(
                pbuf, n, G, nch, pshape[s], esc, ssfv,
                q4=q4, sfb=sfb, msb=msb, opx=opx, col0=s * nch,
                max_special=G * nch, tns=tnsv)
            if special is None:
                raise ValueError("zz capacity exceeded (survey bug)")
            if len(special):
                n_side = _side_rows(pbuf, special, nch, SC, s * nch, side,
                                    srow, n_side)
        ne = esc.count.value
        epak[:ne] = esc.row[:ne] * 1024 + esc.pos[:ne]
        eva2[:ne] = esc.val[:ne]
        planes = dict(q4=q4, sfb=sfb, ssf=ssfv.sf, ssr=ssfv.row, msb=msb,
                      opx=opx, epak=epak, eva2=eva2, side=side, srow=srow,
                      tfi=tnsv.tfi, tco=tnsv.tco, tdir=tnsv.tdir,
                      trow=tnsv.row, rate_index=ri)
        if sbr:
            planes["sbr"] = payloads
        yield planes, counts


def to_device(planes: dict, device) -> dict:
    """Numpy wire planes -> tensors on ``device``, dtypes unchanged
    (``rate_index`` and ``sbr`` stay on the host)."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v)).to(device)
                if isinstance(v, np.ndarray) else v)
            for k, v in planes.items()}


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
        pcm16 = pcm16.cpu().numpy()
        for s, n in counts:
            if n:
                cols = pcm16[:n, s * nch:(s + 1) * nch]
                outs[s0 + s].append(cols.transpose(1, 0, 2).reshape(nch, -1))

    def launch(i, item):
        planes, counts = item
        dev, blk = shards[i]
        pcm, ovs[i] = decode_planes(to_device(planes, dev), ovs[i], consts[i])
        pcm16 = torch.round(pcm).clamp_(-32768, 32767).to(torch.int32)
        return pcm16, blk.start, counts

    serve_blocks(gens, launch, collect)
    return [np.concatenate(o, axis=1) if o else np.zeros((nch, 0), np.int32)
            for o in outs]


def _sbr_frames(dec, s: int, payloads: list, nch: int, hdr0,
                per_ch: list) -> None:
    """Parse and dequantise stream ``s``'s SBR payloads of one group with
    its decoder ``dec``, appending each frame's channel data and envelope
    and noise levels to per_ch[c] = (datas, Es, Qs), c < nch."""
    for pl in payloads:
        if pl is None:
            raise ValueError("frame without SBR payload")
        payload, nbits, crc = pl
        try:
            chans, coupling = dec.parse_payload(payload, nbits,
                                                stereo=(nch == 2), crc=crc)
        except SBR.SbrError as e:
            raise ValueError(f"stream {s}: {e}") from e
        if hdr0 is not None and dec.header != hdr0:
            raise ValueError("SBR header changed mid-stream")
        if chans[0].ps is not None:
            raise ValueError("PS (v2) stream: not served by this batch call")
        EQ = [dec.dequant(dec.header, chans[i].grid, chans[i].env,
                          chans[i].noise) for i in range(nch)]
        if nch == 2 and coupling:
            a = EQ[0][2]
            (EL, QL), (ER, QR) = dec.unmap_coupled(
                EQ[0][0], EQ[0][1], chans[1].env, chans[1].noise, a)
            EQ = [(EL, QL, a), (ER, QR, a)]
        for c in range(nch):
            datas, Es, Qs = per_ch[c]
            datas.append(chans[c])
            Es.append(EQ[c][0])
            Qs.append(EQ[c][1])


def decode_he_streams_device(streams: list, frames_per_group: int = 48, *,
                             device="cuda", mesh=None) -> list[np.ndarray]:
    """streams: ADTS HE-AAC v1 files (bytes) sharing sample rate, channel
    count and SBR header configuration.  Every stream's channels ride one
    device pass per group (the LC core, then the SBR group on the
    ``S * channels`` channel axis).  Parametric-stereo (v2) streams, frames
    without an SBR payload, SBR data before the first SBR header and a
    header that changes mid-stream raise ``ValueError``.  Returns
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
    decs = [SBR.SbrDecoder(rate) for _ in streams]
    runners: list = []
    hdr0 = None
    outs: list[list[np.ndarray]] = [[] for _ in streams]

    def collect(pcm16, s0, counts):             # (S*C, G*2048) int16
        pcm16 = pcm16.cpu().numpy()
        for s, n in counts:
            if n:
                outs[s0 + s].append(pcm16[s * nch:(s + 1) * nch, :n * 2048]
                                    .astype(np.int32))

    def parsed(i: int):
        """Block i's groups, with its streams' SBR payloads parsed and
        dequantised: (planes, counts, per_ch)."""
        blk = shards[i][1]
        for planes, counts in iter_groups(streams[blk], frames_per_group,
                                          sbr=True):
            # dead or short channels keep empty lists: their frames stay
            # inactive and their output is cut off in collect()
            per_ch: list = [([], [], [])
                            for _ in range((blk.stop - blk.start) * nch)]
            for (s, n), payloads in zip(counts, planes["sbr"]):
                g = blk.start + s
                _sbr_frames(decs[g], g, payloads, nch, hdr0,
                            per_ch[s * nch:(s + 1) * nch])
            yield planes, counts, per_ch

    def launch(i, item):
        nonlocal hdr0
        if not runners:     # every block's first group is parsed by now
            lead = next((s for s, d in enumerate(decs)
                         if d.header is not None), None)
            if lead is None:
                raise ValueError("no SBR header in any stream")
            hdr0 = decs[lead].header
            if any(d.header is not None and d.header != hdr0 for d in decs):
                raise ValueError("device batch needs one SBR header config")
            runners.extend(SBRD.SbrDeviceRunner(
                decs[lead], (blk.stop - blk.start) * nch, device=dev)
                for dev, blk in shards)
        planes, counts, per_ch = item
        dev, blk = shards[i]
        pcm16 = runners[i].decode_group_multi_zz(to_device(planes, dev),
                                                 per_ch, consts[i])
        return pcm16, blk.start, counts

    serve_blocks([parsed(i) for i in range(len(shards))], launch, collect)
    return [np.concatenate(o, axis=1) if o else np.zeros((nch, 0), np.int32)
            for o in outs]
