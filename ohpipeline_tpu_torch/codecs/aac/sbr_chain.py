"""The HE-AAC serving call's host SBR chain, native over dense arrays.

``decode_he_streams_device`` hands each stream's SBR payloads of a group
to :meth:`SbrChain.parse_group` inside ``sbr.parse``: one native call a
stream (``sbr_chain_parse`` in ``host/native/sbr_chain.cc``) reads the
payloads straight from the unpacker's planes (:class:`SbrPayloads`),
parses them with the stream's delta-coding state carried in arrays, and
writes the dequantised and unmapped envelope and noise levels, the grids,
the inverse-filtering modes and the harmonic flags per (channel, frame)
into one :class:`SbrGroup`.  At launch, inside ``sbr.cond``,
:meth:`SbrGroup.cond` fills the stacked ``SbrFrameCond`` planes from those
arrays in one native call (``sbr_chain_cond``) and advances each
channel's host state, kept as arrays (:class:`CondState`, one a block of
streams).

Where the native parse declines a stream's group (a frame without a
payload, SBR data before the header, a header other than the call's,
parametric stereo, a payload the native parser rejects, a level outside
the dequantisation tables, a grid with too few borders) the call raises
``ValueError``, worded by the Python chain (:func:`sbr_frames`, run over
that group from the stream's state before it) where that chain raises,
and otherwise by the call.  :func:`sbr_frames` and ``build_frame_cond``
over ``SbrDecoder`` objects stay the tests' oracle.  Nothing is kept
across serving calls.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..._host import aac_sbr as SBR
from ..._host import native
from ...tracing import count, span
from . import sbr as SBRD

_MAXB, _MAXQ, _MAXENV = native._SBR_MAXB, native._SBR_MAXQ, \
    native._SBR_MAXENV
# offsets into one stream's delta-coding state (sbr_chain.cc's P_*)
_P_LEN = 2 * _MAXB
_P_RES = _P_LEN + 2
_P_NOISE = _P_RES + 2
_SMOOTH = np.asarray(SBR._SMOOTH_FILTER, np.float64)


def _ptr(a: np.ndarray, row: int = 0) -> int:
    """The address of ``a[row]``."""
    return a.ctypes.data + row * a.strides[0]


class SbrPayloads:
    """One stream's SBR payloads of a group, as the AAC unpacker captures
    them: ``bytes`` (n, SBR_STRIDE) uint8, ``nbits`` (n,) int32 (0: the
    frame had none) and ``crc`` (n,) int32.  Indexing or iterating gives
    the Python chain's input, the ``(payload, nbits, crc)`` triple or None
    of a frame, as ``aac_parse_group_sbr``'s ``sbr`` list holds it."""

    __slots__ = ("bytes", "nbits", "crc")

    def __init__(self, data: np.ndarray, nbits: np.ndarray, crc: np.ndarray):
        self.bytes, self.nbits, self.crc = data, nbits, crc

    def __len__(self) -> int:
        return len(self.nbits)

    def __getitem__(self, f: int):
        nb = int(self.nbits[f])
        if nb <= 0:
            return None
        return (self.bytes[f, :(nb + 7) // 8].tobytes(), nb,
                bool(self.crc[f]))

    def __iter__(self):
        return (self[f] for f in range(len(self)))


def sbr_frames(dec, s: int, payloads, nch: int, hdr0,
               per_ch: list) -> None:
    """Parse and dequantise stream ``s``'s SBR payloads of one group (the
    (payload, nbits, crc) or None of each frame) with its decoder ``dec``,
    appending each frame's channel data and envelope and noise levels to
    per_ch[c] = (datas, Es, Qs), c < nch: the Python chain's parse half,
    the oracle of the native parse and the wording of its errors.  With
    ``hdr0`` set, a header other than it raises."""
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
    count("frames.sbr", len(payloads))


#: ``SbrFrameCond``'s planes in ``sbr_chain_cond``'s order.
COND_KEYS = ("Erow", "Qrow", "fres", "sine", "no_noise", "env_id", "prev_id",
             "r", "last_env", "noise_idx0", "sine_ph0", "bwk", "carry_mask")


class CondState:
    """The host SBR state of a block's ``C`` channels, as arrays: what
    ``SbrChannelState`` holds for ``build_frame_cond`` (``prev_invf``,
    ``bw``, ``noise_index``, ``sine_index``, ``prev_harm_bins`` as a mask
    over 64 bins, ``prev_tran_env``) and whether the channel's next group
    is its first.  It starts as a new ``SbrChannelState``."""

    ARRAYS = ("prev_invf", "bw", "noise_index", "sine_index", "prev_harm",
              "prev_tran", "first")

    def __init__(self, C: int):
        self.prev_invf = np.zeros((C, 5), np.int64)
        self.bw = np.zeros((C, 5), np.float64)
        self.noise_index = np.zeros(C, np.int64)
        self.sine_index = np.zeros(C, np.int64)
        self.prev_harm = np.zeros((C, 64), np.uint8)
        self.prev_tran = np.full(C, -1, np.int32)
        self.first = np.ones(C, np.uint8)


class SbrGroup:
    """A block's SBR frames of one group, per channel, parsed by
    ``chain``.  ``nf[c]``: the frames channel c has in the dense arrays (0
    for a stream with no frame in the group)."""

    def __init__(self, chain: "SbrChain", C: int, G: int):
        self.chain, self.C, self.G = chain, C, G
        self.nf = np.zeros(C, np.int32)
        self.arrays = None

    def dense(self, NB: int, NQ: int) -> dict:
        """The parse half's arrays, made at the first stream parsed:
        grid (C, G, 32) int32 (``sbr_parse_payload``'s layout), E (C, G,
        5, NB) and Q (C, G, 2, NQ) float64 levels, invf (C, G, NQ) int32,
        harm (C, G, NB) uint8."""
        if self.arrays is None:
            C, G = self.C, self.G
            self.arrays = dict(
                grid=np.empty((C, G, 32), np.int32),
                E=np.empty((C, G, _MAXENV, NB), np.float64),
                Q=np.empty((C, G, 2, NQ), np.float64),
                invf=np.empty((C, G, NQ), np.int32),
                harm=np.empty((C, G, NB), np.uint8))
        return self.arrays

    def cond(self, static, state: CondState) -> dict:
        """The stacked (C, ...) ``SbrFrameCond`` planes of the group over
        ``static`` (the ``SbrStatic`` of the chain's header), with the
        channels' host ``state`` advanced, in one native call."""
        with span("sbr.cond"):
            proto = vars(SBRD.SbrFrameCond(self.G, static))
            stacked = {k: np.broadcast_to(v, (self.C,) + v.shape).copy()
                       for k, v in proto.items()}
            # with no stream parsed the call still sets the counters'
            # seeds and ``first`` of the frameless channels
            a = self.dense(1, 1)
            NB, NQ = a["E"].shape[-1], a["Q"].shape[-1]
            chain, (low, high, noise) = self.chain, static._band_maps
            chain.lib.sbr_chain_cond(
                self.C, self.G, NB, NQ, _ptr(self.nf),
                *(_ptr(a[k]) for k in ("grid", "E", "Q", "invf", "harm")),
                static.kx, static.M, chain.ft.n_high, chain.ft.n_q,
                _ptr(chain._f_high), _ptr(static.patch_qi), low.shape[0],
                high.shape[0], static.nb_row, noise.shape[0],
                int(chain.header.smoothing_mode), _ptr(_SMOOTH),
                *(_ptr(getattr(state, k)) for k in CondState.ARRAYS),
                self.G, *(_ptr(stacked[k]) for k in COND_KEYS))
            return stacked


class SbrChain:
    """The parse half of one serving call over ``n`` streams of ``nch``
    channels at the core rate ``rate``.  The call's one SBR header is the
    first met (``header``, ``ft``); each stream's delta-coding state lives
    in ``pstate``, and ``have[g]`` says whether stream g has had the
    header."""

    def __init__(self, n: int, nch: int, rate: int):
        self.nch, self.rate = nch, rate
        self.lib = native.sbr_chain_lib()
        self.pstate = np.zeros((n, native.SBR_CHAIN_STATE), np.int32)
        self.pstate[:, _P_RES:_P_RES + 2] = 1
        self.have = np.zeros(n, bool)
        self.header = self.ft = None

    def decoder(self) -> SBR.SbrDecoder:
        """An ``SbrDecoder`` holding the call's header and its tables."""
        dec = SBR.SbrDecoder(self.rate)
        dec.header, dec.ft = self.header, self.ft
        return dec

    def parse_group(self, s0: int, counts: list, payloads: list, C: int,
                    G: int) -> SbrGroup:
        """A block's group: ``counts`` its live streams' ``(stream,
        frames)``, ``payloads`` their :class:`SbrPayloads`, streams
        numbered from ``s0`` in the call, ``C`` the block's channels.
        Raises ``ValueError`` where the native parse declines a stream's
        group (:meth:`_declined`)."""
        grp = SbrGroup(self, C, G)
        for (s, n), pl in zip(counts, payloads):
            if n:
                col = s * self.nch
                if not self._parse(s0 + s, pl, grp, col, G):
                    self._declined(s0 + s, pl)
                grp.nf[col:col + self.nch] = n
                count("frames.sbr", n)
        return grp

    def _parse(self, g: int, pl: SbrPayloads, grp: SbrGroup, col: int,
               G: int) -> bool:
        """Stream ``g``'s group through ``sbr_chain_parse`` into ``grp``'s
        columns from ``col``; False where it declines (nothing is
        committed then)."""
        if self.header is None:
            found = _leading_header(2 * self.rate, pl)
            if found is None:
                return False
            self.header, self.ft = found
            ft = self.ft
            self._hdr = np.asarray(dataclasses.astuple(self.header), np.int32)
            self._f_high = np.ascontiguousarray(ft.f_high, np.int32)
            self._h2l = (np.searchsorted(ft.f_low, ft.f_high[:ft.n_high],
                                         side="right") - 1).astype(np.int32)
            self._l2h = (np.searchsorted(ft.f_high, ft.f_low[:ft.n_low],
                                         side="right") - 1).astype(np.int32)
        ft = self.ft
        a = grp.dense(max(ft.n_high, ft.n_low), ft.n_q)
        ok = self.lib.sbr_chain_parse(
            _ptr(pl.bytes), pl.bytes.strides[0], _ptr(pl.nbits),
            _ptr(pl.crc), len(pl), int(self.nch == 2), _ptr(self._hdr),
            int(self.have[g]), ft.n_q, ft.n_low, ft.n_high,
            _ptr(self._h2l), _ptr(self._l2h), _ptr(self.pstate, g), G,
            a["E"].shape[-1], a["Q"].shape[-1],
            *(_ptr(a[k], col) for k in ("grid", "E", "Q", "invf", "harm")))
        if ok:
            self.have[g] = True
        return bool(ok)

    def _declined(self, g: int, pl: SbrPayloads) -> None:
        """Raise ``ValueError`` for stream g's group, which the native parse
        declined: the Python chain's error, run over the group from the
        stream's header and delta-coding state before it, and held to the
        call's header once the stream has had it; else the call's own."""
        dec = self.decoder() if self.have[g] else SBR.SbrDecoder(self.rate)
        dec._parse_prev, dec._ps_prev = self.parse_prev(g), None
        sbr_frames(dec, g, pl, self.nch,
                   self.header if self.have[g] else None,
                   [([], [], []) for _ in range(self.nch)])
        if dec.header != self.header:
            raise ValueError("device batch needs one SBR header config")
        raise ValueError(f"stream {g}: SBR group outside the serving chain")

    def parse_prev(self, g: int) -> list:
        """Stream g's delta-coding state in the form of ``SbrDecoder``'s
        ``_parse_prev``: per channel None or (env row, freq_res, noise
        row)."""
        st, prev = self.pstate[g], [None, None]
        for i in range(2):
            n = int(st[_P_LEN + i])
            if n:
                q0 = _P_NOISE + i * _MAXQ
                prev[i] = (st[i * _MAXB:i * _MAXB + n].copy(),
                           int(st[_P_RES + i]),
                           st[q0:q0 + self.ft.n_q].copy())
        return prev


def _leading_header(out_rate: int, pl: SbrPayloads):
    """The SBR header of ``pl``'s first frame and its tables at the output
    rate ``out_rate``; None if that frame has none or a bad one."""
    first = pl[0]
    if first is None:
        return None
    payload, nbits, crc = first
    b = SBR.Bits(payload, 0, nbits)
    try:
        if crc:
            b.read(10)
        if not b.read(1):
            return None
        header = SBR.parse_sbr_header(b)
        return header, SBR.derive_tables(out_rate, header)
    except SBR.SbrError:
        return None
