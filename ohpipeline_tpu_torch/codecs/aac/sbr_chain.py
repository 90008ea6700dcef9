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
channel's host state, kept as arrays (:class:`CondState`).

The Python chain (``serving._sbr_frames`` and ``build_frame_cond`` over
``SbrDecoder`` objects) stays the oracle, and takes over a stream's group
wherever the native parse declines it: a frame without a payload, SBR
data before the header, a header other than the call's, parametric
stereo, a payload the native parser rejects, a level outside the
dequantisation tables.  The state is handed across both ways, the group
then raises or decodes as that chain makes it, and the counter
``fallback.sbr`` counts it.  Without the native library every stream's
group takes the Python chain.  Nothing is kept across serving calls.
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
_P_HAVE = _P_NOISE + 2 * _MAXQ


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


#: ``SbrFrameCond``'s planes in ``sbr_chain_cond``'s order.
COND_KEYS = ("Erow", "Qrow", "fres", "sine", "no_noise", "env_id", "prev_id",
             "r", "last_env", "noise_idx0", "sine_ph0", "bwk", "carry_mask")


class SbrGroup:
    """A block's SBR frames of one group, per channel.  ``nf[c]``: the
    frames channel c has in the dense arrays (0 for a stream with no frame
    in the group), or -1 where the Python chain parsed its stream's group
    and ``py[c]`` holds its ``(datas, Es, Qs)``."""

    def __init__(self, lib, C: int, G: int):
        self.lib, self.C, self.G = lib, C, G
        self.nf = np.zeros(C, np.int32)
        self.py: dict = {}
        self.arrays = None

    # a sequence of channels, as the Python chain's per-channel list is:
    # len(), slices and concatenation give the group of those channels
    def __len__(self) -> int:
        return self.C

    def __getitem__(self, idx: slice) -> "SbrGroup":
        return self._of([(self, c) for c in range(self.C)][idx])

    def __add__(self, other: "SbrGroup") -> "SbrGroup":
        return self._of([(self, c) for c in range(self.C)]
                        + [(other, c) for c in range(other.C)])

    def _of(self, cols: list) -> "SbrGroup":
        """A group of the channels ``cols``, (group, channel) pairs."""
        out = SbrGroup(self.lib, len(cols), self.G)
        for i, (g, c) in enumerate(cols):
            out.nf[i] = g.nf[c]
            if g.nf[c] < 0:
                out.py[i] = g.py[c]
            elif g.nf[c] > 0:
                a = g.arrays
                d = out.dense(a["E"].shape[-1], a["Q"].shape[-1])
                for k in d:
                    d[k][i] = a[k][c]
        return out

    def dense(self, NB: int, NQ: int) -> dict:
        """The parse half's arrays, made at the first stream parsed
        natively: grid (C, G, 32) int32 (``sbr_parse_payload``'s layout),
        E (C, G, 5, NB) and Q (C, G, 2, NQ) float64 levels, invf (C, G,
        NQ) int32, harm (C, G, NB) uint8."""
        if self.arrays is None:
            C, G = self.C, self.G
            self.arrays = dict(
                grid=np.empty((C, G, 32), np.int32),
                E=np.empty((C, G, _MAXENV, NB), np.float64),
                Q=np.empty((C, G, 2, NQ), np.float64),
                invf=np.empty((C, G, NQ), np.int32),
                harm=np.empty((C, G, NB), np.uint8))
        return self.arrays

    def cond(self, runner, F: int) -> dict:
        """The stacked (C, ...) ``SbrFrameCond`` planes of the group for
        ``runner`` (an ``SbrDeviceRunner``), with its channels' host state
        advanced: the native channels in one call, the Python chain's with
        ``build_frame_cond`` on that state handed across."""
        with span("sbr.cond"):
            cs = runner.cond_state
            if cs is None:
                cs = runner.cond_state = CondState(runner)
            proto = vars(SBRD.SbrFrameCond(F, runner.static))
            stacked = {k: np.broadcast_to(v, (self.C,) + v.shape).copy()
                       for k, v in proto.items()}
            if self.lib is not None:
                # with no stream parsed natively the call still sets the
                # counters' seeds and ``first`` of the frameless channels
                a = self.dense(1, 1)
                NB, NQ = a["E"].shape[-1], a["Q"].shape[-1]
                st = runner.static
                self.lib.sbr_chain_cond(
                    self.C, self.G, NB, NQ, _ptr(self.nf),
                    *(_ptr(a[k]) for k in ("grid", "E", "Q", "invf",
                                           "harm")),
                    st.kx, st.M, cs.n_high, cs.n_q, _ptr(cs.f_high),
                    _ptr(st.patch_qi), cs.nb_low, cs.nb_high, st.nb_row,
                    cs.nq_row, cs.smoothing_mode, _ptr(cs.smooth),
                    *(_ptr(getattr(cs, k)) for k in CondState.ARRAYS), F,
                    *(_ptr(stacked[k]) for k in COND_KEYS))
            for ch in np.flatnonzero(self.nf < 0):
                view = SBRD.SbrFrameCond.__new__(SBRD.SbrFrameCond)
                for k in proto:
                    setattr(view, k, stacked[k][ch])
                st = runner.state_host[ch]
                cs.store(ch, st)
                SBRD.build_frame_cond(runner.dec, st, runner.static,
                                      *self.py[ch], bool(cs.first[ch]),
                                      cond=view)
                cs.load(ch, st)
                cs.first[ch] = 0
            return stacked


class CondState:
    """The host SBR state of a runner's channels on the serving wire, as
    arrays: what ``SbrChannelState`` holds for ``build_frame_cond``
    (``prev_invf``, ``bw``, ``noise_index``, ``sine_index``,
    ``prev_harm_bins`` as a mask over 64 bins, ``prev_tran_env``) and the
    runner's ``first``; with the band tables of its header."""

    ARRAYS = ("prev_invf", "bw", "noise_index", "sine_index", "prev_harm",
              "prev_tran", "first")

    def __init__(self, runner):
        C = len(runner.state_host)
        self.prev_invf = np.zeros((C, 5), np.int64)
        self.bw = np.zeros((C, 5), np.float64)
        self.noise_index = np.zeros(C, np.int64)
        self.sine_index = np.zeros(C, np.int64)
        self.prev_harm = np.zeros((C, 64), np.uint8)
        self.prev_tran = np.zeros(C, np.int32)
        self.first = np.asarray(runner.first, np.uint8)
        for ch, st in enumerate(runner.state_host):
            self.load(ch, st)
        ft, static = runner.dec.ft, runner.static
        self.n_high, self.n_q = ft.n_high, ft.n_q
        self.f_high = np.ascontiguousarray(ft.f_high, np.int32)
        self.nb_low = static._band_maps[0].shape[0]
        self.nb_high = static._band_maps[1].shape[0]
        self.nq_row = static.map_noise.shape[0]
        self.smoothing_mode = int(runner.dec.header.smoothing_mode)
        self.smooth = np.asarray(SBR._SMOOTH_FILTER, np.float64)

    def load(self, ch: int, st) -> None:
        """Channel ``ch``'s row from the ``SbrChannelState`` ``st``."""
        self.prev_invf[ch] = st.prev_invf
        self.bw[ch] = st.bw
        self.noise_index[ch] = st.noise_index
        self.sine_index[ch] = st.sine_index
        self.prev_harm[ch] = 0
        self.prev_harm[ch, list(st.prev_harm_bins)] = 1
        self.prev_tran[ch] = st.prev_tran_env

    def store(self, ch: int, st) -> None:
        """Channel ``ch``'s row into the ``SbrChannelState`` ``st``."""
        st.prev_invf = self.prev_invf[ch].copy()
        st.bw = self.bw[ch].copy()
        st.noise_index = int(self.noise_index[ch])
        st.sine_index = int(self.sine_index[ch])
        st.prev_harm_bins = {int(k) for k in
                             np.flatnonzero(self.prev_harm[ch])}
        st.prev_tran_env = int(self.prev_tran[ch])


class SbrChain:
    """The parse half of one serving call over its streams' decoders
    ``decs`` (``SbrDecoder``, which keep each stream's header for the
    call's checks and the Python chain), ``nch`` channels a stream.
    ``frames`` is the Python chain's parse half (``serving._sbr_frames``).
    Each stream's delta-coding state lives in ``pstate`` while the native
    parse has it, and in its decoder's ``_parse_prev`` after the Python
    chain took its last group."""

    def __init__(self, decs: list, nch: int, frames):
        self.decs, self.nch, self.frames = decs, nch, frames
        self.lib = native.sbr_chain_lib()
        self.pstate = np.zeros((len(decs), native.SBR_CHAIN_STATE),
                               np.int32)
        self.pstate[:, _P_RES:_P_RES + 2] = 1
        self.native = np.ones(len(decs), bool)
        self.header = self.ft = None
        count("fallback.sbr", 0)    # present, at 0, in tracing.snapshot()

    def set_header(self, header, ft) -> None:
        """The call's one SBR header and its frequency tables: the first
        header met, then (at the first launch) the batch's.  A stream the
        native parse took holds the header it met in its decoder, so the
        batch's can differ only where no stream's state is native."""
        if header == self.header:
            return
        self.header, self.ft = header, ft
        self._hdr = np.asarray(dataclasses.astuple(header), np.int32)
        self._h2l = (np.searchsorted(ft.f_low, ft.f_high[:ft.n_high],
                                     side="right") - 1).astype(np.int32)
        self._l2h = (np.searchsorted(ft.f_high, ft.f_low[:ft.n_low],
                                     side="right") - 1).astype(np.int32)

    def parse_group(self, s0: int, counts: list, payloads: list, C: int,
                    G: int, hdr0) -> SbrGroup:
        """A block's group: ``counts`` its live streams' ``(stream,
        frames)``, ``payloads`` their :class:`SbrPayloads`, streams
        numbered from ``s0`` in the call, ``C`` the block's channels.
        ``hdr0`` is the batch's header once the first group launched.
        Raises ``ValueError`` as the Python chain does."""
        grp = SbrGroup(self.lib, C, G)
        nch = self.nch
        for (s, n), pl in zip(counts, payloads):
            g, cols = s0 + s, range(s * nch, (s + 1) * nch)
            if n and self._parse(g, pl, grp, cols.start, G):
                grp.nf[cols] = n
                count("frames.sbr", n)
            elif n or self.lib is None:     # a stream without frames: nf 0
                if n:
                    count("fallback.sbr")
                if self.native[g]:
                    self._export(g)
                per = [([], [], []) for _ in cols]
                self.frames(self.decs[g], g, pl, nch, hdr0, per)
                grp.nf[cols] = -1
                grp.py.update(zip(cols, per))
        return grp

    def _parse(self, g: int, pl: SbrPayloads, grp: SbrGroup, col: int,
               G: int) -> bool:
        """Stream ``g``'s group through ``sbr_chain_parse`` into ``grp``'s
        columns from ``col``; False where the Python chain must take it."""
        if self.lib is None:
            return False
        dec = self.decs[g]
        if self.header is None:
            found = (dec.header, dec.ft) if dec.header is not None \
                else _leading_header(dec, pl)
            if found is None:
                return False
            self.set_header(*found)
        if dec.header is not None and dec.header != self.header:
            return False
        if not self.native[g]:
            self._import(g)
        ft = self.ft
        a = grp.dense(max(ft.n_high, ft.n_low), ft.n_q)
        ok = self.lib.sbr_chain_parse(
            _ptr(pl.bytes), pl.bytes.strides[0], _ptr(pl.nbits),
            _ptr(pl.crc), len(pl), int(self.nch == 2), _ptr(self._hdr),
            int(dec.header is not None), ft.n_q, ft.n_low, ft.n_high,
            _ptr(self._h2l), _ptr(self._l2h), _ptr(self.pstate, g), G,
            a["E"].shape[-1], a["Q"].shape[-1],
            *(_ptr(a[k], col) for k in ("grid", "E", "Q", "invf", "harm")))
        if not ok:
            return False
        self.native[g] = True
        if dec.header is None:
            dec.header, dec.ft = self.header, ft
        return True

    def _import(self, g: int) -> None:
        """Stream g's delta-coding state from its decoder's
        ``_parse_prev``."""
        st = self.pstate[g]
        st[:] = 0
        st[_P_RES:_P_RES + 2] = 1
        for i, prev in enumerate(getattr(self.decs[g], "_parse_prev",
                                         [None, None])[:2]):
            if prev is not None:
                env, res, noise = prev
                q0 = _P_NOISE + i * _MAXQ
                st[i * _MAXB:i * _MAXB + len(env)] = env
                st[q0:q0 + len(noise)] = noise
                st[_P_LEN + i], st[_P_RES + i], st[_P_HAVE + i] = \
                    len(env), res, 1

    def parse_prev(self, g: int) -> list:
        """Stream g's delta-coding state in the form of ``SbrDecoder``'s
        ``_parse_prev``: per channel None or (env row, freq_res, noise
        row)."""
        if not self.native[g]:
            return getattr(self.decs[g], "_parse_prev", [None, None])
        st, prev = self.pstate[g], [None, None]
        for i in range(2):
            n = int(st[_P_LEN + i])
            if n:
                q0 = _P_NOISE + i * _MAXQ
                prev[i] = (st[i * _MAXB:i * _MAXB + n].copy(),
                           int(st[_P_RES + i]),
                           st[q0:q0 + self.ft.n_q].copy())
        return prev

    def _export(self, g: int) -> None:
        """Stream g's delta-coding state into its decoder's
        ``_parse_prev``, for the Python chain."""
        dec = self.decs[g]
        dec._parse_prev = self.parse_prev(g)
        dec._ps_prev = getattr(dec, "_ps_prev", None)
        self.native[g] = False


def _leading_header(dec, pl: SbrPayloads):
    """The SBR header of ``pl``'s first frame and its tables, for the
    decoder ``dec``'s rate; None if that frame has none or a bad one."""
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
        return header, SBR.derive_tables(dec.out_rate, header)
    except SBR.SbrError:
        return None
