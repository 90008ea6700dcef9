"""CELT-only Opus synthesis for groups of frames, on tensors: the serving API.

Port of the device half of ``ohpipeline_tpu.codecs.opus.celt_jax``.  The
entropy layer stays on the host (the port's copy of ``celt.py`` with its
native core, ``decode_frame(synthesis=False)``), which captures per frame the
normalised coefficients, the band gains, the transient flag and the three
post-filter (lag, gain, tapset) triples.  :func:`device_decode_group` runs
everything after it for a whole group of frames of every stream in one pass:

* denormalise: ``freq = X * (gains @ band_expand)``;
* IMDCT and TDAC fold: the frame map is linear, so it is the probed matrix
  ``S[transient]`` (two layouts); rows split by the transient flag, so each
  row meets only its own matrix;
* the carried 60-sample TDAC tail: a frame's tail depends only on its own
  spectrum (the carry-in map ``Cm`` is zero past sample 960), so every
  frame's tail is known at once and frame f adds ``c60[f - 1] @ Cm[:, :960]``;
* the pitch post-filter comb, the one program that is sequential across
  frames (it reads samples it has already filtered, at lags 15-1024): the
  hand-written kernel ``csrc/celt_comb.cu`` on CUDA tensors and its plain
  version :func:`comb_torch` on CPU tensors;
* deemphasis as a Toeplitz product: the carry power vector ``dpow`` is
  exactly 0 in float32 from sample 640 on, so a frame's last sample, and
  with it the carry ``m`` into the next frame, does not depend on the
  carry it received; every frame's carry is known at once.

Matrix products stay ``torch.matmul`` in float32 with TF32 off (PyTorch's
default), as the reference runs ``Precision.HIGHEST``.  The group state is
``(hist, c60, m)``: (S, CH, 1026) comb history, (S, CH, 60) TDAC tail and
(S, CH) deemphasis memory; the path has no weights.
"""

from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from ... import _kernels
from ..._host import base, celt as CELT, ogg, opus_headers, split_packet_frames

N_FRAME = 960                        # 20 ms at 48 kHz (LM = 3)
HLEN = CELT.MAX_PERIOD + 2           # comb lookback: lag T <= 1024, taps +/-2
BLK = 12                             # the plain comb's block (< MINPERIOD - 2)
#: int16 wire scale of the normalised coefficients (|X| <= 1 per band).
X_SCALE = 16384.0
NB_BANDS = 21


def _tdac_batch(freqs: np.ndarray, carries: np.ndarray,
                transient: bool) -> np.ndarray:
    """Batched copy of the host per-block IMDCT + TDAC fold (the synthesis
    loop of ``celt.decode_frame``), used to probe the linear maps.  freqs
    (K, N), carries (K, ov // 2) -> buf (K, N + ov)."""
    mode = CELT.celt_mode()
    N = N_FRAME
    ov = mode.overlap
    B = 8 if transient else 1
    NB = N // B
    win = mode.window
    K = freqs.shape[0]
    buf = np.zeros((K, N + ov))
    buf[:, :ov // 2] = carries
    ii = np.arange(ov // 2)
    for b in range(B):
        raw = CELT._imdct(freqs[:, b::B] if B > 1 else freqs, NB)
        base_ = b * NB
        prev = buf[:, base_:base_ + ov // 2].copy()
        buf[:, base_ + ov // 2:base_ + ov // 2 + NB] = raw
        x1 = raw[:, ov // 2 - 1 - ii]
        buf[:, base_ + ii] = win[ov - 1 - ii] * prev - win[ii] * x1
        buf[:, base_ + ov - 1 - ii] = (win[ii] * prev
                                       + win[ov - 1 - ii] * x1)
    return buf


@functools.lru_cache(maxsize=1)
def _static_arrays() -> dict:
    """The group program's constants as float32 numpy arrays, made once."""
    mode = CELT.celt_mode()
    N = N_FRAME
    ov = mode.overlap
    coef0 = float(mode.preemph[0])
    eyeN = np.eye(N)
    z60 = np.zeros((N, ov // 2))
    eyeC = np.eye(ov // 2)
    zN = np.zeros((ov // 2, N))
    S = np.stack([_tdac_batch(eyeN, z60, False),
                  _tdac_batch(eyeN, z60, True)])
    Cm = np.stack([_tdac_batch(zN, eyeC, False),
                   _tdac_batch(zN, eyeC, True)])
    M = 8                                # bins per band unit at LM = 3
    be = np.zeros((mode.nb_ebands, N), np.float32)
    for i in range(mode.nb_ebands):
        be[i, M * int(mode.ebands[i]):M * int(mode.ebands[i + 1])] = 1
    i_ = np.arange(N)
    D = np.where(i_[:, None] >= i_[None, :],
                 coef0 ** np.maximum(i_[:, None] - i_[None, :], 0), 0.0)
    return dict(
        ov=ov, nb=mode.nb_ebands, coef0=coef0,
        S=S.astype(np.float32),                        # (2, N, N + ov)
        Cm=Cm.astype(np.float32),                      # (2, ov / 2, N + ov)
        band_expand=be,                                # (nb, N)
        deemph=D.T.astype(np.float32),                 # (in, out): x @ D
        dpow=(coef0 ** (i_ + 1) / coef0).astype(np.float32),  # c^i
        win2=(mode.window[:ov] ** 2).astype(np.float32))


class CeltDeviceStatic:
    """The group program's float32 constants on ``device``: the TDAC maps
    ``S`` and ``Cm``, ``band_expand``, the deemphasis Toeplitz ``deemph``
    and carry powers ``dpow``, and the squared overlap window ``win2``."""

    def __init__(self, device="cuda"):
        a = _static_arrays()
        self.device = torch.device(device)
        self.ov, self.nb, self.coef0 = a["ov"], a["nb"], a["coef0"]
        for name in ("S", "Cm", "band_expand", "deemph", "dpow", "win2"):
            setattr(self, name, torch.from_numpy(a[name]).to(self.device))


_STATICS: dict[str, CeltDeviceStatic] = {}


def device_static(device="cuda") -> CeltDeviceStatic:
    """The :class:`CeltDeviceStatic` of ``device``, made once."""
    key = str(torch.device(device))
    if key not in _STATICS:
        _STATICS[key] = CeltDeviceStatic(device)
    return _STATICS[key]


def comb_torch(y: torch.Tensor, Tv: torch.Tensor, gt: torch.Tensor,
               win2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``csrc/celt_comb.cu``: the feedback comb of
    ``celt_jax._comb_device``, frame after frame, in 12-sample blocks (every
    read lands before its block, since lags are >= 15).  y (R, HLEN + F * N)
    rows: carried history, then the frames' TDAC output; Tv (S, F, 3) int32
    lags and gt (S, F, 3, 3) float32 tap gains, shared by the R / S rows of
    a stream; win2 (120,).  Lags are clamped to [15, 1024] (only the zero
    padding of a partial group lies outside).  Returns (out (R, F * N),
    hist (R, HLEN))."""
    R, _ = y.shape
    S, F = Tv.shape[:2]
    N, ov = N_FRAME, win2.shape[0]
    dev = y.device
    y = y.clone()
    i_ = torch.arange(N, device=dev)
    seg = i_ >= ov
    within = i_ - seg.long() * ov
    f_w = torch.where(within < ov, win2[within.clamp(0, ov - 1)],
                      torch.ones((), device=dev))
    omf = 1.0 - f_w
    Tr = Tv.long().clamp(CELT.COMBFILTER_MINPERIOD, CELT.MAX_PERIOD) \
        .repeat_interleave(R // S, dim=0)                 # (R, F, 3)
    gr = gt.repeat_interleave(R // S, dim=0)              # (R, F, 3, 3)
    k = torch.arange(BLK, device=dev)
    offs = torch.arange(-2, 3, device=dev)
    segc = seg[None, :]
    for f in range(F):
        T0s = torch.where(segc, Tr[:, f, 1:2], Tr[:, f, 0:1])     # (R, N)
        T1s = torch.where(segc, Tr[:, f, 2:3], Tr[:, f, 1:2])
        g0v = torch.where(segc[..., None], gr[:, f, 1:2], gr[:, f, 0:1])
        g1v = torch.where(segc[..., None], gr[:, f, 2:3], gr[:, f, 1:2])

        def taps(pos, Tb, gb):
            idx = (pos + k - Tb)[..., None] + offs            # (R, BLK, 5)
            v = y.gather(1, idx.reshape(R, -1)).reshape(R, BLK, 5)
            return (gb[..., 0] * v[..., 2]
                    + gb[..., 1] * (v[..., 3] + v[..., 1])
                    + gb[..., 2] * (v[..., 4] + v[..., 0]))

        for b in range(N // BLK):
            loc = slice(b * BLK, (b + 1) * BLK)
            pos = HLEN + f * N + b * BLK
            cur = y[:, pos:pos + BLK]
            y[:, pos:pos + BLK] = (cur + omf[loc] * taps(pos, T0s[:, loc],
                                                         g0v[:, loc])
                                   + f_w[loc] * taps(pos, T1s[:, loc],
                                                     g1v[:, loc]))
    return y[:, HLEN:].clone(), y[:, -HLEN:].clone()


def comb(y, Tv, gt, win2):
    """The comb over a group: the ``celt_comb`` kernel on CUDA tensors (no
    fallback), :func:`comb_torch` on CPU tensors."""
    if y.device.type == "cpu":
        return comb_torch(y, Tv, gt, win2)
    return _kernels.celt_comb(y, Tv, gt, win2)


def _row_splits(op, CH: int, device) -> list:
    """[(layout k, row indices)] of the group's (S * F * CH) frame rows whose
    one-hot ``op`` picks TDAC layout k (0 long, 1 transient); rows of a
    zero-padded frame pick neither."""
    sel = np.asarray(op.cpu() if isinstance(op, torch.Tensor) else op)
    sel = np.repeat(sel.reshape(-1, 2) > 0, CH, axis=0)
    out = []
    for k in range(2):
        idx = np.flatnonzero(sel[:, k])
        if len(idx):
            out.append((k, torch.from_numpy(idx).to(device)))
    return out


def tdac(static: CeltDeviceStatic, X, gains, op, c60):
    """Denormalise, IMDCT and TDAC fold of a group, with the carried tails:
    -> ((S, F, CH, N) frame output before the comb, (S, F, CH, 60) each
    frame's tail).  Arguments as :func:`device_decode_group`'s."""
    S, F, CH, N = X.shape
    ov2 = static.ov // 2
    freq = (X.float() * (1.0 / X_SCALE)
            * torch.matmul(gains, static.band_expand)).reshape(-1, N)
    splits = _row_splits(op, CH, X.device)
    buf = torch.zeros((S * F * CH, N + static.ov), device=X.device)
    for k, idx in splits:
        buf[idx] = torch.matmul(freq[idx], static.S[k])
    buf = buf.reshape(S, F, CH, N + static.ov)
    tails = buf[..., N:N + ov2]
    prev = torch.cat([c60[:, None], tails[:, :-1]], dim=1).reshape(-1, ov2)
    out = buf[..., :N].reshape(-1, N)
    for k, idx in splits:
        out[idx] = out[idx] + torch.matmul(prev[idx], static.Cm[k][:, :N])
    return out.reshape(S, F, CH, N), tails


def comb_rows(hist, out):
    """The comb's rows: (S, CH, HLEN) history and (S, F, CH, N) frames ->
    (S * CH, HLEN + F * N), one row per stream and channel."""
    S, F, CH, N = out.shape
    return torch.cat([hist.reshape(S * CH, HLEN),
                      out.transpose(1, 2).reshape(S * CH, F * N)], dim=1)


def deemphasis(static: CeltDeviceStatic, filtered, m, S: int):
    """Deemphasis of the comb's (S * CH, F * N) output with the carried
    (S, CH) memory -> ((S, F, CH, N) int16 PCM, new memory)."""
    R = filtered.shape[0]
    x = filtered.reshape(S, R // S, -1, N_FRAME).transpose(1, 2)
    # one (S * F * CH, N) product: as a batch of (CH, N) rows per frame it
    # ran as a slow batched GEMM, 1.07 ms a group on an NVIDIA H100 80GB
    # HBM3 at 700 W (tools/profile_celt.py)
    mm = torch.matmul(x.reshape(-1, N_FRAME), static.deemph).reshape(x.shape)
    m_prev = torch.cat([m[:, None], static.coef0 * mm[:, :-1, :, -1]], dim=1)
    pcm = mm + m_prev[..., None] * static.dpow
    m_n = static.coef0 * pcm[:, -1, :, -1]
    return torch.round(pcm).clamp_(-32768, 32767).to(torch.int16), m_n


def device_decode_group(static: CeltDeviceStatic, X, gains, op, Tv, gt,
                        state):
    """One group of F frames of S streams -> ((S, F, CH, N) int16 PCM, new
    state), in one pass.  X (S, F, CH, N) int16 at ``X_SCALE``, gains (S, F,
    CH, nb) float32, Tv (S, F, 3) int32, gt (S, F, 3, 3) float32 and state
    ``(hist, c60, m)`` on the device of ``static``; op (S, F, 2), the one-hot
    transient layout of each frame, stays on the host (a numpy array or a
    CPU tensor), so the row split never waits on the card."""
    hist, c60, m = state
    S, _, CH, _ = X.shape
    out, tails = tdac(static, X, gains, op, c60)
    filtered, hist_n = comb(comb_rows(hist, out), Tv, gt, static.win2)
    pcm16, m_n = deemphasis(static, filtered, m, S)
    return pcm16, (hist_n.reshape(S, CH, HLEN), tails[:, -1].contiguous(),
                   m_n)


def init_state(S: int, channels: int, device="cuda") -> tuple:
    """The zero group state ``(hist, c60, m)`` of S streams."""
    z = functools.partial(torch.zeros, dtype=torch.float32, device=device)
    return (z((S, channels, HLEN)), z((S, channels, device_static(device).ov
                                       // 2)), z((S, channels)))


def state_from_jax(h, c, m, device="cuda") -> tuple:
    """The numpy state ``(h, c, m)`` of the JAX group program, one stream's
    ((CH, HLEN), (CH, 60), (CH,)) or S streams' (with a leading S axis), ->
    the port's state tensors on ``device``, with a leading stream axis."""
    arrs = [np.array(a, np.float32) for a in (h, c, m)]
    if arrs[2].ndim == 1:
        arrs = [a[None] for a in arrs]
    return tuple(torch.from_numpy(a).to(device) for a in arrs)


def _open_capture(data: bytes):
    """(channels, frame-capture generator) for one CELT-only 20 ms Ogg Opus
    stream: the host entropy decode, frame by frame."""
    packets = list(ogg.OggReader(base.BufferReader(data)).packets())
    opus_headers.parse_opus_head(packets[0])
    opus_headers.parse_opus_tags(packets[1])
    toc0, _ = split_packet_frames(packets[2])
    if toc0.mode != "celt" or toc0.frame_ms != 20:
        raise ValueError("device path: CELT-only 20 ms streams")
    sc = 2 if toc0.stereo else 1
    st = CELT.CeltDecoderState(sc)

    def gen():
        for pk in packets[2:]:
            toc, frames = split_packet_frames(pk)
            if toc.mode != "celt" or toc.frame_ms != 20:
                raise ValueError("device path: CELT-only 20 ms streams")
            if (2 if toc.stereo else 1) != sc:
                raise ValueError("device path: mono/stereo switch")
            for f in frames:
                yield CELT.decode_frame(st, f, N_FRAME, synthesis=False)

    return sc, gen()


def capture_stream(data: bytes):
    """Host side: Ogg Opus -> (channels, per-frame entropy captures).  Only
    CELT-only 20 ms streams are served; anything else raises
    ``ValueError``."""
    sc, gen = _open_capture(data)
    return sc, list(gen)


def pack_captures(caps: list, channels: int):
    """Captures of F frames -> the group's numpy wire: X (F, CH, N) int16 at
    ``X_SCALE``, gains (F, CH, 21) float32, op (F, 2) one-hot transient
    layout, Tv (F, 3) int32 lags, gt (F, 3, 3) float32 tap gains (gain x
    ``COMB_GAINS[tapset]``)."""
    F = len(caps)
    X = np.zeros((F, channels, N_FRAME), np.int16)
    gains = np.zeros((F, channels, NB_BANDS), np.float32)
    op = np.zeros((F, 2), np.float32)
    Tv = np.zeros((F, 3), np.int32)
    gt = np.zeros((F, 3, 3), np.float32)
    for i, cp in enumerate(caps):
        X[i] = np.clip(np.rint(cp["X"] * X_SCALE), -32768, 32767)
        gains[i] = cp["gains"]
        op[i, 1 if cp["is_transient"] else 0] = 1.0
        for k, (T, g, tap) in enumerate(cp["pf"]):
            Tv[i, k] = T
            gt[i, k] = g * np.asarray(CELT.COMB_GAINS[tap])
    return X, gains, op, Tv, gt


def decode_celt_stream_device(data: bytes, group: int = 32, *,
                              device="cuda") -> np.ndarray:
    """Whole-stream decode of one CELT-only Ogg Opus stream -> (channels, n)
    int16 PCM at 48 kHz (no pre-skip or gain trim: the synthesis path's
    surface), in groups of ``group`` frames."""
    return decode_celt_streams_device([data], group, device=device)[0]


def decode_celt_streams_device(streams: list, group: int = 32, *,
                               device="cuda") -> np.ndarray:
    """The multi-stream serving call: S CELT-only 20 ms Ogg Opus streams
    sharing a channel count, entropy on the host, synthesis of every
    stream's group in one device pass.  A partial tail group is zero-padded
    (silence frames) and the output is trimmed to the shortest stream.
    Mixed channel counts and streams that are not CELT-only 20 ms raise
    ``ValueError``.  The host captures group g + 1 while the device runs
    group g, whose PCM is copied back after the next group is queued; no
    thread is involved.  Returns (S, CH, n) int16."""
    gens: list = []
    try:
        ch0 = None
        for i, s in enumerate(streams):
            ch, gen = _open_capture(s)
            gens.append(gen)
            ch0 = ch0 or ch
            if ch != ch0:
                raise ValueError(
                    f"stream {i}: {ch} channels, batch is {ch0}-channel")
        S = len(gens)
        static = device_static(device)
        state = init_state(S, ch0, device)
        outs: list[np.ndarray] = []
        pending = None
        while True:
            chunks = [list(itertools.islice(g, group)) for g in gens]
            n = min(len(c) for c in chunks)
            if n == 0:
                break
            X = np.zeros((S, group, ch0, N_FRAME), np.int16)
            gains = np.zeros((S, group, ch0, NB_BANDS), np.float32)
            op = np.zeros((S, group, 2), np.float32)
            Tv = np.zeros((S, group, 3), np.int32)
            gt = np.zeros((S, group, 3, 3), np.float32)
            for si, c in enumerate(chunks):
                for dst, src in zip((X, gains, op, Tv, gt),
                                    pack_captures(c[:n], ch0)):
                    dst[si, :n] = src
            Xt, gains_t, Tv_t, gt_t = (torch.from_numpy(a).to(device)
                                       for a in (X, gains, Tv, gt))
            pcm16, state = device_decode_group(static, Xt, gains_t, op, Tv_t,
                                               gt_t, state)
            if pending is not None:
                outs.append(pending.cpu().numpy())
            pending = pcm16[:, :n]
            if n < group:
                break
        if pending is not None:
            outs.append(pending.cpu().numpy())
    finally:
        for g in gens:
            g.close()
    if not outs:
        return np.zeros((len(streams), ch0 or 0, 0), np.int16)
    pcm = np.concatenate(outs, axis=1)                    # (S, F, CH, N)
    return pcm.transpose(0, 2, 1, 3).reshape(S, ch0, -1)
