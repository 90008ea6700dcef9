"""HE-AAC v1 SBR reconstruction for groups of frames, on tensors.

Port of the device half of ``ohpipeline_tpu.codecs.aac.sbr_jax``.  Its host
half (``SbrStatic``, ``SbrFrameCond``, ``device_init_state`` and the cond
builder ``build_frame_cond``, which advances the per-channel counters of the
numpy chain in ``sbr.py``) is the port's copy ``host/codecs/aac/sbr_host.py``,
reached through ``_host``.  The numpy cond planes and state dicts cross to the device
through :func:`cond_to_device` and :func:`state_to_device`.

:func:`device_decode_group` is ``sbr_jax.device_decode_group`` batched over a
leading channel axis ``C`` in place of ``jax.vmap``: analysis QMF (two
float32 products over shifted block slices), the 38-slot windows on the
delayed-output timeline, the HF generator, the cond expansion, the envelope
adjustment, the frame scan and the synthesis QMF.  The frame scan
(smoothing, noise and sine injection with the noise and sine values
regenerated from the counter seeds, and the 6-slot tail carry) runs as the
hand-written kernel ``csrc/sbr_env.cu`` on CUDA tensors and as its plain
version, :func:`noise_sine_planes` followed by :func:`envelope_scan_torch`,
on CPU tensors.  Matrix products stay
``torch.matmul`` in float32 with TF32 off, as the reference runs
``Precision.HIGHEST``.

:class:`SbrDeviceRunner` is the zigzag-wire multi-stream runner of the
serving path: the AAC-LC core (``synthesis.decode_chunk_zz``) and the SBR
group of every stream's channels in one pass, with the SBR state and the
core overlap kept on the device across groups.  The per-channel,
spec-mode and PS methods of the JAX runner are not ported.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ... import _kernels
from ..._host import aac_sbr as SBR
from ..._host import aac_sbr_jax as SJ
from . import synthesis as SYN

MAXE, NSL = SJ.MAXE, SJ.NSL
#: Output slots of a frame; the rest of its NSL slots ride the tail carry.
NOUT = 32
SbrStatic = SJ.SbrStatic
SbrFrameCond = SJ.SbrFrameCond
device_init_state = SJ.device_init_state
build_frame_cond = SJ.build_frame_cond

_CONSTS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _consts(static: SbrStatic, device) -> dict:
    """``static``'s constant planes as tensors on ``device``, made once."""
    per = _CONSTS.setdefault(static, {})
    key = str(torch.device(device))
    if key not in per:
        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.ascontiguousarray(a),
                                   dtype=dtype).to(device)

        src = static.patch_src
        per[key] = dict(
            Kre=t(static.K_ana.real.T), Kim=t(static.K_ana.imag.T),
            syn_re=t(static.syn_re), syn_im=t(static.syn_im),
            src=t(np.where(src >= 0, src, 0), torch.long),
            is_patch=t(src >= 0, torch.bool),
            map_low=t(static.map_low), map_high=t(static.map_high),
            map_noise=t(static.map_noise), limiter=t(static.limiter),
            noise_re=t(static.noise_tab_re), noise_im=t(static.noise_tab_im),
            parity=t(static.parity))
    return per[key]


def cond_to_device(stacked: dict, device) -> dict:
    """(C, ...)-stacked numpy cond planes (``SbrFrameCond`` fields) ->
    tensors on ``device``, dtypes unchanged."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in stacked.items()}


def state_to_device(states: list, device) -> dict:
    """Per-channel ``device_init_state`` dicts -> (C, ...) stacked float32
    tensors on ``device``."""
    return {k: torch.from_numpy(np.stack([s[k] for s in states])
                                .astype(np.float32)).to(device)
            for k in states[0]}


def _gather_env(planes, idx):
    """planes (C, K, M), idx (C, S) int -> (C, S, M) rows planes[c, idx];
    all-zero rows where idx < 0 (``jax.nn.one_hot`` of -1 is a zero row)."""
    M = planes.shape[-1]
    rows = torch.gather(planes, 1,
                        idx.clamp_min(0)[..., None].expand(-1, -1, M))
    return torch.where((idx >= 0)[..., None], rows, 0.0)


def envelope_scan_torch(gain, noise, sine, sine_bins, env_id, prev_id,
                        last_env, r, carry_mask, nre, nim, sre, sim, er, ei,
                        filt, tail_r, tail_i):
    """Plain version of the frame scan (``sbr_jax.frame_step``): a loop
    over frames, vectorised over channels, slots and bins.

    gain, noise, sine (levels) and sine_bins (0/1) are (C, F, MAXE, M)
    float32 per envelope; env_id (slot -> envelope, -1 = inactive slot) and
    prev_id (smoothing source: an envelope of this frame, or MAXE for the
    carried ``filt``) are (C, F, NSL) int; last_env (C, F) int is the
    envelope whose levels the frame leaves in ``filt`` (-1 = none); r
    (smoothing ratio) and carry_mask (1 = the slot takes the carried tail)
    are (C, F, NSL) float32; nre, nim, sre, sim (noise and sine values) and
    er, ei (the HF-patched QMF slots) are (C, F, NSL, M) float32; filt (C,
    2, M) holds the carried gain and noise levels and tail_r / tail_i (C,
    6, M) the carried adjusted slots.  Returns (out_r, out_i (C, F, 32, M),
    filt, tail_r, tail_i).
    """
    C, F = gain.shape[:2]
    M = gain.shape[-1]
    pad = er.new_zeros((C, NSL - tail_r.shape[1], M))
    outs_r, outs_i = [], []
    for f in range(F):
        e, p = env_id[:, f].long(), prev_id[:, f].long()
        Gf, Nf = gain[:, f], noise[:, f]
        Gcur, Ncur = _gather_env(Gf, e), _gather_env(Nf, e)
        Gprev = _gather_env(torch.cat([Gf, filt[:, :1]], 1), p)
        Nprev = _gather_env(torch.cat([Nf, filt[:, 1:]], 1), p)
        rf = r[:, f, :, None]
        g_sl = rf * Gprev + (1 - rf) * Gcur
        n_sl = rf * Nprev + (1 - rf) * Ncur
        s_sl = _gather_env(sine[:, f], e)
        sine_mask = _gather_env(sine_bins[:, f], e)
        cm = carry_mask[:, f, :, None] > 0
        x_r = torch.where(cm, torch.cat([tail_r, pad], 1), er[:, f])
        x_i = torch.where(cm, torch.cat([tail_i, pad], 1), ei[:, f])
        o_r = x_r * g_sl + nre[:, f] * n_sl * (1 - sine_mask) \
            + sre[:, f] * s_sl
        o_i = x_i * g_sl + nim[:, f] * n_sl * (1 - sine_mask) \
            + sim[:, f] * s_sl
        act = (e >= 0)[..., None]
        o_r = torch.where(act, o_r, x_r)
        o_i = torch.where(act, o_i, x_i)
        le = last_env[:, f].long()[:, None]
        new = torch.cat([_gather_env(Gf, le), _gather_env(Nf, le)], 1)
        filt = torch.where((le >= 0)[..., None], new, filt)
        outs_r.append(o_r[:, :NOUT])
        outs_i.append(o_i[:, :NOUT])
        tail_r, tail_i = o_r[:, NOUT:], o_i[:, NOUT:]
    return (torch.stack(outs_r, 1), torch.stack(outs_i, 1), filt, tail_r,
            tail_i)


def _onehot(env_id):
    """(..., NSL) slot -> envelope ids -> (..., NSL, MAXE) float32 one-hot
    rows; id -1 gives an all-zero row."""
    return (env_id.long()[..., None]
            == torch.arange(MAXE, device=env_id.device)).to(torch.float32)


def slot_order(env_id):
    """(C, F, NSL) int32: the number of active slots (env_id >= 0) before
    each slot of a channel's group, in (frame, slot) order.  The host
    advances noise_index by M and sine_index by 1 per active slot, so this
    count places every slot on the counters."""
    act = (env_id >= 0).reshape(env_id.shape[0], -1).to(torch.int32)
    return (torch.cumsum(act, 1, dtype=torch.int32) - act) \
        .reshape(env_id.shape)


def noise_sine_planes(env_id, sine_bins, k_ord, noise_idx0, sine_ph0,
                      no_noise, noise_re, noise_im, parity, inject_cal):
    """The (C, F, NSL, M) float32 noise and sine value planes (nre, nim,
    sre, sim) of the frame scan, regenerated from the counter seeds:
    env_id (C, F, NSL) and sine_bins (C, F, MAXE, M) as the scan takes
    them, k_ord (:func:`slot_order`), noise_idx0 / sine_ph0 (C,) int32 the
    noise-table index and sine phase before the group, no_noise (C, F,
    MAXE) float32 (1 = no noise in that envelope), the 512-entry noise
    tables, the (M,) parity row of +-1 and the float ``inject_cal``.  Every
    value is a table entry times 0 or 1, or 0 or +-inject_cal, so it is
    exact."""
    M = sine_bins.shape[-1]
    A = _onehot(env_id)
    k = k_ord.long()
    nidx = ((noise_idx0.long()[:, None, None] + k * M)[..., None] + 1
            + torch.arange(M, device=env_id.device)) & 511
    # zero on inactive slots and inside no-noise envelopes (the counters
    # still advance there)
    nn_slot = torch.matmul(A, no_noise[..., None])[..., 0]
    nmask = ((env_id >= 0).to(torch.float32) * (1.0 - nn_slot))[..., None]
    nre = noise_re[nidx] * nmask
    nim = noise_im[nidx] * nmask
    ph = ((sine_ph0.long()[:, None, None] + k) & 3)[..., None]
    ph_re = torch.where(ph == 0, 1.0, torch.where(ph == 2, -1.0, 0.0))
    ph_im = torch.where(ph == 1, 1.0, torch.where(ph == 3, -1.0, 0.0))
    sine_slot = torch.matmul(A, sine_bins)                  # (C, F, NSL, M)
    sre = ph_re * sine_slot * inject_cal
    sim = ph_im * parity * sine_slot * inject_cal
    return nre, nim, sre, sim


def plane_args(gain, noise, sine, sine_bins, env_id, prev_id, last_env, r,
               carry_mask, k_ord, noise_idx0, sine_ph0, no_noise, noise_re,
               noise_im, parity, inject_cal, er, ei, filt, tail_r, tail_i):
    """The frame scan's compact arguments (as :func:`envelope_scan` and the
    kernel take them) -> those of :func:`envelope_scan_torch`, with the
    noise and sine planes of :func:`noise_sine_planes`."""
    planes = noise_sine_planes(env_id, sine_bins, k_ord, noise_idx0,
                               sine_ph0, no_noise, noise_re, noise_im,
                               parity, inject_cal)
    return (gain, noise, sine, sine_bins, env_id, prev_id, last_env, r,
            carry_mask, *planes, er, ei, filt, tail_r, tail_i)


def envelope_scan(*args):
    """The frame scan on its compact arguments (:func:`plane_args`;
    results of :func:`envelope_scan_torch`): the ``csrc/sbr_env.cu``
    kernel for CUDA tensors; for CPU tensors its plain version,
    :func:`noise_sine_planes` followed by :func:`envelope_scan_torch`."""
    dev = args[0].device
    if dev.type == "cuda":
        return _kernels.sbr_env(*args)
    if dev.type == "cpu":
        return envelope_scan_torch(*plane_args(*args))
    raise ValueError(f"envelope_scan: no kernel for device {dev}")


def envelope_inputs(static: SbrStatic, pcm, cond: dict, state: dict):
    """Everything of :func:`device_decode_group` up to the frame scan.
    Returns (scan arguments, the compact form :func:`envelope_scan` takes;
    (Xre_ext, Xim_ext) the (C, 6 + F*32, 32) low-band slot timeline; the
    new ana_hist, x_hist_re/im and pre_re/im state)."""
    C, F, _ = pcm.shape
    kx, M = static.kx, static.M
    NS = F * 32
    dev = pcm.device
    k = _consts(static, dev)

    # ---- analysis QMF: shifted block slices + two float32 products ------
    x = torch.cat([state["ana_hist"], pcm.reshape(C, -1)], dim=1)
    blocks = x.reshape(C, NS + 10, 32)
    win = torch.cat([blocks[:, 1 + j:1 + j + NS] for j in range(10)],
                    dim=2)                                  # (C, NS, 320)
    Xre = torch.matmul(win, k["Kre"])
    Xim = torch.matmul(win, k["Kim"])

    # ---- 38-slot windows on the delayed-output timeline, 40-slot windows
    # with the transposer's 2-slot LPC prehistory
    Xre_ext = torch.cat([state["x_hist_re"], Xre], dim=1)   # (C, NS+6, 32)
    Xim_ext = torch.cat([state["x_hist_im"], Xim], dim=1)
    Pre_ext = torch.cat([state["pre_re"], Xre_ext], dim=1)  # (C, NS+8, 32)
    Pim_ext = torch.cat([state["pre_im"], Xim_ext], dim=1)
    base = torch.arange(F, device=dev)[:, None] * 32
    idx = base + torch.arange(NSL, device=dev)              # (F, 38)
    idx40 = base + torch.arange(NSL + 2, device=dev)        # (F, 40)
    Bre, Bim = Xre_ext[:, idx], Xim_ext[:, idx]             # (C, F, 38, 32)
    B40r, B40i = Pre_ext[:, idx40], Pim_ext[:, idx40]       # (C, F, 40, 32)
    new_state = {"ana_hist": x[:, -320:],
                 "x_hist_re": Xre_ext[:, -6:], "x_hist_im": Xim_ext[:, -6:],
                 "pre_re": Xre_ext[:, -8:-6], "pre_im": Xim_ext[:, -8:-6]}

    # ---- HF generator: covariances over the 40-slot windows -------------
    def phi(a_re, a_im, b_re, b_im):
        # sum over slots of a * conj(b), as two planes (C, F, 32)
        re = (a_re * b_re).sum(2) + (a_im * b_im).sum(2)
        im = (a_im * b_re).sum(2) - (a_re * b_im).sum(2)
        return re, im

    x0r, x0i = B40r[:, :, 2:], B40i[:, :, 2:]
    x1r, x1i = B40r[:, :, 1:-1], B40i[:, :, 1:-1]
    x2r, x2i = B40r[:, :, :-2], B40i[:, :, :-2]
    p01r, p01i = phi(x0r, x0i, x1r, x1i)
    p02r, p02i = phi(x0r, x0i, x2r, x2i)
    p11r, _ = phi(x1r, x1i, x1r, x1i)
    p12r, p12i = phi(x1r, x1i, x2r, x2i)
    p22r, _ = phi(x2r, x2i, x2r, x2i)
    d = p22r * p11r - (p12r ** 2 + p12i ** 2) / 1.000001
    d_ok = d.abs() > 1e-9
    safe_d = torch.where(d_ok, d, 1.0)
    a1r = torch.where(d_ok, (p01r * p12r - p01i * p12i - p02r * p11r)
                      / safe_d, 0.0)
    a1i = torch.where(d_ok, (p01i * p12r + p01r * p12i - p02i * p11r)
                      / safe_d, 0.0)
    p11_ok = p11r > 1e-9
    safe_p11 = torch.where(p11_ok, p11r, 1.0)
    a0r = torch.where(p11_ok, -(p01r + a1r * p12r + a1i * p12i) / safe_p11,
                      0.0)
    a0i = torch.where(p11_ok, -(p01i + a1i * p12r - a1r * p12i) / safe_p11,
                      0.0)
    big = (torch.sqrt(a0r ** 2 + a0i ** 2) >= 4.0) \
        | (torch.sqrt(a1r ** 2 + a1i ** 2) >= 4.0)
    a0r, a0i, a1r, a1i = (torch.where(big, 0.0, a)
                          for a in (a0r, a0i, a1r, a1i))

    # chirped 2nd-order patch of each patched band's source column; low
    # bands pass through, unpatched high bands are zero
    src = k["src"]
    bwk = cond["bwk"]                                       # (C, F, 64)
    sa0r = a0r[..., src] * bwk
    sa0i = a0i[..., src] * bwk
    sa1r = a1r[..., src] * bwk * bwk
    sa1i = a1i[..., src] * bwk * bwk
    xsr, xsi = B40r[..., src], B40i[..., src]               # (C, F, 40, 64)
    x0sr, x0si = xsr[:, :, 2:], xsi[:, :, 2:]
    x1sr, x1si = xsr[:, :, 1:-1], xsi[:, :, 1:-1]
    x2sr, x2si = xsr[:, :, :-2], xsi[:, :, :-2]
    c0r, c0i = sa0r[:, :, None], sa0i[:, :, None]
    c1r, c1i = sa1r[:, :, None], sa1i[:, :, None]
    hfr = x0sr + (c0r * x1sr - c0i * x1si) + (c1r * x2sr - c1i * x2si)
    hfi = x0si + (c0r * x1si + c0i * x1sr) + (c1r * x2si + c1i * x2sr)
    low_r = torch.nn.functional.pad(Bre, (0, 32))
    low_i = torch.nn.functional.pad(Bim, (0, 32))
    Er = torch.where(k["is_patch"], hfr, low_r)[..., kx:kx + M]
    Ei = torch.where(k["is_patch"], hfi, low_i)[..., kx:kx + M]

    # ---- the compact cond wire expanded to per-bin planes ---------------
    mapL, mapH, mapN = k["map_low"], k["map_high"], k["map_noise"]
    fres = cond["fres"][..., None]                          # (C, F, E, 1)
    Erow = cond["Erow"]
    Emap = (torch.matmul(Erow, mapL) * (1.0 - fres)
            + torch.matmul(Erow, mapH) * fres)
    Qmap = torch.matmul(cond["Qrow"], mapN)
    sine_bins = cond["sine"].to(torch.float32)              # (C, F, E, M)

    def sine_in_band(mp):
        hasb = (torch.matmul(sine_bins, mp.T) > 0).to(torch.float32)
        return (torch.matmul(hasb, mp) > 0).to(torch.float32)

    sine_band = torch.where(fres > 0, sine_in_band(mapH),
                            sine_in_band(mapL))
    env_id = cond["env_id"]                                 # (C, F, 38) int8
    # slot -> envelope one-hot; env_id -1 gives an all-zero row
    A = _onehot(env_id)

    # ---- envelope adjustment --------------------------------------------
    Eslot = Er * Er + Ei * Ei                               # (C, F, 38, M)
    At = A.transpose(-1, -2)                                # (C, F, E, 38)
    counts = A.sum(2).clamp_min(1.0)                        # (C, F, E)
    Ecurr = torch.matmul(At, Eslot) / counts[..., None]
    if not static.interpol_freq:
        def band_avg(mp):
            bsum = torch.matmul(Ecurr, mp.T)
            bcnt = mp.sum(1).clamp_min(1.0)
            ea = torch.matmul(bsum / bcnt, mp)
            return torch.where(mp.sum(0) > 0, ea, Ecurr)

        Ecurr = torch.where(fres > 0, band_avg(mapH), band_avg(mapL))
    qfac = Qmap / (1.0 + Qmap)
    Ecs = Ecurr.clamp_min(1e-12)
    nn = cond["no_noise"][..., None]                        # (C, F, E, 1)
    gain = torch.where(sine_band > 0, torch.sqrt(Emap * qfac / Ecs),
                       torch.sqrt(Emap / (torch.where(nn > 0, 1.0, 1.0 + Qmap)
                                          * Ecs)))
    noise_lvl = torch.sqrt(Emap * qfac)
    sine_lvl = torch.where(sine_bins > 0, torch.sqrt(Emap / (1.0 + Qmap)),
                           0.0)
    L = k["limiter"]                                        # (nlim, M)
    covered = L.sum(0) > 0
    Esum = torch.matmul(Emap, L.T)
    Csum = torch.matmul(Ecurr, L.T)
    gmax_l = torch.clamp_max(
        static.limgain * torch.sqrt((Esum + 1e-12) / (Csum + 1e-12)), 1e10)
    gmax = torch.where(covered, torch.matmul(gmax_l, L), 1e10)
    ratio = torch.clamp_max(gmax / gain.clamp_min(1e-12), 1.0)
    noise_lvl = noise_lvl * ratio
    gain = torch.minimum(gain, gmax)
    achieved_m = (Ecurr * gain ** 2
                  + torch.where(sine_lvl > 0, 0.0, noise_lvl ** 2) * (1.0 - nn)
                  + sine_lvl ** 2)
    ach_l = torch.matmul(achieved_m, L.T)
    boost_l = torch.clamp_max(
        torch.sqrt(Esum / ach_l.clamp_min(1e-12)), 1.584893192)
    boost = torch.where(covered, torch.matmul(boost_l, L), 1.0)
    gain = gain * boost
    noise_lvl = noise_lvl * boost
    sine_lvl = sine_lvl * boost

    # ---- the counters of the noise and sine planes, which the frame scan
    # regenerates (noise_sine_planes)
    last = cond["last_env"]                                 # (C, F, E) 0/1
    last_id = torch.where(last.sum(-1) > 0, last.argmax(-1), -1) \
        .to(torch.int8)
    args = (gain, noise_lvl, sine_lvl, sine_bins, env_id,
            cond["prev_id"], last_id, cond["r"], cond["carry_mask"],
            slot_order(env_id), cond["noise_idx0"][:, 0].to(torch.int32),
            cond["sine_ph0"][:, 0].to(torch.int32),
            cond["no_noise"].contiguous(), k["noise_re"], k["noise_im"],
            k["parity"], float(static.inject_cal), Er.contiguous(),
            Ei.contiguous(),
            *(state[k].contiguous() for k in ("filt", "tail_r", "tail_i")))
    return args, (Xre_ext, Xim_ext), new_state


def device_decode_group(static: SbrStatic, pcm, cond: dict, state: dict):
    """SBR group decode of C channels at once (``sbr_jax.
    device_decode_group`` under ``jax.vmap``).

    pcm (C, F, 1024) float32 core samples; cond: the (C, ...) cond planes
    (:func:`cond_to_device`); state: (C, ...) state tensors
    (:func:`state_to_device`).  Returns (out (C, F*2048) float32,
    new_state)."""
    C, F, _ = pcm.shape
    kx, M = static.kx, static.M
    NS = F * 32
    args, (Xre_ext, Xim_ext), new_state = envelope_inputs(static, pcm, cond,
                                                          state)
    Or, Oi, filt, tail_r, tail_i = envelope_scan(*args)

    # ---- synthesis QMF over the frame-output slots -----------------------
    hi = pcm.new_zeros((C, NS, 64 - kx - M))
    Zr = torch.cat([Xre_ext[:, :NS, :kx], Or.reshape(C, NS, M), hi], dim=2)
    Zi = torch.cat([Xim_ext[:, :NS, :kx], Oi.reshape(C, NS, M), hi], dim=2)
    out, new_syn = synthesize_slots(static, Zr, Zi, state["syn_state"])
    new_state.update(tail_r=tail_r, tail_i=tail_i, syn_state=new_syn,
                     filt=filt)
    return out, new_state


def synthesize_slots(static: SbrStatic, Zr, Zi, syn_state):
    """64-band synthesis QMF for a run of slots: one product and 12 shifted
    adds of the 768-sample per-slot responses.  Zr, Zi (..., NS, 64);
    syn_state (..., 704).  Returns (out (..., NS*64), new syn_state)."""
    k = _consts(static, Zr.device)
    lead, NS = Zr.shape[:-2], Zr.shape[-2]
    contrib = torch.matmul(Zr, k["syn_re"]) + torch.matmul(Zi, k["syn_im"])
    z12 = contrib.reshape(*lead, NS, 12, 64)
    acc = contrib.new_zeros((*lead, NS + 12, 64))
    for j in range(12):
        acc[..., j:j + NS, :] += z12[..., j, :]
    flat = acc.reshape(*lead, (NS + 12) * 64)
    out = torch.cat([flat[..., :704] + syn_state,
                     flat[..., 704:NS * 64 + 704]], dim=-1)
    return out[..., :NS * 64], out[..., NS * 64:]


class SbrDeviceRunner:
    """The zigzag-wire multi-stream runner of ``sbr_jax.SbrDeviceRunner``:
    the AAC-LC core and the SBR group of ``nch`` channels (every stream's,
    side by side) in one pass on ``device``.  Parsing, dequantisation and
    the cond build stay on the host."""

    def __init__(self, dec: SBR.SbrDecoder, nch: int = 2, *, device):
        self.dec = dec
        self.static = SbrStatic(dec)
        self.device = torch.device(device)
        self.state_host = [SBR.SbrChannelState() for _ in range(nch)]
        self.first = [True] * nch
        self._stacked = state_to_device(
            [device_init_state(self.static.M) for _ in range(nch)],
            self.device)
        self._core_ov = torch.zeros((nch, 1024), dtype=torch.float32,
                                    device=self.device)

    def _build_stacked_cond(self, nch: int, F: int, per_ch: list) -> dict:
        """Every channel's cond filled straight into (C, ...) stacked numpy
        arrays; per_ch[c] = (datas, Es, Qs), empty for a dead channel,
        whose frames then stay inactive."""
        proto = vars(SbrFrameCond(F, self.static))
        # the prototype's defaults: env_id/prev_id -1 means unassigned
        stacked = {k: np.broadcast_to(v, (nch,) + v.shape).copy()
                   for k, v in proto.items()}
        for ch in range(nch):
            view = SbrFrameCond.__new__(SbrFrameCond)
            for k in proto:
                setattr(view, k, stacked[k][ch])
            datas, Es, Qs = per_ch[ch]
            build_frame_cond(self.dec, self.state_host[ch], self.static,
                             datas, Es, Qs, self.first[ch], cond=view)
            self.first[ch] = False
        return stacked

    def decode_group_multi_zz(self, planes: dict, per_ch: list, consts):
        """One group: ``planes`` the LC core's zigzag wire as tensors on the
        device (``synthesis.decode_planes``' keys), ``per_ch`` the SBR
        frames per channel, ``consts`` ``synthesis.device_constants``.
        Returns the (C, F*2048) int16 PCM on the device, rounded half to
        even and clipped; nothing is copied back."""
        F = planes["q4"].shape[0]
        cond = cond_to_device(self._build_stacked_cond(len(per_ch), F,
                                                       per_ch), self.device)
        pcm, self._core_ov = SYN.decode_planes(planes, self._core_ov, consts)
        out, self._stacked = device_decode_group(
            self.static, pcm.transpose(0, 1), cond, self._stacked)
        return torch.round(out).clamp_(-32768, 32767).to(torch.int16)
