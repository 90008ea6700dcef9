"""HE-AAC (v1 SBR and v2 parametric stereo) reconstruction for groups of
frames, on tensors.

Port of the device half of ``ohpipeline_tpu.codecs.aac.sbr_jax``.  Its host
half (``SbrStatic``, ``SbrFrameCond``, ``device_init_state`` and the cond
builder ``build_frame_cond``, which advances the per-channel counters of the
numpy chain in ``sbr.py``; ``PsStatic``, ``ps_init_state`` and
``build_ps_H_slots``) is the port's copy ``host/codecs/aac/sbr_host.py``,
reached through ``_host``.  The numpy cond planes and state dicts cross to
the device through :func:`cond_to_device`, :func:`state_to_device` and
:func:`ps_state_to_device`.

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

:class:`SbrDeviceRunner` runs the AAC-LC core and the SBR group of several
channels in one pass, with the SBR state and the core overlap kept on the
device across groups: on the zigzag wire of the serving path
(``synthesis.decode_chunk_zz``), and in spec mode, from prepared spectra
through :func:`core_imdct_device`, for the codec plug-in.  The JAX runner's
per-channel and PCM-mode methods are not ported.

HE-AAC v2 (parametric stereo): :func:`device_decode_qmf` hands the adjusted
QMF slots of the mono core to :func:`ps_decorrelate_mix`: the hybrid
analysis (:func:`ps_hybrid_analysis`, 13-tap FIRs as ``torch.matmul``), the
decorrelator and mixer scan over the group's slots (:func:`ps_scan`: the
hand-written kernel ``csrc/ps_mix.cu`` on CUDA tensors, its plain version
:func:`ps_scan_torch` on CPU tensors) and the hybrid synthesis; two
synthesis QMFs follow (:func:`device_decode_group_ps`).
:class:`SbrPsDeviceRunner` drives it group by group.
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


def device_decode_qmf(static: SbrStatic, pcm, cond: dict, state: dict):
    """:func:`device_decode_group` up to the synthesis QMF (``sbr_jax.
    device_decode_group`` with ``ps_extras``): returns ((Zr, Zi) the (C,
    F*32, 64) adjusted QMF slots, new_state), with ``syn_state`` passed
    through unchanged, so that the caller (the parametric-stereo stage) owns
    the synthesis states."""
    C, F, _ = pcm.shape
    kx, M = static.kx, static.M
    NS = F * 32
    args, (Xre_ext, Xim_ext), new_state = envelope_inputs(static, pcm, cond,
                                                          state)
    Or, Oi, filt, tail_r, tail_i = envelope_scan(*args)
    hi = pcm.new_zeros((C, NS, 64 - kx - M))
    Zr = torch.cat([Xre_ext[:, :NS, :kx], Or.reshape(C, NS, M), hi], dim=2)
    Zi = torch.cat([Xim_ext[:, :NS, :kx], Oi.reshape(C, NS, M), hi], dim=2)
    new_state.update(tail_r=tail_r, tail_i=tail_i,
                     syn_state=state["syn_state"], filt=filt)
    return (Zr, Zi), new_state


def device_decode_group(static: SbrStatic, pcm, cond: dict, state: dict):
    """SBR group decode of C channels at once (``sbr_jax.
    device_decode_group`` under ``jax.vmap``).

    pcm (C, F, 1024) float32 core samples; cond: the (C, ...) cond planes
    (:func:`cond_to_device`); state: (C, ...) state tensors
    (:func:`state_to_device`).  Returns (out (C, F*2048) float32,
    new_state)."""
    (Zr, Zi), new_state = device_decode_qmf(static, pcm, cond, state)
    out, new_state["syn_state"] = synthesize_slots(static, Zr, Zi,
                                                   state["syn_state"])
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


_CORE_CONSTS: dict = {}


def core_imdct_device(specs, opidx, core_ov):
    """The LC core filterbank of a channel on its tensors' device
    (``sbr_jax.core_imdct_device``, with any leading channel axes): specs
    (..., F, 1024) float32 prepared spectra, opidx (..., F) int operator
    indices, core_ov (..., 1024) float32 overlap tail.  The IMDCT is one
    ``torch.matmul`` per window length, each row takes its window, and the
    overlap-add is a shift (frame f needs only frame f-1's tail).  Returns
    (pcm (..., F, 1024), new_ov (..., 1024))."""
    key = str(specs.device)
    if key not in _CORE_CONSTS:
        _CORE_CONSTS[key] = SYN.filterbank_constants(device=specs.device)
    lead, F = specs.shape[:-2], specs.shape[-2]
    x = SYN._imdct_windowed(specs.reshape(-1, 1024), opidx.reshape(-1).long(),
                            *_CORE_CONSTS[key], split=False)
    x = x.reshape(*lead, F, 2048)
    prev = torch.cat([core_ov[..., None, :], x[..., :-1, 1024:]], dim=-2)
    return x[..., :1024] + prev, x[..., -1, 1024:]


def _pcm16(out):
    """Float PCM -> int16 on its device, rounded half to even and clipped."""
    return torch.round(out).clamp_(-32768, 32767).to(torch.int16)


class SbrDeviceRunner:
    """The multi-channel runner of ``sbr_jax.SbrDeviceRunner``: the AAC-LC
    core and the SBR group of ``nch`` channels side by side in one pass on
    ``device``, with the SBR state and the core overlap kept there across
    groups.  Three wires: the zigzag wire of the serving path
    (:meth:`decode_group_multi_zz`), the prepared spectra of the codec
    plug-ins (:meth:`decode_group_multi_lazy_spec`) and the core PCM
    (:meth:`decode_group` for one channel, :meth:`decode_group_multi` for
    all).  Channel ``ch``'s SBR state is row ``ch`` of the runner's state
    on every wire.  Parsing, dequantisation and the cond build stay on the
    host."""

    def __init__(self, dec: SBR.SbrDecoder, nch: int = 2, *, device="cuda"):
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
        # spec mode: True while the host holds the live core overlap (before
        # the first spec group, and after fetch_core_overlap handed it back)
        self._host_ov = True

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

    def decode_group(self, ch: int, pcm_frames: np.ndarray, datas: list,
                     Es: list, Qs: list) -> np.ndarray:
        """Channel ``ch``'s group from its core PCM: pcm_frames (F, 1024),
        datas/Es/Qs per frame.  Returns (F*2048,) float32 at the doubled
        rate, unrounded."""
        cond = build_frame_cond(self.dec, self.state_host[ch], self.static,
                                datas, Es, Qs, self.first[ch])
        self.first[ch] = False
        cond = cond_to_device({k: v[None] for k, v in vars(cond).items()},
                              self.device)
        pcm = torch.from_numpy(np.asarray(pcm_frames, np.float32))
        state = {k: v[ch:ch + 1] for k, v in self._stacked.items()}
        out, state = device_decode_group(self.static, pcm[None].to(
            self.device), cond, state)
        self._stacked = {k: torch.cat([v[:ch], state[k], v[ch + 1:]])
                         for k, v in self._stacked.items()}
        return out[0].cpu().numpy()

    def decode_group_multi_lazy(self, pcm_frames: np.ndarray, per_ch: list):
        """Every channel's group in one pass from the core PCM: pcm_frames
        (C, F, 1024) for the runner's C channels, per_ch[c] = (datas, Es,
        Qs).  The group is queued on the device; returns a zero-argument
        function that copies the (C, F*2048) PCM back as int32, rounded half
        to even and clipped."""
        nch, F = pcm_frames.shape[:2]
        cond = cond_to_device(self._build_stacked_cond(nch, F, per_ch),
                              self.device)
        pcm = torch.from_numpy(np.asarray(pcm_frames, np.float32))
        out, self._stacked = device_decode_group(
            self.static, pcm.to(self.device), cond, self._stacked)
        pcm16 = _pcm16(out)
        return lambda: pcm16.cpu().numpy().astype(np.int32)

    def decode_group_multi(self, pcm_frames: np.ndarray,
                           per_ch: list) -> np.ndarray:
        """:meth:`decode_group_multi_lazy`, copied back at once."""
        return self.decode_group_multi_lazy(pcm_frames, per_ch)()

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
        return _pcm16(out)

    def decode_group_multi_lazy_spec(self, specs: np.ndarray, ops: np.ndarray,
                                     per_ch: list, host_overlap: np.ndarray):
        """One group with the LC core fused on the device: specs (C, F,
        1024) float32 prepared spectra, ops (C, F) operator indices,
        per_ch[c] = (datas, Es, Qs).  ``host_overlap`` (C, 1024) seeds the
        core overlap on the first spec group and after
        :meth:`fetch_core_overlap`.  The group is queued on the device;
        returns a zero-argument function that copies the (C, F*2048) PCM
        back as int32."""
        nch, F = specs.shape[:2]
        cond = cond_to_device(self._build_stacked_cond(nch, F, per_ch),
                              self.device)
        if self._host_ov:
            self._core_ov = torch.from_numpy(
                np.asarray(host_overlap[:nch], np.float32)).to(self.device)
        spec_t = torch.from_numpy(np.asarray(specs, np.float32))
        op_t = torch.from_numpy(np.asarray(ops, np.int64))
        pcm, self._core_ov = core_imdct_device(
            spec_t.to(self.device), op_t.to(self.device), self._core_ov)
        self._host_ov = False
        out, self._stacked = device_decode_group(self.static, pcm, cond,
                                                 self._stacked)
        pcm16 = _pcm16(out)
        return lambda: pcm16.cpu().numpy().astype(np.int32)

    def fetch_core_overlap(self):
        """The (C, 1024) core overlap after the last spec group, as numpy,
        handed back to the host (None when the host already holds it): the
        caller installs it before a group of the numpy chain, and the next
        spec group seeds from the host again."""
        if self._host_ov:
            return None
        self._host_ov = True
        return self._core_ov.cpu().numpy()


# ---------------------------------------------------------------------------
# Parametric stereo (HE-AAC v2): hybrid analysis, the decorrelator and mixer
# scan, hybrid synthesis
# ---------------------------------------------------------------------------

PsStatic = SJ.PsStatic
ps_init_state = SJ.ps_init_state
build_ps_H_slots = SJ.build_ps_H_slots

#: Channels of a PS slot (12 hybrid subbands, then QMF bands 3-63), the first
#: PS_AP of them with the all-pass chain (the subbands and QMF bands 3-22),
#: the rest (QMF bands 23-63) with plain delays; power groups and mixing
#: groups; the widest power group; the all-pass ring depths and the depth of
#: the long-delay ring.  Fixed in ``csrc/ps_mix.cu``.
PS_CH, PS_AP, PS_GROUPS, PS_MIX, PS_MAXMEM = 73, 32, 20, 22, 29
PS_LONG = PS_CH - PS_AP
PS_LINKS, PS_LNG = (3, 4, 5), 14
#: One stream's scan carry, as the kernel lays it out (name, shape): the
#: three power states, the 2-slot delay, the three all-pass rings and the
#: long delays, each ring oldest slot first.
PS_CARRY = (("pow", (3, PS_GROUPS)),
            ("d2_re", (2, PS_AP)), ("d2_im", (2, PS_AP)),
            *((f"r{d}_{p}", (PS_AP, d)) for d in PS_LINKS
              for p in ("re", "im")),
            ("lng_re", (PS_LONG, PS_LNG)), ("lng_im", (PS_LONG, PS_LNG)))
#: The scan's float32 coefficients: the fractional-delay phase and the
#: all-pass links' phases per all-pass channel, the decay ramp (1 on the
#: subbands), the links' decays, the peak decay / smoothing / transient
#: impact constants and the mixing mask per channel.
PS_COEF = (("phi_re", (PS_AP,)), ("phi_im", (PS_AP,)),
           ("ser_re", (PS_AP, 3)), ("ser_im", (PS_AP, 3)),
           ("dsf", (PS_AP,)), ("dser", (3,)), ("pk_ic_ti", (3,)),
           ("cmask", (PS_CH,)))
#: The scan's int32 tables: each power group's channels in increasing order
#: (-1 pads), their count, and per channel its transient group, its mixing
#: group and, for the long channels, the read offset in the delay ring.
PS_IMAP = (("members", (PS_GROUPS, PS_MAXMEM)), ("nmem", (PS_GROUPS,)),
           ("tgrp", (PS_CH,)), ("mgrp", (PS_CH,)), ("loff", (PS_LONG,)))


def _size(layout) -> int:
    return sum(int(np.prod(shape)) for _, shape in layout)


def _split(flat, layout) -> dict:
    """Views of the last axis of ``flat`` (tensor or array) per (name,
    shape) of ``layout``."""
    out, o = {}, 0
    for name, shape in layout:
        n = int(np.prod(shape))
        out[name] = flat[..., o:o + n].reshape(*flat.shape[:-1], *shape)
        o += n
    return out


_PS_CONSTS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def ps_constants(ps: PsStatic, device) -> dict:
    """``ps``'s constants as tensors on ``device``, made once: the hybrid
    analysis FIRs (H8 re / im (13, 8), H2 (13, 2)) and the scan's packed
    tables ``coef`` (float32, :data:`PS_COEF`) and ``imap`` (int32,
    :data:`PS_IMAP`)."""
    per = _PS_CONSTS.setdefault(ps, {})
    key = str(torch.device(device))
    if key not in per:
        members = np.full((PS_GROUPS, PS_MAXMEM), -1, np.int32)
        for g in range(PS_GROUPS):
            chans = [*np.nonzero(ps.Psub[g])[0],
                     *(12 + np.nonzero(ps.Pqmf[g])[0])]
            members[g, :len(chans)] = chans
        f32 = np.float32
        coef = dict(
            phi_re=np.concatenate([ps.phi_sub.real, ps.phi_qmf.real]),
            phi_im=np.concatenate([ps.phi_sub.imag, ps.phi_qmf.imag]),
            ser_re=np.concatenate([ps.phi_ser_sub.real, ps.phi_ser_qmf.real]),
            ser_im=np.concatenate([ps.phi_ser_sub.imag, ps.phi_ser_qmf.imag]),
            dsf=np.concatenate([np.ones(12), ps.decay_scale]),
            dser=ps.decay_ser,
            pk_ic_ti=[f32(SBR._PS_PEAK_DECAY), f32(SBR._PS_INT_COEFF),
                      f32(SBR._PS_TRANS_IMPACT)],
            cmask=ps.chan_mask)
        imap = dict(members=members, nmem=(members >= 0).sum(1),
                    tgrp=ps.trans_bin[ps.chan_group], mgrp=ps.chan_group,
                    loff=ps.long_read_off)

        def pack(parts, layout, dtype):
            return torch.from_numpy(np.concatenate(
                [np.asarray(parts[n]).astype(dtype).reshape(-1)
                 for n, _ in layout])).to(device)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        per[key] = dict(H8r=t(ps.H8.real), H8i=t(ps.H8.imag),
                        H2=t(ps.H2.real), coef=pack(coef, PS_COEF, f32),
                        imap=pack(imap, PS_IMAP, np.int32))
    return per[key]


def _carry_parts(s: dict) -> dict:
    """One stream's PS state (``ps_init_state``'s 25 arrays) -> the
    :data:`PS_CARRY` parts, float32 numpy."""
    def f(k):
        return np.asarray(s[k], np.float32)

    parts = {"pow": np.stack([f("pd"), f("ppd"), f("pnrg")])}
    for p in ("re", "im"):
        parts[f"d2_{p}"] = np.concatenate([f(f"d2s_{p}"), f(f"d2q_{p}")], 1)
        for d in PS_LINKS:
            parts[f"r{d}_{p}"] = np.concatenate([f(f"s{d}s_{p}"),
                                                 f(f"s{d}q_{p}")])
        parts[f"lng_{p}"] = f(f"lng_{p}")
    return parts


def ps_state_to_device(states: list, device) -> dict:
    """Per-stream PS states (``ps_init_state``'s 25 arrays, numpy or any
    array the JAX runner holds) -> the (C, ...) stacked state of
    :func:`ps_decorrelate_mix` on ``device``: ``carry`` (C, PS_CARRY's
    size) and the hybrid analysis' ``hyb_hist_re / _im`` (C, 12, 3) and
    ``dline_re / _im`` (C, 6, 61)."""
    def stack(rows):
        return torch.from_numpy(np.stack(rows).astype(np.float32)).to(device)

    out = {"carry": stack([np.concatenate([_carry_parts(s)[n].reshape(-1)
                                           for n, _ in PS_CARRY])
                           for s in states])}
    for k in ("hyb_hist_re", "hyb_hist_im", "dline_re", "dline_im"):
        out[k] = stack([np.asarray(s[k]) for s in states])
    return out


def ps_state_to_host(state: dict) -> list:
    """:func:`ps_state_to_device`'s inverse: [per-stream dict of the 25
    ``ps_init_state`` arrays, float32 numpy]."""
    carry = state["carry"].cpu().numpy()
    rest = {k: state[k].cpu().numpy() for k in
            ("hyb_hist_re", "hyb_hist_im", "dline_re", "dline_im")}
    out = []
    for c in range(carry.shape[0]):
        v = _split(carry[c], PS_CARRY)
        s = {"pd": v["pow"][0], "ppd": v["pow"][1], "pnrg": v["pow"][2]}
        for p in ("re", "im"):
            s[f"d2s_{p}"], s[f"d2q_{p}"] = v[f"d2_{p}"][:, :12], \
                v[f"d2_{p}"][:, 12:]
            for d in PS_LINKS:
                s[f"s{d}s_{p}"], s[f"s{d}q_{p}"] = v[f"r{d}_{p}"][:12], \
                    v[f"r{d}_{p}"][12:]
            s[f"lng_{p}"] = v[f"lng_{p}"]
        s.update({k: a[c] for k, a in rest.items()})
        out.append({k: np.array(a) for k, a in s.items()})
    return out


def ps_hybrid_analysis(k: dict, Zr, Zi, state: dict):
    """The PS hybrid analysis of C streams (``ps_decorrelate_mix``'s
    13-tap FIRs over the slots, as ``torch.matmul``): Zr, Zi (C, S, 64) mid
    QMF slots, ``k`` :func:`ps_constants`, ``state`` carrying the 12-slot
    history of QMF bands 0-2 and the 6-slot delay of bands 3-63.  Returns
    (mid_r, mid_i (C, S, 73): 12 hybrid subbands, then QMF bands 3-63
    delayed by 6 slots; the new hyb_hist_re / _im and dline_re / _im)."""
    S = Zr.shape[1]
    low_r = torch.cat([state["hyb_hist_re"], Zr[..., :3]], dim=1)
    low_i = torch.cat([state["hyb_hist_im"], Zi[..., :3]], dim=1)
    win_r = torch.stack([low_r[:, s:s + S] for s in range(13)], dim=2)
    win_i = torch.stack([low_i[:, s:s + S] for s in range(13)], dim=2)
    a_r, a_i = win_r[..., 0], win_i[..., 0]                 # (C, S, 13)
    mm = torch.matmul
    hyb_r = torch.cat([mm(a_r, k["H8r"]) - mm(a_i, k["H8i"]),
                       mm(win_r[..., 1], k["H2"]), mm(win_r[..., 2], k["H2"])],
                      dim=-1)
    hyb_i = torch.cat([mm(a_r, k["H8i"]) + mm(a_i, k["H8r"]),
                       mm(win_i[..., 1], k["H2"]), mm(win_i[..., 2], k["H2"])],
                      dim=-1)
    # subbands 4 and 5 fold into 3 and 2, then are zeroed
    for h in (hyb_r, hyb_i):
        h[..., 3] += h[..., 4]
        h[..., 2] += h[..., 5]
        h[..., 4:6] *= 0.0
    rest_r = torch.cat([state["dline_re"], Zr[..., 3:]], dim=1)
    rest_i = torch.cat([state["dline_im"], Zi[..., 3:]], dim=1)
    mid_r = torch.cat([hyb_r, rest_r[:, :S]], dim=2)
    mid_i = torch.cat([hyb_i, rest_i[:, :S]], dim=2)
    return (mid_r, mid_i, low_r[:, S:S + 12], low_i[:, S:S + 12],
            rest_r[:, S:S + 6], rest_i[:, S:S + 6])


def ps_hybrid_synthesis(cr, ci):
    """(C, S, 73) hybrid-domain slots -> (C, S, 64) QMF slots: the
    subbands of QMF bands 0, 1 and 2 (8, 2 and 2 of them) summed."""
    def syn(x):
        return torch.cat([x[..., 0:8].sum(-1, keepdim=True),
                          x[..., 8:10].sum(-1, keepdim=True),
                          x[..., 10:12].sum(-1, keepdim=True), x[..., 12:]],
                         dim=-1)

    return syn(cr), syn(ci)


def ps_transients(mr, mi, pw, coef, imap):
    """The transient factors of :func:`ps_scan_torch`: mr, mi (C, S, 73)
    mid slots, pw (C, 3, 20) the carried peak decay, smoothed peak
    difference and smoothed energy.  Per slot the 20 group powers, each a
    sum of |x|^2 over its members in channel order, drive the three
    recurrences.  Returns (trans (C, S, 20), the new pw)."""
    S = mr.shape[1]
    k = _split(coef, PS_COEF)
    members = _split(imap, PS_IMAP)["members"].long()
    pk, ic, ti = k["pk_ic_ti"]
    e = mr * mr + mi * mi
    p = e.new_zeros((*mr.shape[:2], PS_GROUPS))
    for j in range(PS_MAXMEM):
        col = members[:, j]
        p = p + torch.where(col >= 0, e[..., col.clamp_min(0)], 0.0)
    pd, ppd, pnrg = pw.unbind(1)
    trans = []
    for t in range(S):
        pt = p[:, t]
        pd = torch.maximum(pd * pk, pt)
        ppd = ppd + ic * (pd - pt - ppd)
        pnrg = torch.clamp_min(pnrg + ic * (pt - pnrg), 0.0)
        nrg = pnrg * ti
        trans.append(torch.where(ppd <= nrg, 1.0,
                                 nrg / torch.clamp_min(ppd, 1e-30)))
    return torch.stack(trans, 1), torch.stack([pd, ppd, pnrg], 1)


def ps_scan_torch(mr, mi, H, carry, coef, imap):
    """Plain version of the decorrelator and mixer scan (the step and scan of
    ``sbr_jax.ps_decorrelate_mix``), in the kernel's order of operations.

    mr, mi (C, S, 73) float32 mid slots (:func:`ps_hybrid_analysis`); H (C,
    S, 4, 22) float32 mixing matrices per slot (h11, h12, h21, h22 per
    mixing group); carry (C, n) float32 (:data:`PS_CARRY`); coef and imap
    the packed tables of :func:`ps_constants`.  Per slot: the transient
    factor per group (:func:`ps_transients`); per all-pass channel the
    2-slot delay times
    its phase, then three serial all-pass links over rings of 3, 4 and 5
    slots (with the decay ramp, 1 on the subbands); per long channel its
    delay read from the 14-deep ring; the decorrelated value times its
    transient factor; the 2x2 mix with the slot's H by mixing group, masked.
    The powers and transient factors depend only on the input, so they are
    computed first; then a loop over slots, vectorised over streams and
    channels.  Returns (Lr, Li, Rr, Ri (C, S, 73), new carry)."""
    C, S, _ = mr.shape
    k = _split(coef, PS_COEF)
    ix = {n: v.long() for n, v in _split(imap, PS_IMAP).items()}
    st = _split(carry, PS_CARRY)
    trans, pw = ps_transients(mr, mi, st["pow"], coef, imap)
    tch = trans[..., ix["tgrp"]]                            # (C, S, 73)
    hch = H[..., ix["mgrp"]]                                # (C, S, 4, 73)
    phr, phi, dsf, dser = k["phi_re"], k["phi_im"], k["dsf"], k["dser"]
    serr, seri, cm = k["ser_re"], k["ser_im"], k["cmask"]
    d2r, d2i = st["d2_re"], st["d2_im"]
    rings = [[st[f"r{d}_re"], st[f"r{d}_im"]] for d in PS_LINKS]
    lr, li = st["lng_re"], st["lng_im"]
    loff = ix["loff"][None, :, None].expand(C, -1, 1)
    outs = []
    for t in range(S):
        xr, xi = mr[:, t], mi[:, t]
        ar, ai = d2r[:, 0], d2i[:, 0]
        r0r, r0i = ar * phr - ai * phi, ar * phi + ai * phr
        d2r = torch.stack([d2r[:, 1], xr[:, :PS_AP]], 1)
        d2i = torch.stack([d2i[:, 1], xi[:, :PS_AP]], 1)
        res_r, res_i = dsf * r0r, dsf * r0i
        for m, ring in enumerate(rings):
            sr, si = ring[0][..., 0], ring[1][..., 0]
            tr = sr * serr[:, m] - si * seri[:, m]
            tq = sr * seri[:, m] + si * serr[:, m]
            tr = tr - dser[m] * res_r
            tq = tq - dser[m] * res_i
            res_r, res_i = dsf * tr, dsf * tq
            ring[0] = torch.cat([ring[0][..., 1:],
                                 (r0r + dser[m] * res_r)[..., None]], -1)
            ring[1] = torch.cat([ring[1][..., 1:],
                                 (r0i + dser[m] * res_i)[..., None]], -1)
            r0r, r0i = tr, tq
        dl_r = torch.gather(lr, 2, loff)[..., 0]
        dl_i = torch.gather(li, 2, loff)[..., 0]
        lr = torch.cat([lr[..., 1:], xr[:, PS_AP:, None]], -1)
        li = torch.cat([li[..., 1:], xi[:, PS_AP:, None]], -1)
        dr = torch.cat([r0r, dl_r], 1) * tch[:, t]
        di = torch.cat([r0i, dl_i], 1) * tch[:, t]
        h11, h12, h21, h22 = hch[:, t].unbind(1)
        outs.append(torch.stack([(h11 * xr + h21 * dr) * cm,
                                 (h11 * xi + h21 * di) * cm,
                                 (h12 * xr + h22 * dr) * cm,
                                 (h12 * xi + h22 * di) * cm]))
    Lr, Li, Rr, Ri = torch.stack(outs, 2).unbind(0)
    parts = dict(pow=pw, d2_re=d2r, d2_im=d2i, lng_re=lr, lng_im=li)
    for d, (re, im) in zip(PS_LINKS, rings):
        parts[f"r{d}_re"], parts[f"r{d}_im"] = re, im
    new_carry = torch.cat([parts[n].reshape(C, -1) for n, _ in PS_CARRY], 1)
    return Lr, Li, Rr, Ri, new_carry


def ps_scan(mr, mi, H, carry, coef, imap):
    """The decorrelator and mixer scan (see :func:`ps_scan_torch`): the
    ``csrc/ps_mix.cu`` kernel for CUDA tensors, the plain version for CPU
    tensors."""
    dev = mr.device
    if dev.type == "cuda":
        return _kernels.ps_mix(mr, mi, H, carry, coef, imap)
    if dev.type == "cpu":
        return ps_scan_torch(mr, mi, H, carry, coef, imap)
    raise ValueError(f"ps_scan: no kernel for device {dev}")


def ps_decorrelate_mix(ps: PsStatic, Zr, Zi, H_slots, state: dict):
    """The PS stage of C streams (``sbr_jax.ps_decorrelate_mix``): Zr, Zi
    (C, S, 64) mid QMF slots, H_slots (C, S, 4, 22) float32 per-slot mixing
    matrices (``build_ps_H_slots``), ``state`` from
    :func:`ps_state_to_device`.  Returns (XLr, XLi, XRr, XRi (C, S, 64),
    new_state)."""
    k = ps_constants(ps, Zr.device)
    mid_r, mid_i, hr, hi, dr, di = ps_hybrid_analysis(k, Zr, Zi, state)
    Lr, Li, Rr, Ri, carry = ps_scan(mid_r.contiguous(), mid_i.contiguous(),
                                    H_slots.contiguous(), state["carry"],
                                    k["coef"], k["imap"])
    return (*ps_hybrid_synthesis(Lr, Li), *ps_hybrid_synthesis(Rr, Ri),
            {"carry": carry, "hyb_hist_re": hr, "hyb_hist_im": hi,
             "dline_re": dr, "dline_im": di})


def device_decode_group_ps(static: SbrStatic, ps: PsStatic, pcm, cond: dict,
                           state: dict, ps_state: dict, syn_state_r, H_slots):
    """HE-AAC v2 group decode of C mono cores (``sbr_jax.
    device_decode_group_ps``): the SBR reconstruction, the PS stage and two
    synthesis QMFs (the left one on ``state``'s syn_state).  pcm (C, F,
    1024); syn_state_r (C, 704) the right synthesis tail; H_slots (C, F*32,
    4, 22).  Returns (out (C, 2, F*2048) float32, new_state, new_ps_state,
    new_syn_state_r)."""
    (Zr, Zi), new_state = device_decode_qmf(static, pcm, cond, state)
    XLr, XLi, XRr, XRi, new_ps = ps_decorrelate_mix(ps, Zr, Zi, H_slots,
                                                    ps_state)
    outL, new_state["syn_state"] = synthesize_slots(static, XLr, XLi,
                                                    state["syn_state"])
    outR, syn_r = synthesize_slots(static, XRr, XRi, syn_state_r)
    return torch.stack([outL, outR], 1), new_state, new_ps, syn_r


class SbrPsDeviceRunner:
    """The HE-AAC v2 runner of ``sbr_jax.SbrPsDeviceRunner`` for one stream
    (batch axis 1): the mono core's SBR reconstruction and the parametric
    stereo stage of whole frame groups on ``device``, with every state
    kept there across groups.  The cond build and the mixing matrices
    (``build_ps_H_slots``, over the parameter state of ``pdec_host``) stay
    on the host."""

    def __init__(self, dec: SBR.SbrDecoder, *, device="cuda"):
        self.dec = dec
        self.static = SbrStatic(dec)
        self.ps_static = PsStatic()
        self.device = torch.device(device)
        self.state_host = SBR.SbrChannelState()
        self.state_dev = state_to_device([device_init_state(self.static.M)],
                                         self.device)
        self.ps_state = ps_state_to_device([ps_init_state()], self.device)
        self.syn_state_r = torch.zeros((1, 704), dtype=torch.float32,
                                       device=self.device)
        self.pdec_host = SBR.PsDecoder()
        self.first = True
        self._core_ov = None          # (1, 1024) core overlap, spec mode

    def _dispatch(self, pcm, datas: list, Es: list, Qs: list,
                  ps_list: list):
        cond = build_frame_cond(self.dec, self.state_host, self.static,
                                datas, Es, Qs, self.first)
        self.first = False
        H = build_ps_H_slots(self.pdec_host, ps_list, NOUT)
        cd = cond_to_device({k: v[None] for k, v in vars(cond).items()},
                            self.device)
        out, self.state_dev, self.ps_state, self.syn_state_r = \
            device_decode_group_ps(self.static, self.ps_static, pcm, cd,
                                   self.state_dev, self.ps_state,
                                   self.syn_state_r,
                                   torch.from_numpy(H[None]).to(self.device))
        pcm16 = _pcm16(out[0])
        return lambda: pcm16.cpu().numpy()

    def decode_group_lazy(self, pcm_frames: np.ndarray, datas: list,
                          Es: list, Qs: list, ps_list: list):
        """One group from core PCM (F, 1024), queued on the device; per
        frame its SBR channel data, envelope and noise levels and PsData
        (or None, which holds the previous parameters).  Returns a
        zero-argument function that copies the (2, F*2048) int16 PCM
        back."""
        pcm = torch.from_numpy(np.asarray(pcm_frames, np.float32)[None])
        return self._dispatch(pcm.to(self.device), datas, Es, Qs, ps_list)

    def decode_group(self, pcm_frames: np.ndarray, datas: list, Es: list,
                     Qs: list, ps_list: list) -> np.ndarray:
        return self.decode_group_lazy(pcm_frames, datas, Es, Qs, ps_list)()

    def decode_group_lazy_spec(self, specs: np.ndarray, ops: np.ndarray,
                               datas: list, Es: list, Qs: list,
                               ps_list: list, host_overlap: np.ndarray):
        """:meth:`decode_group_lazy` with the mono LC core fused on the
        device: specs (F, 1024) float32 prepared spectra, ops (F,) operator
        indices; host_overlap (1024,) seeds the core overlap on the first
        spec group and after :meth:`fetch_core_overlap`."""
        if self._core_ov is None:
            self._core_ov = torch.from_numpy(
                np.asarray(host_overlap, np.float32)[None]).to(self.device)
        spec_t = torch.from_numpy(np.asarray(specs, np.float32)[None])
        op_t = torch.from_numpy(np.asarray(ops, np.int64)[None])
        pcm, self._core_ov = core_imdct_device(
            spec_t.to(self.device), op_t.to(self.device), self._core_ov)
        return self._dispatch(pcm, datas, Es, Qs, ps_list)

    def fetch_core_overlap(self):
        """The (1024,) core overlap after the last spec group, as numpy
        (None if there is none), handed back to the host: the next spec
        group seeds from the host again."""
        if self._core_ov is None:
            return None
        ov = self._core_ov[0].cpu().numpy()
        self._core_ov = None
        return ov
