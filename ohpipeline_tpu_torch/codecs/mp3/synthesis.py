"""MP3 hybrid filterbank for groups of granules, on tensors.

Port of the device half of ``ohpipeline_tpu.codecs.mp3.synthesis``: the
scan-free ``hybrid_synthesis_parallel`` and its int16-wire front
``hybrid_synthesis_parallel_i16``.  The host half (requantize, stereo, alias
reduction and the constant operators) is the port's numpy copy,
``host/codecs/mp3/prep.py``.  For Tg granules of B channels, in one pass:

* the windowed IMDCT: each subband's 18 lines times the (18, 36) operator
  of its block type.  The four operators sit side by side in one (18, 144)
  matrix, so one product gives every subband all four candidates and a
  gather keeps the one its block type names (no (Tg, B, 32, 18, 36)
  operator plane is built, and the block types never leave the device);
* the overlap-add against the previous granule's tails (the granule scan
  of ``hybrid_synthesis`` carries only that 576-sample overlap, so it is a
  shifted add), and the frequency inversion;
* the polyphase matrixing ``V = S @ poly_n`` (32 -> 64);
* the window pass, the 512-tap FIR over the 16-slot V history (the
  polyphase scan of ``hybrid_synthesis``, ``synthesis.py:346-355``), with
  the int rounding and clip: the hand-written kernel
  ``csrc/mp3_window.cu`` on CUDA tensors and its plain version
  :func:`mp3_window_torch` on CPU tensors.

Matrix products stay ``torch.matmul`` in full float32, as the reference
runs ``Precision.HIGHEST``: each function here that issues them first calls
``_kernels.require_full_fp32``, which raises ``KernelError`` when TF32 is on
for float32 matmuls on the card.  The state is
``(overlap (B, 576), vfifo (B, 16, 64))``, taken at the ``n_real`` boundary
so zero padding past it never advances a stream; the path has no weights.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import _kernels
from ...host.codecs.mp3 import prep

#: granule samples, subbands, lines per subband, polyphase slots per granule
N_GRAN, N_SB, N_LINE, N_SLOT = 576, 32, 18, 18
#: V vectors the window pass reads before a group's first slot
V_HIST = 15


class Mp3DeviceStatic:
    """The filterbank's float32 constants on ``device``: ``imdct`` (18, 144),
    the four block types' (18, 36) windowed IMDCT operators side by side;
    ``poly`` (32, 64), the matrixing; ``wnd`` (16, 32), the Table B.3
    window arranged for the U extraction; ``inv`` (32, 18), the frequency
    inversion's signs."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        ops = prep._imdct_operators().astype(np.float32)       # (4, 18, 36)
        sb = np.arange(N_SB)[:, None] % 2 == 1
        ln = np.arange(N_LINE)[None, :] % 2 == 1
        arrays = dict(
            imdct=np.ascontiguousarray(ops.transpose(1, 0, 2))
            .reshape(N_LINE, 4 * 36),
            poly=prep._polyphase_matrix().astype(np.float32),
            wnd=prep._window_matrix().astype(np.float32),
            inv=np.where(sb & ln, -1.0, 1.0).astype(np.float32))
        for name, a in arrays.items():
            setattr(self, name, torch.from_numpy(np.ascontiguousarray(a))
                    .to(self.device))


_STATICS: dict[str, Mp3DeviceStatic] = {}


def device_static(device="cuda") -> Mp3DeviceStatic:
    """The :class:`Mp3DeviceStatic` of ``device``, made once."""
    key = str(torch.device(device))
    if key not in _STATICS:
        _STATICS[key] = Mp3DeviceStatic(device)
    return _STATICS[key]


def mp3_window_torch(vfull: torch.Tensor, wnd: torch.Tensor,
                     bit_depth: int = 16) -> torch.Tensor:
    """Plain version of ``csrc/mp3_window.cu``: the window pass of
    ``hybrid_synthesis_parallel`` (``synthesis.py:399-422``).  vfull
    (15 + T, B, 64) float32, the V history oldest first and then the
    group's T = 18 Tg slots; wnd (16, 32).  Slot t's sample i is
    ``sum_j wnd[j, i] U_j`` with ``U_2m = vfull[15 + t - 2m, :, i]`` and
    ``U_2m+1 = vfull[14 + t - 2m, :, 32 + i]``, scaled by 2^(bit_depth - 1),
    rounded half to even and clipped.  The products are summed in j order,
    each product and sum rounded, as the kernel sums them, so the two agree
    bit for bit (a reduction in another order parts from it by a few ulp of
    the partial sums: at 24 bits, where a sample's ulp is ~1 LSB, by
    several LSB).  Returns (Tg, B, 576) int32, slot t at granule t // 18,
    samples (t % 18) * 32 + i."""
    T, B = vfull.shape[0] - V_HIST, vfull.shape[1]
    pcm = None
    for j in range(16):                  # U_j: slot t - 2 (j // 2), then odd
        r = V_HIST - 2 * (j // 2) - j % 2
        lanes = slice(32, 64) if j % 2 else slice(0, 32)
        term = vfull[r:r + T, :, lanes] * wnd[j]
        pcm = term if pcm is None else pcm + term              # (T, B, 32)
    pcm = pcm.reshape(T // N_SLOT, N_SLOT, B, 32).transpose(1, 2) \
        .reshape(T // N_SLOT, B, N_GRAN)
    lim = 1 << (bit_depth - 1)
    return torch.round(pcm * float(lim)).clamp_(-lim, lim - 1) \
        .to(torch.int32)


def mp3_window(vfull: torch.Tensor, wnd: torch.Tensor,
               bit_depth: int = 16) -> torch.Tensor:
    """The window pass: the ``mp3_window`` kernel on CUDA tensors (no
    fallback), :func:`mp3_window_torch` on CPU tensors."""
    if vfull.device.type == "cpu":
        return mp3_window_torch(vfull, wnd, bit_depth)
    return _kernels.mp3_window(vfull, wnd, bit_depth)


def imdct_overlap(static: Mp3DeviceStatic, xr_t, btype_t, overlap,
                  n_real: int):
    """The IMDCT, overlap-add and frequency inversion of a group: xr_t (Tg,
    B, 576) float32 spectra, btype_t (Tg, B, 32) block types, overlap (B,
    576) -> ((Tg, B, 32, 18) subband samples, the new overlap (B, 576): the
    tails of granule n_real - 1)."""
    _kernels.require_full_fp32(xr_t.device)
    Tg, B = xr_t.shape[:2]
    cand = torch.matmul(xr_t.reshape(-1, N_LINE), static.imdct) \
        .reshape(Tg, B, N_SB, 4, 36)
    sel = btype_t.long().reshape(Tg, B, N_SB, 1, 1).expand(-1, -1, -1, 1, 36)
    x36 = cand.gather(3, sel).squeeze(3)                       # (Tg,B,32,36)
    heads, tails = x36[..., :N_LINE], x36[..., N_LINE:]
    prev = torch.cat([overlap.reshape(1, B, N_SB, N_LINE), tails[:-1]])
    time_out = (heads + prev) * static.inv
    return time_out, tails[n_real - 1].reshape(B, N_GRAN)


def matrixing(static: Mp3DeviceStatic, time_out, vfifo):
    """The polyphase matrixing of (Tg, B, 32, 18) subband samples behind the
    carried (B, 16, 64) V-FIFO (newest first) -> vfull (15 + 18 Tg, B, 64),
    the FIFO's 15 newest rows oldest first, then the group's slots."""
    _kernels.require_full_fp32(time_out.device)
    Tg, B = time_out.shape[:2]
    S = time_out.permute(0, 3, 1, 2).reshape(Tg * N_SLOT, B, N_SB)
    V = torch.matmul(S, static.poly)                            # (T, B, 64)
    hist = vfifo[:, :V_HIST].flip(1).transpose(0, 1)
    return torch.cat([hist, V])


def hybrid_synthesis_parallel(xr_t, btype_t, overlap, vfifo, n_real: int,
                              bit_depth: int = 16):
    """The scan-free hybrid filterbank (``synthesis.py:364-423``): xr_t (Tg,
    B, 576) float32 spectra, zero-padded past ``n_real`` granules, btype_t
    (Tg, B, 32) per-subband block types, overlap (B, 576) and vfifo (B, 16,
    64) on one device.  Returns (pcm (Tg, B, 576) int32 in the bit_depth
    range, new overlap, new vfifo), the state at the n_real boundary."""
    _kernels.require_full_fp32(xr_t.device)
    Tg = xr_t.shape[0]
    if not 1 <= n_real <= Tg:
        raise ValueError(f"n_real {n_real} outside 1..{Tg}")
    static = device_static(xr_t.device)
    time_out, new_ov = imdct_overlap(static, xr_t, btype_t, overlap, n_real)
    vfull = matrixing(static, time_out, vfifo)
    pcm = mp3_window(vfull, static.wnd, bit_depth)
    return pcm, new_ov, fifo_at(vfull, n_real)


def fifo_at(vfull, n_real: int):
    """The (B, 16, 64) V-FIFO after slot 18 n_real - 1 of vfull: the 16
    newest V vectors up to it, newest first (``synthesis.py:416-419``)."""
    end = N_SLOT * n_real + V_HIST            # one past slot 18 n_real - 1
    return vfull[end - 16:end].flip(0).transpose(0, 1).contiguous()


def hybrid_synthesis_parallel_i16(q16, scl, btype_t, overlap, vfifo,
                                  n_real: int, bit_depth: int = 16):
    """:func:`hybrid_synthesis_parallel` behind the int16 spectrum wire of
    the serving call (``synthesis.py:426-439``): q16 (Tg, B, 576) int16
    quantised spectra with per-granule-channel scales scl (Tg, B) float32
    (xr = q16 * scl); btype_t may be uint8."""
    _kernels.require_full_fp32(q16.device)
    xr_t = q16.float() * scl[..., None]
    return hybrid_synthesis_parallel(xr_t, btype_t, overlap, vfifo, n_real,
                                     bit_depth)


def init_state(B: int, device="cuda") -> tuple:
    """The zero state ``(overlap (B, 576), vfifo (B, 16, 64))``."""
    return (torch.zeros((B, N_GRAN), device=device),
            torch.zeros((B, 16, 64), device=device))


def state_from_numpy(overlap, vfifo, device="cuda") -> tuple:
    """The JAX package's numpy state ``(overlap (B, 576), vfifo (B, 16,
    64))`` -> the port's state tensors on ``device``."""
    return tuple(torch.from_numpy(np.array(a, np.float32)).to(device)
                 for a in (overlap, vfifo))
