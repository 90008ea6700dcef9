"""Batched, bit-exact LPC residual synthesis: the decode core of FLAC.

The recurrence (FLAC spec; flac-1.2.1 ``FLAC__lpc_restore_signal_wide``):

    s[n] = r[n] + floor( sum_{i=1..order} c[i] * s[n-i]  /  2**shift )

with warm-up samples s[0..order) stored verbatim.  Every subframe carries
its own warm-up, so all rows of a batch decode independently; within a row
the floor makes the recurrence sequential.  The accumulator needs up to ~46
bits (24-bit audio, order 32), so it is int64 here; the JAX package splits
it into 12-bit limbs only because the TPU has no int64.

Layouts (as ``ohpipeline_tpu.ops.lpc``):
    data   (B, N) int32 -- warm-up in [0, order_b), residuals after it.
    coeffs (B, 32) int32 -- c[1..order] zero-padded; coeffs[b, i]
                            multiplies s[n-1-i].
    shift  (B,) int32 in [0, 31];  order (B,) int32 in [0, 32].
Returns (B, N) int32 samples.
"""

from __future__ import annotations

import torch

from .. import _kernels

MAX_ORDER = 32

#: Fixed-predictor coefficients (FLAC spec, fixed subframe; orders 0-4,
#: shift 0).
FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value with the same low 32 bits (still int64)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def lpc_synthesize_torch(data, coeffs, shift, order):
    """Plain PyTorch version: a loop over N, vectorised over B, with an
    int64 accumulator.  Bit-exact with the kernel and the JAX package."""
    B, N = data.shape
    c = coeffs.to(torch.int64)
    sh = shift.to(torch.int64)
    order = order.to(torch.int64)
    hist = torch.zeros((B, MAX_ORDER), dtype=torch.int64, device=data.device)
    out = torch.empty((B, N), dtype=torch.int32, device=data.device)
    d = data.to(torch.int64)
    for n in range(N):
        pred = (c * hist).sum(dim=1) >> sh
        s = torch.where(n < order, d[:, n], wrap32(d[:, n] + pred))
        out[:, n] = s.to(torch.int32)
        hist = torch.cat([s[:, None], hist[:, :-1]], dim=1)
    return out


def lpc_synthesize(data, coeffs, shift, order):
    """LPC synthesis: the CUDA kernel (``csrc/lpc.cu``) for tensors on the
    card, the plain version for tensors on the CPU."""
    if data.device.type == "cpu":
        return lpc_synthesize_torch(data, coeffs, shift, order)
    return _kernels.lpc(data, coeffs, shift, order)
