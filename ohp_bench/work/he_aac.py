"""Work of the HE-AAC v1 kernels, counted by the reference's parse of the
content.

``sbr_env_map`` (``csrc/sbr_env.cu``, launched by ``_kernels.sbr_env``)
runs once a group of F frames (``frames_per_group``) over the C = streams
x channels SBR channels of the call, every group at the call's full
shape: streams that have ended keep their columns, their frames inactive.
Its bytes are every tensor ``_kernels.sbr_env`` checks, read or written
once at its dtype, M being the SBR band count the header's frequency
tables give:

- read: gain, noise, sine, sine_bins (C, F, 8, M) float32; env_id,
  prev_id (C, F, 38) int8; last_env (C, F) int8; r, carry_mask (C, F, 38)
  float32; k_ord (C, F, 38) int32; noise_idx0, sine_ph0 (C,) int32;
  no_noise (C, F, 8) float32; the two 512-entry noise tables and the (M,)
  parity row, float32; er, ei (C, F, 38, M) float32; filt (C, 2, M) and
  tail_r, tail_i (C, 6, M) float32;
- written: out_r, out_i (C, F, 32, M), filt (C, 2, M), tail_r, tail_i
  (C, 6, M), float32.

Its operations are the kernel's rounded float operations: 29 for each
(channel, slot, bin) it adjusts (two smoothing mixes of 4, the noise
mask and the sine bin's complement 1 each, the noise values 2, the sine
values 5, and the two injections of 6: ``adjust`` in the kernel).  A
thread adjusts its own slot where an envelope covers it (the frame's
buffer slots [2 t_env[0], 2 t_env[-1]) of 38), the 32 output slots of
every frame and the 6 tail slots of the group's last; a slot carried from
the frame before (below 2 t_env[0], past the group's first frame) also
adjusts that frame's slot 32 + s where an envelope of that frame covers
it.

``tns_rows`` is counted as for AAC-LC (``work/aac.py``), on the core's
frames.
"""

from __future__ import annotations

import math

from ..reference import aac as R
from ..reference import he_aac as H
from . import aac as work_aac

#: The kernel's float operations for one adjusted (channel, slot, bin).
OPS_PER_BIN = 29
ENV, SLOTS, OUT, TAIL = 8, 38, 32, 6


def grids(frame: bytes) -> list:
    """[(first border, last border)] per channel of a frame's SBR grid, in
    time slots; read from the payload alone (the grid comes before any
    field a previous frame or the header sets)."""
    payload, nbits, crc = H.sbr_payload(frame)
    b = H.Bits(payload, 0, nbits)
    if crc:
        b.read(10)
    if b.read(1):
        H.parse_sbr_header(b)
    stereo = R.parse_adts_header(frame).channels == 2
    if stereo:
        if b.read(1):
            b.read(8)
        coupled = b.read(1)
        gs = [H.parse_grid(b)]
        gs.append(gs[0] if coupled else H.parse_grid(b))
    else:
        if b.read(1):
            b.read(4)
        gs = [H.parse_grid(b)]
    return [(g.t_env[0], g.t_env[-1]) for g in gs]


def band_count(stream: bytes) -> int:
    """M of the stream's SBR header (its first frame carries one)."""
    frame = R.split_frames(stream)[0]
    payload, nbits, crc = H.sbr_payload(frame)
    b = H.Bits(payload, 0, nbits)
    if crc:
        b.read(10)
    if not b.read(1):
        raise H.SbrError("a stream that starts without an SBR header")
    h = R.parse_adts_header(frame)
    return H.derive_tables(2 * R.SAMPLE_RATES[h.rate_index],
                           H.parse_sbr_header(b)).M


def group_bytes(C: int, F: int, M: int) -> int:
    """Bytes ``sbr_env_map`` reads and writes for one group."""
    cf = C * F
    return (4 * cf * ENV * M * 4                        # gain .. sine_bins
            + 2 * cf * SLOTS + cf                       # env_id, prev_id, last
            + 3 * cf * SLOTS * 4                        # r, carry_mask, k_ord
            + 2 * C * 4 + cf * ENV * 4                  # seeds, no_noise
            + 2 * 512 * 4 + M * 4                       # tables, parity
            + 2 * cf * SLOTS * M * 4                    # er, ei
            + 2 * (C * 2 * M + 2 * C * TAIL * M) * 4    # filt, tails in/out
            + 2 * cf * OUT * M * 4)                     # out_r, out_i


def _active(border: tuple, s: int) -> bool:
    a, b = border
    return min(2 * a, SLOTS) <= s < min(2 * b, SLOTS)


def group_ops(channels: list, F: int, M: int) -> int:
    """Operations of ``sbr_env_map`` over one group: ``channels`` holds
    each channel's (first, last) borders of its live frames, at most
    ``F``; the rest of its F frames are inactive."""
    adjusted = 0
    for frames in channels:
        for f, border in enumerate(frames):
            last = f == F - 1
            for s in range(SLOTS if last else OUT):
                adjusted += _active(border, s)
                if f > 0 and s < min(2 * border[0], TAIL):
                    adjusted += _active(frames[f - 1], OUT + s)
    return OPS_PER_BIN * M * adjusted


def per_request(content: dict, cell: dict) -> dict:
    """{kernel name: {"bytes", "ops"}} that one serving call's streams
    need."""
    streams = content["streams"]
    F = int(cell["frames_per_group"])
    nch = R.parse_adts_header(streams[0]).channels
    M = band_count(streams[0])
    memo: dict = {}
    per_stream = []
    for s in streams:
        rows = []
        for fr in R.split_frames(s):
            if fr not in memo:
                memo[fr] = grids(fr)
            rows.append(memo[fr])
        per_stream.append(rows)
    groups = math.ceil(max(len(r) for r in per_stream) / F)
    C = len(streams) * nch
    ops = 0
    for g in range(groups):
        ops += group_ops([[row[c] for row in rows[g * F:(g + 1) * F]]
                          for rows in per_stream for c in range(nch)], F, M)
    out = {"sbr_env_map": {"bytes": float(groups * group_bytes(C, F, M)),
                           "ops": float(ops)}}
    out.update(work_aac.per_request(content, cell))
    return out
