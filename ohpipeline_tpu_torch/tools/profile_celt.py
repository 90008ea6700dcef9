"""Where the time of the CELT serving call goes, on the card.

    python -m ohpipeline_tpu_torch.tools.profile_celt    # repository root

On ``chip_smoke.py``'s CELT content (16 stereo streams cut from
``tests/assets/dryrun.opus``, 32 frames a group), after one warm-up call:

1. a staged call: the serving loop of ``decode_celt_streams_device`` with
   ``torch.cuda.synchronize()`` after each stage (host entropy capture,
   packing, upload, TDAC, comb, deemphasis and rounding, copy-back), each
   stage's seconds summed over the groups;
2. five warm unstaged calls, wall seconds each;
3. one warm call under ``torch.profiler``: device time by kernel name, the
   union of the device's busy intervals, and the idle share, 1 - busy /
   wall;
4. the comb kernel on ``chip_smoke.py``'s worst-case rows at 32, 132 and
   264 rows (16, 66 and 132 streams of 32 frames), with the runs of
   samples a block walks (``comb_runs``) and the time per run: if the
   time holds while the rows fill the SMs, the chain of runs, not
   occupancy, sets it.

Prints each part and then one JSON line with all the numbers, after the
card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import itertools
import json
import subprocess
import sys
import time

import numpy as np
import torch

from .. import _kernels
from ..codecs.opus import celt as pc
from . import smoke, trace_call


def comb_runs(Tv: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(S,) runs of samples the block of each of a stream's rows walks in
    ``csrc/celt_comb.cu``: per frame and piece (two crossfades, then the
    steady part), the piece's length over the shortest lag - 2 of the tap
    sets that carry weight there."""
    T = np.clip(Tv, 15, 1024)
    on = np.abs(gt).sum(-1) > 0
    runs = np.zeros(T.shape[0], np.int64)
    for lo, hi, a, fade in ((0, 120, 0, True), (120, 240, 1, True),
                            (240, 960, 1, False)):
        lag = np.full(T.shape[:2], hi - lo + 2)
        lag = np.where(on[..., a] & fade, np.minimum(lag, T[..., a]), lag)
        lag = np.where(on[..., a + 1], np.minimum(lag, T[..., a + 1]), lag)
        runs += (-(-(hi - lo) // (lag - 2))).sum(1)
    return runs


def comb_scaling(dev) -> list:
    """celt_comb on the worst-case rows at 16, 66 and 132 streams."""
    cs = smoke()
    win2 = pc.device_static(dev).win2
    out = []
    for S in (16, 66, 132):
        y, Tv, gt = cs.celt_comb_worst_case(dev, S=S)
        ms = cs.cuda_ms(lambda: _kernels.celt_comb(y, Tv, gt, win2), 20)
        runs = int(comb_runs(Tv.cpu().numpy(), gt.cpu().numpy()).max())
        out.append({"rows": 2 * S, "ms": ms, "max_runs_per_row": runs,
                    "ns_per_run": ms * 1e6 / runs})
    return out


def staged(streams: list, group: int, dev) -> dict:
    """The serving loop, stage by stage, each ended by a synchronise."""
    t = dict.fromkeys(("open", "capture", "pack", "upload", "tdac", "comb",
                       "deemph", "copy_back"), 0.0)

    def clock(name, t0):
        torch.cuda.synchronize()
        now = time.perf_counter()
        t[name] += now - t0
        return now

    t0 = time.perf_counter()
    gens = [pc._open_capture(s)[1] for s in streams]
    S, CH = len(gens), 2
    static = pc.device_static(dev)
    hist, c60, m = pc.init_state(S, CH, dev)
    t0 = clock("open", t0)
    groups, runs = 0, []
    while True:
        chunks = [list(itertools.islice(g, group)) for g in gens]
        n = min(len(c) for c in chunks)
        if n == 0:
            break
        t0 = clock("capture", t0)
        wire = [np.zeros((S, group, *a.shape[1:]), a.dtype)
                for a in pc.pack_captures(chunks[0][:1], CH)]
        for si, c in enumerate(chunks):
            for dst, src in zip(wire, pc.pack_captures(c[:n], CH)):
                dst[si, :n] = src
        X, gains, op, Tv, gt = wire
        runs.append(int(comb_runs(Tv, gt).max()))
        t0 = clock("pack", t0)
        Xt, gains_t, Tv_t, gt_t = (torch.from_numpy(a).to(dev)
                                   for a in (X, gains, Tv, gt))
        t0 = clock("upload", t0)
        out, tails = pc.tdac(static, Xt, gains_t, op, c60)
        t0 = clock("tdac", t0)
        filtered, hist = pc.comb(pc.comb_rows(hist, out), Tv_t, gt_t,
                                 static.win2)
        t0 = clock("comb", t0)
        pcm16, m = pc.deemphasis(static, filtered, m, S)
        c60 = tails[:, -1].contiguous()
        hist = hist.reshape(S, CH, pc.HLEN)
        t0 = clock("deemph", t0)
        pcm16[:, :n].cpu().numpy()
        t0 = clock("copy_back", t0)
        groups += 1
        if n < group:
            break
    t["groups"] = groups
    t["comb_max_runs_per_row"] = runs
    return t


def traced(streams: list, group: int) -> dict:
    """One warm call under torch.profiler: device time by kernel, busy
    union and idle share."""
    prof, _, info = trace_call(
        lambda: pc.decode_celt_streams_device(streams, group))
    by_kernel = sorted(
        ((k.key, k.count, getattr(k, "self_device_time_total", 0.0) / 1e3)
         for k in prof.key_averages()
         if getattr(k, "self_device_time_total", 0.0) > 0),
        key=lambda r: -r[2])
    return {**info,
            "top_kernels_ms": [[k, c, ms] for k, c, ms in by_kernel[:10]]}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("profile_celt: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    streams = smoke().celt_streams()
    group = 32
    out = pc.decode_celt_streams_device(streams, group)      # warm-up
    torch.cuda.synchronize()
    S, CH, n = out.shape
    audio_s = S * n / 48000.0
    stages = staged(streams, group, dev)
    print("staged:", stages)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        pc.decode_celt_streams_device(streams, group)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print("warm walls:", [round(w, 4) for w in walls])
    trace = traced(streams, group)
    print("trace:", trace)
    scaling = comb_scaling(dev)
    print("comb scaling:", scaling)
    print(card)
    print(json.dumps({"card": card, "streams": S, "audio_s": audio_s,
                      "staged_s": stages, "warm_wall_s": walls,
                      "decoded_s_per_wall_s": [audio_s / w for w in walls],
                      "trace": trace, "comb_scaling": scaling}))


if __name__ == "__main__":
    main()
