"""Where the time of the MP3 and Vorbis serving calls goes, on the card.

    python -m ohpipeline_tpu_torch.tools.profile_mp3_vorbis   # repo root

On ``chip_smoke.py``'s content (16 stereo MP3 streams of bench_secondary.py's
MP3 cell, 32 frames a group; 16 stereo Vorbis streams, half its Vorbis
cell's all-long content and half mixed blocks, 64 blocks a group; 8 s
each), after one warm-up call of each:

1. a staged call of each: the serving loop with
   ``torch.cuda.synchronize()`` after each stage, each stage's seconds
   summed over the groups.  MP3: host parse and prep (``pack_group``: the
   native Huffman core, requantize, stereo, alias reduction and the int16
   wire), upload, the filterbank (IMDCT and overlap, matrixing, the
   ``mp3_window`` kernel), copy-back.  Vorbis: host capture and packing
   (``next_group``: the entropy decode with the native residue walk, the
   int16 wire), upload, the group step (products, ``index_add_``, lap
   carry, rounding), copy-back;
2. three warm unstaged calls of each, wall seconds;
3. one warm call of each under ``torch.profiler``: device time by kernel
   name, the union of the device's busy intervals, and the idle share, 1 -
   busy / wall.

Prints each part and then one JSON line with all the numbers, after the
card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from ..codecs.mp3 import synthesis as msyn
from ..codecs.mp3.serving import decode_mp3_streams_device, pack_group
from ..codecs.vorbis import device as vdev
from ..host.codecs.mp3 import bitstream as BS
from . import smoke, trace_call


class Clock:
    """Seconds per stage, each stage ended by a synchronise."""

    def __init__(self, *names):
        self.t = dict.fromkeys(names, 0.0)
        self.t0 = time.perf_counter()

    def __call__(self, name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        self.t[name] += now - self.t0
        self.t0 = now


def staged_mp3(streams: list, G: int, dev) -> dict:
    """decode_mp3_streams_device's loop, stage by stage."""
    clock = Clock("host_parse_prep", "upload", "imdct_overlap", "matrixing",
                  "window", "copy_back")
    nch, S = 2, len(streams)
    Tg = 2 * G
    parsers = [BS.Mp3Stream(s) for s in streams]
    live = [True] * S
    ov, vf = msyn.init_state(S * nch, dev)
    static = msyn.device_static(dev)
    groups = 0
    while any(live):
        clock.t0 = time.perf_counter()
        (q16, scl, btp), counts, n_real = pack_group(parsers, live, G, nch,
                                                     Tg)
        if not n_real:
            break
        clock("host_parse_prep")
        q, sc, bt = (torch.from_numpy(a).to(dev) for a in (q16, scl, btp))
        clock("upload")
        xr = q.float() * sc[..., None]
        time_out, ov = msyn.imdct_overlap(static, xr, bt, ov, n_real)
        clock("imdct_overlap")
        vfull = msyn.matrixing(static, time_out, vf)
        vf = msyn.fifo_at(vfull, n_real)
        clock("matrixing")
        pcm = msyn.mp3_window(vfull, static.wnd)
        clock("window")
        pcm.cpu().numpy()
        clock("copy_back")
        groups += 1
    return {**clock.t, "groups": groups}


def staged_vorbis(streams: list, group: int, dev) -> dict:
    """decode_vorbis_streams_device's loop, stage by stage."""
    clock = Clock("host_capture_pack", "upload", "group_step", "copy_back")
    caps = [vdev.capture_stream_iter(s) for s in streams]
    gens = [c[1] for c in caps]
    bs0, bs1 = caps[0][0].blocksize
    ch, S = caps[0][0].channels, len(streams)
    ops = vdev.device_operators(bs0, bs1, dev)
    carry = torch.zeros((S, ch, bs1 // 2), device=dev)
    cursors = [None] * S
    groups = 0
    while True:
        clock.t0 = time.perf_counter()
        wire = vdev.next_group(gens, cursors, bs0, bs1, ch, group)
        if wire is None:
            break
        clock("host_capture_pack")
        Xq, scale, onehot, lo, shift = wire
        Xq_t, scale_t, lo_t, shift_t = (torch.from_numpy(a).to(dev)
                                        for a in (Xq, scale, lo, shift))
        clock("upload")
        pcm16, carry = vdev.group_step(ops, Xq_t, scale_t, onehot, lo_t,
                                       shift_t, carry)
        clock("group_step")
        pcm16.cpu().numpy()
        clock("copy_back")
        groups += 1
    return {**clock.t, "groups": groups}


def traced(run) -> dict:
    """One warm call under torch.profiler: device time by kernel, busy
    union and idle share."""
    prof, _, info = trace_call(run)
    by_kernel = sorted(
        ((k.key, k.count, getattr(k, "self_device_time_total", 0.0) / 1e3)
         for k in prof.key_averages()
         if getattr(k, "self_device_time_total", 0.0) > 0),
        key=lambda r: -r[2])
    return {**info,
            "top_kernels_ms": [[k, c, ms] for k, c, ms in by_kernel[:12]]}


def profile(name, run, staged, audio_of) -> dict:
    out = run()                                              # warm-up
    torch.cuda.synchronize()
    audio_s = audio_of(out)
    stages = staged()
    print(f"{name} staged:", stages)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print(f"{name} warm walls:", [round(w, 4) for w in walls])
    trace = traced(run)
    print(f"{name} trace:", trace)
    return {"audio_s": audio_s, "staged_s": stages, "warm_wall_s": walls,
            "decoded_s_per_wall_s": [audio_s / w for w in walls],
            "trace": trace}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("profile_mp3_vorbis: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    cs = smoke()
    content = cs.codec_content()
    mp3, vorbis = content["mp3"], content["vorbis"]
    G, group = cs.MP3_FRAMES_PER_GROUP, cs.VORBIS_GROUP
    res = {
        "mp3": profile(
            "mp3", lambda: decode_mp3_streams_device(mp3, G, device=dev),
            lambda: staged_mp3(mp3, G, dev),
            lambda o: sum(x.shape[1] for x in o) / 44100.0),
        "vorbis": profile(
            "vorbis",
            lambda: vdev.decode_vorbis_streams_device(vorbis, group,
                                                      device=dev),
            lambda: staged_vorbis(vorbis, group, dev),
            lambda o: sum(x.shape[1] for x in o) / 44100.0)}
    print(card)
    print(json.dumps({"card": card, **res}))


if __name__ == "__main__":
    main()
