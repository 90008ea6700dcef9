"""Where the time of the FLAC serving call goes, on the card.

    python -m ohpipeline_tpu_torch.tools.profile_flac    # repository root

On ``chip_smoke.py``'s FLAC content (phase 4's 18 streams: 16 CD-quality
stereo streams and 2 at 24-bit / 96 kHz, 32 frames a group), after one
warm-up call:

1. a staged call: the serving loop of ``decode_flac_streams_device`` with
   ``torch.cuda.synchronize()`` after each stage (the survey parse, the
   per-group parse, upload, group pass, copy-back), each stage's seconds
   summed over the groups;
2. five warm unstaged calls, wall seconds each;
3. one warm call under ``torch.profiler``: the union of the device's busy
   intervals, the idle share (1 - busy / wall), and the device time per
   group of the ``rice`` and ``lpc`` kernels, of the glue around the rice
   decode (``index_add``: the overflow units and the constant fills;
   ``escape_scatter``: the escape triples written over the plane; ``cat``:
   the whole-plane copy in front of it), of the copies and of the rest,
   with the ten kernels that took longest.

Prints each part and then one JSON line with all the numbers, after the
card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from ..codecs import flac
from ..codecs.flac import serving
from . import smoke, trace_call

#: Parts of the group pass, each named by substrings of its device events'
#: names (CUDA kernels and copies); what matches none is "other".
PARTS = (("rice", ("rice_units",)),
         ("lpc", ("lpc_rows",)),
         ("index_add", ("indexFuncLargeIndex", "indexFuncSmallIndex")),
         ("escape_scatter", ("index_elementwise_kernel",)),
         ("cat", ("CatArrayBatchedCopy",)),
         ("copies", ("Memcpy", "Memset")))


def part_of(name: str) -> str:
    return next((part for part, keys in PARTS
                 if any(k in name for k in keys)), "other")


def staged(streams: list, group: int, dev) -> dict:
    """The serving loop, stage by stage, each ended by a synchronise; the
    survey is timed inside the first group's parse and taken out of it."""
    t = dict.fromkeys(("survey", "parse", "upload", "group_pass",
                       "copy_back"), 0.0)
    nch = serving.parse_metadata(streams[0]).streaminfo.channels
    real = serving._Layout.survey

    def survey(self):
        t0 = time.perf_counter()
        try:
            return real(self)
        finally:
            t["survey"] += time.perf_counter() - t0

    def clock(name, t0):
        torch.cuda.synchronize()
        now = time.perf_counter()
        t[name] += now - t0
        return now

    serving._Layout.survey = survey
    groups = 0
    try:
        gen = serving.iter_groups(streams, group)
        while True:
            t0, s0 = time.perf_counter(), t["survey"]
            item = next(gen, None)
            t["parse"] += time.perf_counter() - t0 - (t["survey"] - s0)
            if item is None:
                break
            t0 = time.perf_counter()
            tt = flac.to_device(item[0], dev)
            t0 = clock("upload", t0)
            pcm = flac.synthesise_group_rice(
                *(tt[k] for k in flac.RICE_PLANES), nch)
            t0 = clock("group_pass", t0)
            pcm.cpu().numpy()
            clock("copy_back", t0)
            groups += 1
    finally:
        serving._Layout.survey = real
    t["groups"] = groups
    return t


def traced(streams: list, group: int, groups: int) -> dict:
    """One warm call under torch.profiler: busy union, idle share, device
    ms per group of each part, and the ten longest kernels."""
    _, events, info = trace_call(lambda: serving.decode_flac_streams_device(
        streams, group, device="cuda"))
    parts = dict.fromkeys([p for p, _ in PARTS] + ["other"], 0.0)
    by_name: dict = {}
    for e in events:
        us = e.time_range.end - e.time_range.start
        parts[part_of(e.name)] += us / 1e3 / groups
        n, tot = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, tot + us / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {**info, "device_ms_per_group": parts,
            "top_kernels_ms": [[k, n, ms] for k, (n, ms) in top]}


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("profile_flac: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    cs = smoke()
    jobs, encoded = cs.flac_content()
    streams = [b for _, b in encoded]
    audio_s = sum(t.shape[1] / rate for (t, _), (_, _, rate, _) in
                  zip(encoded, jobs))
    dev = torch.device("cuda")
    group = cs.FRAMES_PER_GROUP
    serving.decode_flac_streams_device(streams, group, device="cuda")
    torch.cuda.synchronize()                                  # warm-up
    stages = staged(streams, group, dev)
    print("staged:", stages)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        serving.decode_flac_streams_device(streams, group, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print("warm walls:", [round(w, 4) for w in walls])
    trace = traced(streams, group, stages["groups"])
    print("trace:", trace)
    print(card)
    print(json.dumps({"card": card, "streams": len(streams),
                      "audio_s": audio_s, "staged_s": stages,
                      "warm_wall_s": walls,
                      "decoded_s_per_wall_s": [audio_s / w for w in walls],
                      "trace": trace}))


if __name__ == "__main__":
    main()
