"""Where the time of the FLAC serving call goes, on the card.

    python -m ohpipeline_tpu_torch.tools.profile_flac [--out DIR]

from the repository root.  On ``chip_smoke.py``'s FLAC content (phase 4's
18 streams: 16 CD-quality stereo streams and 2 at 24-bit / 96 kHz, 32
frames a group), after one warm-up call:

1. a recorded call (``tools.recorded``): one warm call inside
   ``tracing.recording()``, with the count, total and self seconds of each
   of its spans (``serve.call``; ``serve.parse``: each stream's group
   parsed once; ``serve.launch``: upload and enqueue,
   ``serve.collect``: copy back, ``serve.assemble``) and the counters
   (groups, bytes up and back);
2. five warm calls, wall seconds each;
3. one warm call under ``torch.profiler``, recorded too: the union of the
   device's busy intervals, the idle share (1 - busy / wall), and the
   device time per group of the ``rice`` and ``lpc`` kernels, of the glue
   around the rice decode (``index_add``: the overflow units and the
   constant fills; ``escape_scatter``: the escape triples written over the
   plane; ``cat``: the whole-plane copy in front of it), of the copies and
   of the rest, with the ten kernels that took longest.  Its trace, with
   the spans, goes to ``DIR/profile_flac.trace.json``
   (``tracing.chrome_trace``; DIR defaults to the current directory).

Prints each part and then one JSON line with all the numbers, after the
card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

from ..codecs.flac import serving
from . import recorded, smoke, trace_call

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


def traced(streams: list, group: int, groups: int, chrome: str) -> dict:
    """One warm call under torch.profiler: busy union, idle share, device
    ms per group of each part, and the ten longest kernels; its trace with
    the call's spans is written to ``chrome``."""
    _, events, info = trace_call(lambda: serving.decode_flac_streams_device(
        streams, group, device="cuda"), chrome)
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
    ap = argparse.ArgumentParser(prog="python -m "
                                 "ohpipeline_tpu_torch.tools.profile_flac")
    ap.add_argument("--out", default=".", help="directory of the trace")
    args = ap.parse_args()
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
    group = cs.FRAMES_PER_GROUP

    def call():
        serving.decode_flac_streams_device(streams, group, device="cuda")

    call()
    torch.cuda.synchronize()                                  # warm-up
    spans = recorded(call)
    print("recorded:", spans)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    print("warm walls:", [round(w, 4) for w in walls])
    trace = traced(streams, group, spans["counters"]["groups.serve"],
                   os.path.join(args.out, "profile_flac.trace.json"))
    print("trace:", trace)
    print(card)
    print(json.dumps({"card": card, "streams": len(streams),
                      "audio_s": audio_s, "recorded": spans,
                      "warm_wall_s": walls,
                      "decoded_s_per_wall_s": [audio_s / w for w in walls],
                      "trace": trace}))


if __name__ == "__main__":
    main()
