"""Walls of the four device serving calls with no mesh (FLAC, AAC-LC,
HE-AAC, MP3) on the card, over ``chip_smoke.py`` phase 19's content, for
one or more checkouts of the repository in turn: run a parent commit
unpacked beside this one, then this one, then this one, then the parent,
to compare the two on one card in one run.

    python -m ohpipeline_tpu_torch.tools.serving_walls [--reps N] ROOT...

Each ROOT runs in a process of its own, from that directory, with its own
``ohpipeline_tpu_torch`` and ``chip_smoke``: the content is rebuilt from
the same seeds, every call is made once warm, then ``--reps`` times.
Prints each run's walls and, per checkout, the median over its runs.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np

#: codec -> (serving module, call, streams, frames a group, output rate
#: or None for twice the ADTS rate): phase 19's cells
CELLS = {
    "FLAC": ("flac", "decode_flac_streams_device", 16, 32, 44100),
    "AAC-LC": ("aac", "decode_aac_streams_device", 16, 64, 44100),
    "HE-AAC": ("aac", "decode_he_streams_device", 5, 48, None),
    "MP3": ("mp3", "decode_mp3_streams_device", 8, 32, 44100),
}

_RUN = r'''
import importlib, json, sys, time
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from ohpipeline_tpu_torch._host import aac_bitstream

cells, reps = json.loads(sys.argv[1]), int(sys.argv[2])
_jobs, encoded = cs.flac_content()
content = {"FLAC": [b for _, b in encoded], "AAC-LC": cs.aac_streams(),
           "HE-AAC": cs.he_streams(), "MP3": cs.codec_content()["mp3"]}
out = {}
for codec, (mod, call, n, group, rate) in cells.items():
    fn = getattr(importlib.import_module(
        f"ohpipeline_tpu_torch.codecs.{mod}.serving"), call)
    streams = content[codec][:n]
    rate = rate or 2 * aac_bitstream.parse_adts_header(
        streams[0]).sample_rate
    fn(streams, group, device="cuda")
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        pcm = fn(streams, group, device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out[codec] = {"walls": walls,
                  "audio_s": sum(o.shape[1] for o in pcm) / rate}
print(json.dumps(out))
'''


def run_root(root: str, reps: int) -> dict:
    proc = subprocess.run([sys.executable, "-c", _RUN, json.dumps(CELLS),
                           str(reps)], cwd=root, capture_output=True,
                          text=True, check=True)
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    pooled: dict = {}
    for i, root in enumerate(args.roots):
        res = run_root(root, args.reps)
        for codec, r in res.items():
            w = r["walls"]
            pooled.setdefault(root, {}).setdefault(codec, []).extend(w)
            print(f"run {i} {root} {codec}: {r['audio_s']:.1f} s of audio, "
                  f"walls {[round(x, 4) for x in w]}, median "
                  f"{np.median(w):.4f} s, "
                  f"{r['audio_s'] / np.median(w):.1f} decoded s per wall s")
    for root, cells in pooled.items():
        print(f"{root}: median wall over its runs: " + "; ".join(
            f"{codec} {np.median(w):.4f} s ({min(w):.4f}-{max(w):.4f})"
            for codec, w in cells.items()))


if __name__ == "__main__":
    main()
