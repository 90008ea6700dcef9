"""Aggregate FLAC + AAC-LC decoded seconds per wall second on one card: the
port's counterpart of the headline of the repository root's ``bench.py``.

    python -m ohpipeline_tpu_torch.bench                  # the headline
    python -m ohpipeline_tpu_torch.bench --smoke --cpu    # 2 + 2 streams
    python -m ohpipeline_tpu_torch.bench --secondary      # per-codec sweep
    python -m ohpipeline_tpu_torch.bench --all-codecs     # six calls at once

Run from the repository root.  It runs on the card (``cuda``) unless
``--cpu`` is given; without a card and without ``--cpu`` it raises.

Content: ``--flac-streams`` FLAC streams of ``make_track`` (seeds 7, 8,
...; ``--seconds`` each) encoded by the port's FLAC encoder in spawned
workers, and ``--aac-streams`` AAC-LC streams tiled from
``tests/assets/dryrun.aac`` to ``--seconds`` each (the repository has no
AAC encoder).  Encodes are cached under ``.bench_cache/torch/``.  A half
with no audio fails the run (exit 1, an ``"error"`` field).

One timed pass calls ``decode_flac_streams_device`` (32 frames a group) and
then ``decode_aac_streams_device`` (64 frames a group) on the device, each
ending with its PCM on the host; each call sizes every group's wire planes
from that group's own parse (the JAX package's benches time a survey parse
too, which gives its groups one compiled shape; the port has none).  Before
the first pass the float32 matmul precision is checked
(``_kernels.require_full_fp32``) and one untimed pass warms up.  Decoded
seconds are per-channel output samples over the output rate, summed over
streams; the value is their sum over the best pass's wall.  Without
``--smoke`` the line also carries the secondary floor probe
(``bench_secondary.floor_probe(passes=2)``), whose failure fails the run.
``--smoke`` (2 + 2 streams of 4 s, 1 pass) adds its gates: stream 0's FLAC
PCM equals its track bit for bit, and the first AAC group is within rms
0.25 and max 1 LSB of the float64 reference; a failed gate exits 1.

Prints one JSON line last: {"metric": "flac_aac_decode_realtime_x",
"value", "unit", "vs_baseline", "flac_audio_s", "aac_audio_s", "wall_s",
"wall_median_s", "passes_completed", "backend", "card", ...}.  Writes no
file outside ``.bench_cache/``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import bench_secondary

RATE = 44100
#: the reference headline's target, the denominator of ``vs_baseline``
BASELINE_X = 500.0
AAC_CONTENT = "tiled tests/assets/dryrun.aac"


def make_track(seconds: float, rate: int = 44100, seed: int = 7):
    """The reference headline's content (``bench.py:68-85``): tones, noise
    and transients, per-seed frequencies and envelopes, 16-bit stereo."""
    rng = np.random.default_rng(seed)
    n = int(rate * seconds)
    t = np.arange(n) / rate
    f1 = 200 + 1800 * rng.random()
    f2 = 100 + 500 * rng.random()
    base = (0.6 * np.sin(2 * np.pi * f1 * t)
            + 0.25 * np.sin(2 * np.pi * f2 * t + rng.random() * 6)
            + 0.02 * rng.standard_normal(n))
    env = 0.55 + 0.45 * np.sin(2 * np.pi * (0.1 + 0.3 * rng.random()) * t)
    base *= env
    for s in rng.integers(0, max(n - 2000, 1), size=int(seconds * 2)):
        base[s:s + 800] += 0.5 * np.sign(
            np.sin(2 * np.pi * 37 * t[:800])) * np.exp(-t[:800] * 400)
    x = np.stack([base, np.roll(base, int(rng.integers(5, 50)))])
    return np.clip(np.rint(x * 20000), -32768, 32767).astype(np.int32)


def encode_track(job: tuple) -> bytes:
    """(seed, seconds) -> the FLAC bytes of make_track; runs in a pool
    worker."""
    from ._host import encode_flac

    seed, seconds = job
    return encode_flac(make_track(seconds, RATE, seed), RATE, 16)


def flac_streams(S: int, seconds: float) -> list:
    return bench_secondary.built([(7 + i, seconds) for i in range(S)],
                                 encode_track)


def aac_group0_vs_f64(streams: list, device) -> tuple:
    """The first AAC-LC serving group decoded on ``device`` against the
    float64 reference of the same wire (``synthesis.
    decode_chunk_zz_reference``): (rms, max) error in LSB."""
    import torch

    from .codecs.aac import serving, synthesis

    gen = serving.iter_groups(streams, bench_secondary.GROUP["aac_lc"])
    try:
        planes, _ = next(gen)
    finally:
        gen.close()
    SC = 2 * len(streams)
    consts = synthesis.device_constants(planes["rate_index"], device=device)
    pcm, _ = synthesis.decode_planes(
        serving.to_device(planes, device),
        torch.zeros((SC, 1024), device=device), consts)
    ref, _ = synthesis.decode_chunk_zz_reference(
        *(planes[k] for k in synthesis.ZZ_PLANES), None,
        *(planes[k] for k in synthesis.ZZ_PLANES_AFTER_ESC),
        np.zeros((SC, 1024), np.float32), consts[-1].cpu().numpy(),
        *(planes[k] for k in synthesis.TNS_PLANES))
    d = pcm.cpu().numpy() - ref
    return float(np.sqrt((d ** 2).mean())), float(np.abs(d).max())


def run(n_flac: int = 16, n_aac: int = 48, seconds: float = 30.0,
        passes: int = 32, smoke: bool = False, device="cuda") -> tuple:
    """The headline: (exit code, the JSON line as a dict)."""
    from . import _kernels
    from .codecs.aac import serving as aac_serving
    from .codecs.flac import serving as flac_serving

    dev = _kernels.checked_device(device)
    line = {"metric": "flac_aac_decode_realtime_x", "value": 0.0,
            "unit": "x_realtime", "vs_baseline": 0.0, "backend": dev.type,
            "card": bench_secondary.card_line(dev), "flac_streams": n_flac,
            "aac_streams": n_aac, "seconds": seconds,
            "aac_content": AAC_CONTENT, "planes": "sized per group",
            "frames_per_group": {"flac": bench_secondary.GROUP["flac"],
                                 "aac": bench_secondary.GROUP["aac_lc"]}}
    flac = flac_streams(n_flac, seconds)
    aac = bench_secondary.aac_streams(n_aac, seconds)
    empty = [name for name, streams in (("flac", flac), ("aac", aac))
             if not streams or not all(streams)]
    if empty:
        line["error"] = f"no content for the {' and '.join(empty)} half"
        return 1, line
    _kernels.require_full_fp32(dev)

    def one_pass() -> tuple:
        t0 = time.perf_counter()
        f = flac_serving.decode_flac_streams_device(
            flac, bench_secondary.GROUP["flac"], device=dev)
        a = aac_serving.decode_aac_streams_device(
            aac, bench_secondary.GROUP["aac_lc"], device=dev)
        return time.perf_counter() - t0, f, a

    one_pass()                                              # warm
    walls = []
    for _ in range(max(1, passes)):
        wall, f_out, a_out = one_pass()
        walls.append(wall)
    fa = sum(o.shape[1] for o in f_out) / RATE
    aa = sum(o.shape[1] for o in a_out) / RATE
    value = (fa + aa) / min(walls)
    line.update(value=value, vs_baseline=value / BASELINE_X,
                flac_audio_s=fa, aac_audio_s=aa, wall_s=min(walls),
                wall_median_s=float(np.median(walls)),
                passes_completed=len(walls))
    if fa <= 0 or aa <= 0:
        line["error"] = "a half decoded no audio"
        return 1, line
    ok = True
    if smoke:
        track = make_track(seconds, RATE, 7)
        line["bit_exact_flac"] = bool(f_out[0].shape == track.shape
                                      and np.array_equal(f_out[0], track))
        rms, mx = aac_group0_vs_f64(aac, dev)
        line.update(aac_rms_vs_f64=rms, aac_max_vs_f64=mx)
        ok = line["bit_exact_flac"] and rms <= 0.25 and mx <= 1.0
    else:
        fp = bench_secondary.floor_probe(passes=2, device=dev)
        line.update(secondary_floor=fp["floor"],
                    secondary_codecs=fp["codecs"])
    return (0 if ok else 1), line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ohpipeline_tpu_torch.bench",
        description="FLAC + AAC-LC decoded seconds per wall second on the "
                    "card (the port's headline bench)")
    ap.add_argument("--flac-streams", type=int, default=16)
    ap.add_argument("--aac-streams", type=int, default=48)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--passes", type=int, default=32)
    ap.add_argument("--smoke", action="store_true",
                    help="2 + 2 streams of 4 s, 1 pass, with the FLAC "
                         "bit-exact and AAC float64 gates")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    ap.add_argument("--secondary", action="store_true",
                    help="the per-codec sweep (bench_secondary.main)")
    ap.add_argument("--all-codecs", action="store_true",
                    help="every serving call at once, one thread each")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if args.secondary:
        line = bench_secondary.main(device=device)
        line.update(backend=device,
                    card=bench_secondary.card_line(device))
        print(json.dumps(line))
        return 0
    if args.all_codecs:
        r = bench_secondary.all_codecs_bench(device=device)
        line = {"metric": "all_codecs_realtime_x",
                "value": r.pop("all_codecs_realtime_x"),
                "unit": "x_realtime", **r, "backend": device,
                "card": bench_secondary.card_line(device)}
        print(json.dumps(line))
        return 0
    if args.smoke:
        args.flac_streams, args.aac_streams = 2, 2
        args.seconds, args.passes = 4.0, 1
    rc, line = run(args.flac_streams, args.aac_streams, args.seconds,
                   args.passes, smoke=args.smoke, device=device)
    print(json.dumps(line))
    return rc


if __name__ == "__main__":
    sys.exit(main())
