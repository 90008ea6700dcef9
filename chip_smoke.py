#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (ohpipeline_tpu_torch) on one NVIDIA
GPU.

    python3 chip_smoke.py          # from the repository root, no arguments

Phases, each ending in torch.cuda.synchronize():
  0. encode the content (16 CD-quality stereo streams and 2 at 24-bit/96 kHz)
     with the in-repo FLAC encoder, in a spawned process pool, before any
     tensor or kernel touches the card;
  1. print the card (nvidia-smi), whether triton imports, where nvcc is, and
     build the kernels of ohpipeline_tpu_torch/csrc with nvcc for sm_90a;
  2. LPC kernel against its plain PyTorch version on the card, bit-exact,
     at one serving group's shape (1152 rows x 4096: orders 0-32, shifts
     0-31, 24-bit rows, worst-case accumulators); both timed with CUDA
     events;
  3. rice kernel against its plain version, bit-exact, on the parser's wire
     planes of the first serving group; both timed;
  4. the serving path decode_flac_streams_device(device="cuda") over all 18
     streams, bit-exact against the encoder input, with both kernels'
     launch counts taken from that run alone;
  5. the flagship step entry("cuda") against entry("cpu"), bit-exact.

Any failure raises and exits non-zero; so does a machine without a CUDA
device, before anything is built.  The last two lines printed are the
kernels' JSON record and {"ok": true, "device": {...}}.  Imports no JAX.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CD_SEEDS = tuple(range(7, 23))        # 16 distinct CD-quality streams
CD_SECONDS = 8.0
HIRES_SEEDS = (101, 102)              # 2 streams at 24-bit / 96 kHz
HIRES_SECONDS = 3.7                   # as many 4096-sample frames as 8 s CD
FRAMES_PER_GROUP = 32


def fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def make_track(seconds: float, rate: int = 44100, seed: int = 7):
    """bench.py's content: tones + noise + transients, per-seed
    frequencies and envelopes, 16-bit stereo."""
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


def encode_job(job: tuple) -> tuple:
    """(seed, seconds, rate, bits) -> (track, FLAC bytes); runs in a pool
    worker."""
    from ohpipeline_tpu_torch._host import encode_flac

    seed, seconds, rate, bits = job
    track = make_track(seconds, rate, seed)
    if bits == 24:      # 16-bit content scaled up, with live low bits
        dither = np.random.default_rng(seed).integers(-128, 128, track.shape)
        track = (track * 256 + dither).astype(np.int32)
    return track, encode_flac(track, rate, bits)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def lpc_case(seed=0, B=1152, N=4096):
    """One serving group's shape: orders 0-32, shifts 0-31, stable 17- and
    25-bit rows, and 5% worst-case rows (max warm-up against max coeffs)."""
    rng = np.random.default_rng(seed)
    half = (1 << (rng.choice([17, 25], B) - 1))[:, None]
    data = rng.integers(-half, half, (B, N)).astype(np.int32)
    order = rng.integers(0, 33, B).astype(np.int32)
    shift = rng.integers(0, 32, B).astype(np.int32)
    c = rng.integers(-(1 << 14), 1 << 14, (B, 32)).astype(np.float64)
    c[np.arange(32)[None, :] >= order[:, None]] = 0
    gain = np.abs(c).sum(1) / np.exp2(shift)
    c = np.trunc(c * np.minimum(1.0, 0.9 / np.maximum(gain, 1e-9))[:, None])
    coeffs = c.astype(np.int32)
    worst = rng.random(B) < 0.05
    data[worst, :32] = ((rng.integers(0, 2, (worst.sum(), 32)) * 2 - 1)
                        * ((1 << 24) - 1))
    coeffs[worst] = ((rng.integers(0, 2, (worst.sum(), 32)) * 2 - 1)
                     * ((1 << 14) - 1))
    order[worst], shift[worst] = 32, 15
    return data, coeffs, shift, order


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "ohpipeline_tpu_torch")):
        fail("the ohpipeline_tpu_torch package is missing; run from the "
             "repository root")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False); this "
             "smoke test runs the port on an NVIDIA GPU")

    # --- phase 0: content, encoded in spawned workers ----------------------
    t0 = time.perf_counter()
    jobs = ([(s, CD_SECONDS, 44100, 16) for s in CD_SEEDS]
            + [(s, HIRES_SECONDS, 96000, 24) for s in HIRES_SEEDS])
    with mp.get_context("spawn").Pool(min(len(jobs), os.cpu_count() or 1)) \
            as pool:
        encoded = pool.map(encode_job, jobs)
    tracks = [t for t, _ in encoded]
    streams = [b for _, b in encoded]
    audio_s = sum(t.shape[1] / rate for t, (_, _, rate, _) in
                  zip(tracks, jobs))
    print(f"phase 0: encoded {len(streams)} streams, {audio_s:.1f} s of "
          f"audio, {sum(map(len, streams))} bytes in "
          f"{time.perf_counter() - t0:.1f} s")

    # --- phase 1: card, toolchain, kernel build ----------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card_line = smi[0]
    from ohpipeline_tpu_torch import _kernels
    from ohpipeline_tpu_torch.codecs import flac
    from ohpipeline_tpu_torch.codecs.flac import rice
    from ohpipeline_tpu_torch.codecs.flac.serving import (
        decode_flac_streams_device, iter_groups)
    from ohpipeline_tpu_torch.entry import entry
    from ohpipeline_tpu_torch.ops import lpc

    try:
        import triton
        triton_note = f"triton {triton.__version__}"
    except ImportError as e:
        triton_note = f"no triton ({e})"
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{triton_note}; nvcc {_kernels.find_nvcc()}; "
          f"g++ {shutil.which('g++')}")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _kernels.library()
    torch.cuda.synchronize()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s "
          f"({' '.join(_kernels.NVCC_FLAGS)})")
    for line in _kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")

    # --- phase 2: LPC kernel vs plain, one serving group's shape -----------
    lpc_args = [torch.from_numpy(a).to(dev) for a in lpc_case()]
    got = lpc.lpc_synthesize(*lpc_args)
    want = lpc.lpc_synthesize_torch(*lpc_args)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.shape == want.shape
    lpc_err = int((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"lpc kernel != plain (max |err| {lpc_err})")
    lpc_ms = cuda_ms(lambda: lpc.lpc_synthesize(*lpc_args), 20)
    lpc_plain_ms = cuda_ms(lambda: lpc.lpc_synthesize_torch(*lpc_args), 2)
    B, N = lpc_args[0].shape
    print(f"phase 2: lpc {B}x{N} bit-exact; kernel {lpc_ms:.4f} ms, plain "
          f"{lpc_plain_ms:.2f} ms")

    # --- phase 3: rice kernel vs plain on real wire planes -----------------
    planes, _meta = next(iter_groups(streams, FRAMES_PER_GROUP))
    t = flac.to_device(planes, dev)
    lanes = rice.unit_lanes(*(t[k] for k in flac.RICE_PLANES[:7]))
    got = rice.scan_units(*lanes)
    want = rice.scan_units_torch(*lanes)
    torch.cuda.synchronize()
    rice_err = int((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"rice kernel != plain (max |err| {rice_err})")
    rice_ms = cuda_ms(lambda: rice.scan_units(*lanes), 20)
    rice_plain_ms = cuda_ms(lambda: rice.scan_units_torch(*lanes), 3)
    print(f"phase 3: rice {lanes[1].shape[0]} units over "
          f"{lanes[0].shape[0] * 4} slab bytes bit-exact; kernel "
          f"{rice_ms:.4f} ms, plain {rice_plain_ms:.2f} ms")
    # the whole group pass on the card against the CPU's plain pass
    group = flac.synthesise_group_rice(*(t[k] for k in flac.RICE_PLANES), 2)
    torch.cuda.synchronize()
    assert group.device.type == "cuda"
    tc = flac.to_device(planes, "cpu")
    if not torch.equal(group.cpu(), flac.synthesise_group_rice(
            *(tc[k] for k in flac.RICE_PLANES), 2)):
        raise AssertionError("group pass on the card != plain pass on CPU")
    print(f"phase 3: group pass {tuple(group.shape)} on the card == plain "
          f"pass on the CPU")

    # --- phase 4: the serving path, bit-exact against the input ------------
    def serve():
        t0 = time.perf_counter()
        outs = decode_flac_streams_device(streams, FRAMES_PER_GROUP,
                                          device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for s, (o, tr) in enumerate(zip(outs, tracks)):
            if o.shape != tr.shape or not np.array_equal(o, tr):
                raise AssertionError(f"stream {s}: decode != encoder input")
        return wall

    first = serve()
    _kernels.reset_launches()
    wall = serve()
    counts = dict(_kernels.launches)
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel did not run on the path: {counts}")
    print(f"phase 4: {len(streams)} streams bit-exact; launches {counts}; "
          f"wall {wall:.3f} s (first call {first:.3f} s); "
          f"{audio_s / wall:.1f} decoded audio s per wall s")

    # --- phase 5: the flagship step, card against CPU ----------------------
    fn, args = entry("cuda")
    rendered, peaks = fn(*args)
    torch.cuda.synchronize()
    fn_c, args_c = entry("cpu")
    want_r, want_p = fn_c(*args_c)
    assert rendered.device.type == "cuda" and peaks.device.type == "cuda"
    if not (torch.equal(rendered.cpu(), want_r)
            and torch.equal(peaks.cpu(), want_p)):
        raise AssertionError("entry('cuda') != entry('cpu')")
    print(f"phase 5: entry step {tuple(rendered.shape)} card == cpu")

    kernels = [
        {"name": "lpc", "route": "cuda",
         "source": "ohpipeline_tpu_torch/csrc/lpc.cu",
         "replaces": "ohpipeline_tpu/ops/lpc.py:131",
         "launches": counts["lpc"], "max_abs_err": lpc_err,
         "ms": lpc_ms, "plain_ms": lpc_plain_ms},
        {"name": "rice", "route": "cuda",
         "source": "ohpipeline_tpu_torch/csrc/rice.cu",
         "replaces": "ohpipeline_tpu/codecs/flac/rice_jax.py:41",
         "launches": counts["rice"], "max_abs_err": rice_err,
         "ms": rice_ms, "plain_ms": rice_plain_ms},
    ]
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
