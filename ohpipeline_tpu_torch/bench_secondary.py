"""Decoded seconds per wall second of the codecs outside the headline's
FLAC + AAC-LC (``ohpipeline_tpu_torch.bench``): the port's counterpart of
the repository root's ``bench_secondary.py``, with its three entry points.

* :func:`floor_probe`: the four 16-stream device serving calls (CELT,
  HE-AAC v1, MP3, Vorbis), each the best of ``passes`` timed calls after a
  warm one; ``floor`` is the least of them.  The headline folds it in.
* :func:`all_codecs_bench`: the six serving calls (FLAC 8 streams, AAC-LC
  8, HE-AAC 16, CELT 16, MP3 16, Vorbis 16) at once, one thread each;
  total decoded seconds over the pass's wall, best of ``passes``.
* :func:`main`: the per-codec sweep (``python -m ohpipeline_tpu_torch.bench
  --secondary``): the host plug-ins and the serving calls of every codec
  whose content the repository can make.  SILK, hybrid and ALAC content
  needs encoders the repository does not hold; those codecs are reported
  under ``absent``.

Content, ``BENCH2_SECONDS`` (default 20) seconds a stream: MP3 and Vorbis
streams from the port's encoder copies with the reference bench's
generators (seeds 300 + i and 100 + i; the sweep's single streams seeds 3
and 7), FLAC from its ``_content`` signal (blocksize 1024); CELT, HE-AAC and
AAC-LC by tiling ``tests/assets/dryrun.opus``, ``dryrun_he.aac`` and
``dryrun.aac`` (stream s starts at its own frame, at an SBR header for
HE-AAC), since the repository has no Opus or AAC encoder.  Encoded content
is cached under ``.bench_cache/torch/``; nothing else is written.

Decoded seconds are per-channel output samples over the output rate,
summed over streams: HE-AAC counts at its output rate (twice the core's),
CELT at 48 kHz.  A failing call raises with its own type; no codec is
reported as a number in place of an error.
"""

from __future__ import annotations

import hashlib
import math
import multiprocessing as mp
import os
import pathlib
import subprocess
import threading
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
ASSETS = ROOT / "tests" / "assets"
CACHE = ROOT / ".bench_cache" / "torch"
#: Seconds a stream of the secondary benches (``BENCH2_SECONDS``, default
#: 20, as the reference's); read when a bench runs.
SECONDS = float(os.environ.get("BENCH2_SECONDS", "20"))
#: The codecs of the reference sweep whose content needs an encoder the
#: repository does not hold.
ABSENT = ("opus_silk_wb", "opus_silk_stereo", "opus_hybrid", "alac")
#: frames (blocks for Vorbis) a group of each serving call: the reference
#: serving calls' defaults.
GROUP = {"flac": 32, "aac_lc": 64, "he_aac": 48, "celt": 32, "mp3": 32,
         "vorbis": 64}
#: floor_probe's keys, the reference probe's names, and their paths.
FLOOR_PATHS = {"opus_celt_16stream_device": "celt",
               "he_aac_16stream_device": "he_aac",
               "mp3_16stream_device": "mp3",
               "vorbis_16stream_device": "vorbis"}
ALL_CODECS_WIDTHS = {"flac": 8, "aac_lc": 8, "he_aac": 16, "celt": 16,
                     "mp3": 16, "vorbis": 16}


def card_line(device) -> str | None:
    """The card's ``nvidia-smi --query-gpu=name,power.limit`` line for a
    CUDA device, None for another."""
    import torch

    if torch.device(device).type != "cuda":
        return None
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


# --- content -----------------------------------------------------------------

def _content(seconds: float, rate: int = 44100, stereo: bool = True):
    """The reference sweep's signal (``bench_secondary.py:41-51``)."""
    t = np.arange(int(rate * seconds)) / rate
    rng = np.random.default_rng(23)
    x = (np.sin(2 * np.pi * 523 * t) * 9000
         * (0.6 + 0.4 * np.sin(2 * np.pi * 0.9 * t))
         + np.sin(2 * np.pi * 3200 * t) * 3000
         + rng.standard_normal(len(t)) * 900)
    x = np.clip(x, -32000, 32000)
    if stereo:
        return np.stack([x, np.roll(x, 29)]).astype(np.int16)
    return x[None, :].astype(np.int16)


def flac_stream(i: int, seconds: float) -> bytes:
    """All-codecs FLAC stream i (``bench_secondary.py:231-239``)."""
    from ._host import encode_flac

    pcm = np.roll(_content(seconds, 44100, stereo=True), 13 * i, axis=1)
    return encode_flac(pcm, 44100, 16, blocksize=1024)


def _mp3_frames(rng, nframes: int) -> list:
    from ._host import mp3_encoder

    frames = []
    for _ in range(nframes):
        spec = np.zeros((2, 576), np.int32)
        m = rng.random((2, 576)) < 0.25
        spec[m] = rng.integers(1, 12, m.sum())
        frames.append(mp3_encoder.build_frame(
            [spec[0], spec[1]], global_gain=int(rng.integers(174, 184))))
    return frames


def mp3_stream(i: int, seconds: float) -> bytes:
    """16-stream MP3 stream i (``bench_secondary.py:150-163``): stereo
    MPEG-1 frames, 25% of the lines at 1-11, global gain 174-183, seed
    300 + i."""
    rng = np.random.default_rng(300 + i)
    return b"".join(_mp3_frames(rng, int(seconds * 44100 / 1152)))


def mp3_sweep_stream(seconds: float) -> bytes:
    """The sweep's single MP3 stream (``bench_secondary.py:448-455``): one
    seed-3 spectrum repeated."""
    from ._host import mp3_encoder

    rng = np.random.default_rng(3)
    spec = np.zeros((2, 576), np.int32)
    m = rng.random((2, 576)) < 0.25
    spec[m] = rng.integers(1, 12, m.sum())
    return mp3_encoder.build_stream([spec[0], spec[1]],
                                    nframes=int(seconds * 44100 / 1152))


def _vorbis_build(seed: int, seconds: float) -> bytes:
    from ._host import vorbis_encoder

    rng = np.random.default_rng(seed)
    spec = vorbis_encoder.StreamSpec(channels=2, sample_rate=44100, bs0=256,
                                     bs1=1024, coupling=True)
    blocks = []
    for _ in range(int(seconds * 44100 / 512)):
        r = np.zeros((2, 512), np.int64)
        m = rng.random((2, 512)) < 0.3
        r[m] = rng.integers(-2, 3, m.sum())
        blocks.append((1, [(140, 120)] * 2, r))
    return spec.build(blocks)


def vorbis_stream(i: int, seconds: float) -> bytes:
    """16-stream Vorbis stream i (``bench_secondary.py:177-189``): bs
    256/1024, all long blocks, coupling, 30% of the residues at -2..2,
    floor posts (140, 120), seed 100 + i."""
    return _vorbis_build(100 + i, seconds)


def vorbis_sweep_stream(seconds: float) -> bytes:
    """The sweep's single Vorbis stream (``bench_secondary.py:476-490``),
    seed 7."""
    return _vorbis_build(7, seconds)


_BUILDERS = {"flac": flac_stream, "mp3": mp3_stream, "vorbis": vorbis_stream,
             "mp3_sweep": mp3_sweep_stream,
             "vorbis_sweep": vorbis_sweep_stream}


def build_job(job: tuple) -> bytes:
    """(kind, *args) -> the encoded stream; runs in a pool worker."""
    kind, *args = job
    return _BUILDERS[kind](*args)


def built(jobs: list, fn=build_job) -> list:
    """``fn(job)`` (bytes) for each job, from the cache under
    ``.bench_cache/torch/`` or built in a spawned process pool and cached
    (through a temporary name and a rename)."""
    def path(job):
        key = hashlib.sha1(f"{fn.__module__}.{fn.__name__}:{job!r}".encode())
        return CACHE / f"{key.hexdigest()}.bin"

    out = [path(j).read_bytes() if path(j).exists() else None for j in jobs]
    miss = [k for k, b in enumerate(out) if b is None]
    if miss:
        with mp.get_context("spawn").Pool(
                min(len(miss), os.cpu_count() or 1, 8)) as pool:
            made = pool.map(fn, [jobs[k] for k in miss])
        CACHE.mkdir(parents=True, exist_ok=True)
        for k, data in zip(miss, made):
            p = path(jobs[k])
            tmp = p.with_suffix(f".{os.getpid()}.tmp")
            tmp.write_bytes(data)
            os.replace(tmp, p)
            out[k] = data
    return out


def read_asset(name: str) -> bytes:
    return (ASSETS / name).read_bytes()


def _adts_frames(data: bytes) -> list:
    from ._host import aac_bitstream

    frames, pos = [], 0
    while pos < len(data):
        h = aac_bitstream.parse_adts_header(data, pos)
        if h is None:
            break
        frames.append(data[pos:pos + h.frame_bytes])
        pos += h.frame_bytes
    return frames


def _tiled(units: list, start: int, n: int) -> list:
    """n units from ``start`` on, cycling through ``units`` (none if there
    are none)."""
    return [units[(start + k) % len(units)] for k in range(n)] if units \
        else []


def aac_streams(S: int, seconds: float) -> list:
    """S AAC-LC streams tiled from dryrun.aac to ``seconds`` each: stream s
    starts at frame s (mod the asset's frame count) and cycles through the
    asset, as ``chip_smoke.aac_streams`` lays it out."""
    frames = _adts_frames(read_asset("dryrun.aac"))
    n = math.ceil(seconds * 44100 / 1024)
    return [b"".join(_tiled(frames, s, n)) for s in range(S)]


#: frames between the SBR headers of dryrun_he.aac
HE_HEADER_EVERY = 10


def he_streams(S: int, seconds: float) -> list:
    """S HE-AAC v1 streams tiled from dryrun_he.aac to ``seconds`` of
    output each: stream s starts at the SBR header of frame 10 * (s mod
    the number of headers) and cycles through the asset, as
    ``chip_smoke.he_streams`` lays it out."""
    frames = _adts_frames(read_asset("dryrun_he.aac"))
    cuts = len(frames) // HE_HEADER_EVERY + 1
    n = math.ceil(seconds * 22050 / 1024)
    return [b"".join(_tiled(frames, HE_HEADER_EVERY * (s % cuts), n))
            for s in range(S)]


def celt_streams(S: int, seconds: float) -> list:
    """S CELT streams tiled from dryrun.opus to ``seconds`` each: its
    OpusHead and OpusTags packets, then its 20 ms audio packets from packet
    3 s (mod 50) on, cycling, paged with the port's ``build_pages``, as
    ``chip_smoke.celt_streams`` lays them out."""
    from ._host import base, ogg

    data = read_asset("dryrun.opus")
    if not data:
        return [b""] * S
    head, tags, *audio = ogg.OggReader(base.BufferReader(data)).packets()
    n = math.ceil(seconds * 50)
    out = []
    for s in range(S):
        pk = _tiled(audio, 3 * s, n)
        out.append(ogg.build_pages(s + 1, [head], bos=True)
                   + ogg.build_pages(s + 1, [tags], first_sequence=1)
                   + ogg.build_pages(s + 1, pk, first_sequence=2,
                                     granule=960 * len(pk), eos=True))
    return out


# --- the serving calls ----------------------------------------------------

def per_rate(rate: int):
    """Decoded seconds of a [(channels, n) PCM] list at ``rate``."""
    return lambda outs: sum(o.shape[1] for o in outs) / rate


def celt_seconds(out) -> float:
    """Decoded seconds of the CELT call's (S, channels, n) PCM, at 48 kHz."""
    return out.shape[0] * out.shape[2] / 48000.0


def he_output_rate(streams: list) -> int:
    """The HE-AAC v1 output rate: twice the ADTS core rate."""
    from ._host import aac_bitstream

    return 2 * aac_bitstream.parse_adts_header(streams[0]).sample_rate


def serving_jobs(widths: dict, device, seconds: float) -> dict:
    """name -> (streams, call, audio_of) for each serving call named in
    ``widths`` (name -> stream count), its content made (or read from the
    cache) first: ``call(streams)`` decodes on ``device`` and returns PCM on
    the host, ``audio_of`` its decoded seconds.  The calls are looked up
    when they run."""
    from .codecs.aac import serving as aac_serving
    from .codecs.flac import serving as flac_serving
    from .codecs.mp3 import serving as mp3_serving
    from .codecs.opus import celt
    from .codecs.vorbis import device as vorbis_device

    kinds = [k for k in ("flac", "mp3", "vorbis") if k in widths]
    made = iter(built([(k, i, seconds) for k in kinds
                       for i in range(widths[k])]))
    streams = {k: [next(made) for _ in range(widths[k])] for k in kinds}
    if "aac_lc" in widths:
        streams["aac_lc"] = aac_streams(widths["aac_lc"], seconds)
    if "he_aac" in widths:
        streams["he_aac"] = he_streams(widths["he_aac"], seconds)
    if "celt" in widths:
        streams["celt"] = celt_streams(widths["celt"], seconds)
    calls = {
        "flac": (lambda s: flac_serving.decode_flac_streams_device(
            s, GROUP["flac"], device=device), lambda s: per_rate(44100)),
        "aac_lc": (lambda s: aac_serving.decode_aac_streams_device(
            s, GROUP["aac_lc"], device=device), lambda s: per_rate(44100)),
        "he_aac": (lambda s: aac_serving.decode_he_streams_device(
            s, GROUP["he_aac"], device=device),
            lambda s: per_rate(he_output_rate(s))),
        "celt": (lambda s: celt.decode_celt_streams_device(
            s, GROUP["celt"], device=device), lambda s: celt_seconds),
        "mp3": (lambda s: mp3_serving.decode_mp3_streams_device(
            s, GROUP["mp3"], device=device), lambda s: per_rate(44100)),
        "vorbis": (lambda s: vorbis_device.decode_vorbis_streams_device(
            s, GROUP["vorbis"], device=device), lambda s: per_rate(44100)),
    }
    out = {}
    for name in widths:
        if not all(streams[name]):
            raise ValueError(f"{name}: an empty stream (no content)")
        call, audio_of = calls[name]
        out[name] = (streams[name], call, audio_of(streams[name]))
    return out


def best_rate(run, audio_of, passes: int) -> float:
    """Decoded seconds per wall second of the best of ``passes`` timed
    ``run()`` calls; each call ends with its PCM on the host."""
    best, audio = math.inf, 0.0
    for _ in range(max(1, passes)):
        t0 = time.perf_counter()
        out = run()
        best = min(best, time.perf_counter() - t0)
        audio = audio_of(out)
    if audio <= 0:
        raise ValueError("a timed call decoded no audio")
    return audio / best


def floor_probe(passes: int = 2, device="cuda") -> dict:
    """The four 16-stream device serving paths (the reference's
    ``floor_probe``), :data:`SECONDS` a stream: {"codecs": {name: decoded s
    per wall s}, "floor": the least}.  Each is the best of ``passes`` timed
    calls after a warm call; a failing call raises."""
    from . import _kernels

    _kernels.checked_device(device)
    jobs = serving_jobs({FLOOR_PATHS[k]: 16 for k in FLOOR_PATHS}, device,
                        SECONDS)
    codecs = {}
    for key, name in FLOOR_PATHS.items():
        streams, call, audio_of = jobs[name]
        call(streams)                                       # warm
        codecs[key] = best_rate(lambda: call(streams), audio_of, passes)
    return {"codecs": codecs, "floor": min(codecs.values())}


def all_codecs_bench(passes: int = 3, device="cuda") -> dict:
    """Every serving call at once on one device, one thread each (the
    reference's ``all_codecs_bench``): FLAC and AAC-LC at 8 streams, HE-AAC,
    CELT, MP3 and Vorbis at 16, :data:`SECONDS` a stream.  After a warm call
    of each, ``passes`` passes; a pass starts every thread, joins them and,
    if a call raised, re-raises the first exception (in the order above)
    with its own type.
    Returns the best pass: {"all_codecs_realtime_x": total decoded s / wall
    s, "audio_s_total", "wall_s", "wall_median_s", "per_codec_audio_s",
    "passes"}."""
    from . import _kernels

    _kernels.checked_device(device)
    jobs = serving_jobs(ALL_CODECS_WIDTHS, device, SECONDS)
    for streams, call, _ in jobs.values():
        call(streams)                                       # warm

    def one_pass() -> tuple:
        audio, errors = {}, {}

        def run(name, streams, call, audio_of):
            try:
                audio[name] = audio_of(call(streams))
            except BaseException as e:      # handed to the caller below
                errors[name] = e

        threads = [threading.Thread(target=run, args=(name, *job))
                   for name, job in jobs.items()]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if errors:
            first = next(n for n in jobs if n in errors)
            raise errors[first]
        return sum(audio.values()), wall, audio

    best, walls = None, []
    for _ in range(max(1, passes)):
        total, wall, audio = one_pass()
        walls.append(wall)
        if best is None or total / wall > best["all_codecs_realtime_x"]:
            best = {"all_codecs_realtime_x": total / wall,
                    "audio_s_total": total, "wall_s": wall,
                    "per_codec_audio_s": audio}
    best.update(wall_median_s=float(np.median(walls)), passes=len(walls))
    return best


# --- the per-codec sweep --------------------------------------------------

def _codec_decode(make_codec, data: bytes) -> np.ndarray:
    """A whole stream through a codec plug-in (recognise, initialise,
    process to the end) -> (channels, n) PCM."""
    from .host.codecs.base import BufferReader, EndOfStream

    codec = make_codec()
    reader = BufferReader(data)
    if not codec.recognise(reader.peek(8192)):
        raise ValueError(f"{type(codec).__name__} does not recognise the "
                         f"stream")
    codec.stream_initialise(reader)
    parts = []
    try:
        while True:
            parts.append(codec.process(reader).resolve())
    except EndOfStream:
        pass
    return np.concatenate(parts, axis=1)


def main(device="cuda", passes: int = 3) -> dict:
    """The per-codec sweep of the reference's ``main``, :data:`SECONDS` a
    stream: each codec's decoded seconds per wall second, best of
    ``passes`` after a warm call.
    Returns the line {"metric": "secondary_codecs_realtime_x", "codecs",
    "floor", "all_above_realtime", "absent", ...}."""
    from . import _kernels
    from .codecs.aac import CodecAacAdts
    from .codecs.mp3 import decode_mp3
    from .host.codecs.opus import decode_opus
    from .host.codecs.vorbis import decode_vorbis

    _kernels.checked_device(device)
    seconds = SECONDS
    mp3_one, vorbis_one = built([("mp3_sweep", seconds),
                                 ("vorbis_sweep", seconds)])
    celt_one = celt_streams(1, seconds)[0]
    he_one = he_streams(1, seconds)[0]
    he_rate = he_output_rate([he_one])
    host = {
        "opus_celt_stereo": (lambda: decode_opus(celt_one)[1],
                             lambda pcm: pcm.shape[1] / 48000.0),
        "he_aac_v1_device_sbr": (
            lambda: _codec_decode(lambda: CodecAacAdts(device=device),
                                  he_one),
            lambda pcm: pcm.shape[1] / he_rate),
        "mp3": (lambda: decode_mp3(mp3_one, device=device)[1],
                lambda pcm: pcm.shape[1] / 44100.0),
        "vorbis": (lambda: decode_vorbis(vorbis_one)[1],
                   lambda pcm: pcm.shape[1] / 44100.0),
    }
    jobs = serving_jobs({FLOOR_PATHS[k]: 16 for k in FLOOR_PATHS}, device,
                        seconds)
    device_runs = {key: (lambda j=jobs[name]: j[1](j[0]), jobs[name][2])
                   for key, name in FLOOR_PATHS.items()}
    order = ("opus_celt_stereo", "opus_celt_16stream_device",
             "he_aac_v1_device_sbr", "he_aac_16stream_device", "mp3",
             "mp3_16stream_device", "vorbis", "vorbis_16stream_device")
    runs = {**host, **device_runs}
    codecs = {}
    for name in order:
        run, audio_of = runs[name]
        run()                                               # warm
        codecs[name] = best_rate(run, audio_of, passes)
    return {"metric": "secondary_codecs_realtime_x", "codecs": codecs,
            "floor": min(codecs.values()),
            "all_above_realtime": min(codecs.values()) >= 1.0,
            "absent": {name: "no content in the repository"
                       for name in ABSENT},
            "seconds": seconds}
