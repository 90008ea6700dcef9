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
     0-31, 24-bit rows, worst-case accumulators) and on the rows of the
     first serving group (captured from the group pass, as phase 3 takes
     its planes; almost all order 8); both timed with CUDA events;
  3. rice kernel against its plain version, bit-exact, on the parser's wire
     planes of the first serving group and on a worst case (rice_worst_case:
     every rice k 0-30 with quotients 0-16, codewords past the 32-bit
     window, verbatim widths 0-32, every start phase, walks past the slab's
     last word, a negative cursor, counts 0, 1, 63 and 64); all timed; then
     the group pass on the card against the CPU's;
  4. the serving path decode_flac_streams_device(device="cuda") over all 18
     streams, bit-exact against the encoder input, with both kernels'
     launch counts taken from that run alone;
  5. the flagship step entry("cuda") against entry("cpu"), bit-exact; and
     ops.pcm to_float, attenuate and bit_depth_convert on the card against
     the CPU, bit for bit, over rows of bit depths 8, 16, 24 and 32;
  6. TNS kernel on the card against the float64 reference (max |err| <=
     1e-5 of each row's peak) and against its plain version (<= 1e-5 of the
     row's peak, unless the plain version is the further of the two from
     float64), on the first AAC serving group's TnsPool
     planes, on a worst case (1024 rows, every one of the 24 filter slots in
     use, order 12, both directions) and on filters with every reflection
     coefficient at the encoder's limits (seeds 100-105); all timed;
  7. the AAC-LC serving path decode_aac_streams_device(device="cuda") at
     the width of bench.py's headline: 48 streams cut from
     tests/assets/dryrun.aac (stream s: the asset from frame s onward, then
     the whole asset 3 more times, ~8 s each), 64 frames per group (6144
     rows of 1024 coefficients per device pass).  Group 0 is held to the
     float64 reference (rms <= 0.25, max <= 1 LSB), the first 8 streams to
     the same call on the CPU (<= 1 LSB), and the TNS kernel's launch count
     is taken from a warm call alone;
  8. SBR envelope kernel against its plain version on the card, bit for
     bit, on the scan inputs of the first HE-AAC serving group (captured
     from phase 9's first call), on a worst case (every slot active,
     smoothing against in-frame envelopes and the carry, carried slots,
     sine and noise on, noise and sine made from counters) at 24 and at 40
     bins, on a case whose carried filt comes from far back (few last
     envelopes) and on one with carried and inactive slots everywhere;
     all timed;
  9. the HE-AAC v1 serving path decode_he_streams_device(device="cuda") at
     the width of the JAX package's HE serving cell (16 streams, 48 frames
     per group): stream s is tests/assets/dryrun_he.aac from frame
     10 * (s mod 5) onward (an SBR header comes every 10 frames), then the
     whole asset 3 + s // 5 more times.  The first 4 streams are held to the
     same call on the CPU (<= 2 LSB), stream 0's first group to sbr.py's
     numpy SbrDecoder chain fed the same core PCM (max error < 2e-3 of the
     peak, rms error < 5e-4 of the rms), and the sbr_env and TNS launch
     counts are taken from a warm call alone;
 10. CELT comb post-filter kernel against its plain version on the card, bit
     for bit (max |err| 0), on the first CELT serving group's rows (captured
     from phase 11's first call), on a worst case (16 streams x 32
     frames, every frame filtered, lags 15 and 1024, tapsets 0 -> 1 -> 2
     crossfading) and on lags 33-35 and 66-67 (runs either side of one and
     two warp widths); all timed;
 11. the CELT serving path decode_celt_streams_device(device="cuda") at the
     width of the JAX package's CELT serving cell (16 stereo streams, 32
     frames per group): stream s is tests/assets/dryrun.opus's header
     packets, its audio packets from frame 3 s on, then all 50 packets 3
     more times, paged again with the port's build_pages.  The first 4
     streams are held to the same call on the CPU (<= 1 LSB), stream 0 to
     the host celt.py decode (<= 2 LSB, >= 70 dB), and the celt_comb launch
     count is taken from a warm call alone;
 12. build the MP3 and Vorbis content in a spawned process pool (the port's
     encoder copies): bench_secondary.py's 16 MP3 streams (8 s each), 4
     MPEG-1 and 4 MPEG-2 LSF streams whose frames cycle through long,
     start, short and stop blocks, and 16 Vorbis streams; then the MP3
     polyphase window kernel against its plain version on the card (<= 1
     LSB; the count of samples that differ is printed) on the first MP3
     serving group's V history (captured from phase 13's first call) and
     on a worst case (broadband V saturating both clip ends, a partial
     group's zero padding, an odd channel count) at 16 and 24 bits; all
     timed, with the conv1d formulation of the same FIR as the library
     time;
 13. the MP3 serving path decode_mp3_streams_device(device="cuda") at the
     width of the JAX package's MP3 serving cell (16 stereo streams, 32
     frames per group).  The first 4 streams and the block-type and LSF
     streams are held to the same call on the CPU (<= 1 LSB); stream 0 and
     the first block-type and LSF streams to a float64 numpy run of the
     scan form of the filterbank fed the same prepare_granules spectra
     (<= 6 LSB, >= 80 dB); the mp3_window launch count is taken from a warm
     call alone;
 14. the Vorbis serving path decode_vorbis_streams_device(device="cuda") at
     the width of the JAX package's Vorbis serving cell (16 stereo streams,
     bs 256/1024, 64 blocks a group): streams 0-7 bench_secondary.py's
     all-long content, 8-15 tests/test_vorbis_device.py's mixed blocks, 8 s
     each.  The first 4 streams are held to the same call on the CPU (<= 1
     LSB), streams 0 and 8 to the host synthesis (imdct_many and Lapper,
     float64; <= 2 LSB, >= 60 dB);
 15. the parametric-stereo (HE-AAC v2) decorrelator and mixer kernel against
     its plain version ps_scan_torch on the card, bit for bit, on the first
     PS group (one stream, 3072 slots; captured from phase 16's first
     call), on a worst case (16 streams, every channel near full scale on a
     burst every 8 slots, every mixing group's matrix distinct, a seeded
     carry) and on the second of a chained pair of worst-case groups; all
     timed, with each of its three stages' device time (group powers, the
     recurrences, the mix; torch.profiler by kernel name) and the
     recurrences' stage alone as the chain floor;
 16. the ADTS codec plug-in CodecAacAdts(device="cuda") over
     tests/assets/dryrun.aac (AAC-LC) and dryrun_he.aac (HE-AAC v1; its
     groups on the spec-mode SBR runner), held to the same plug-in on the
     CPU (<= 1 and <= 2 LSB), with the sbr_env launch count of that run;
     then the PS path: 16 streams of ps_content (dryrun_he.aac's left
     channel at half level with a burst every 8 frames, the asset's SBR
     data and seeded PsData; the repository has no v2 stream) through one
     SbrPsDeviceRunner each in spec mode, 96 frames a group.  Stream 0 is
     held to the same runners on the CPU (<= 2 LSB) and to sbr.py's
     per-frame numpy process_frame_ps chain fed the same core and channel
     data (max error < 5e-3 of the peak, rms error < 1e-3 of the rms), the
     ps_mix launch count of a warm run must equal its number of groups, and
     a traced run gives the card's idle share;
 17. the render path (render_phase): phase 0's first CD stream and first
     24-bit / 96 kHz stream, as .flac files, through the port's
     PipelineManager(device="cuda").play_uri, its codec controller (the
     CodecFlac plug-in on the LPC kernel) and an AnimatorBatch, with the JAX
     end-to-end tests' params (no gorge, starvation ramper unthreaded):
     bit-exact against the encoder input, the lpc launches of a warm run
     equal to the FLAC groups the plug-in resolved, each play's warm wall
     and a traced play's idle share; the CD stream paused after 4 pulled
     events and played again once paused, so a down and an up ramp pass
     through the RenderBatcher on the card, bit for bit against the same
     run on the CPU (a non-unity tile must have been rendered);
     tests/assets/dryrun.aac and dryrun_he.aac through the pipeline, card
     against CPU (<= 1 and <= 2 LSB), sbr_env launched; a realtime
     AnimatorBasic (5 ms quanta, default params) over a 3 s cut of the CD
     track, which must end and deliver the track (late quanta printed, no
     gate); and the LPC kernel against its plain version at the render
     path's shape (the first group's rows, 32 x 4096), timed;
 18. the other plug-ins through the render path (plugin_phase): phase 13's
     first MP3 stream (8 s CBR) and the same frames behind a Xing frame
     (CodecMp3 on the mp3_window kernel), dryrun.aac's and dryrun_he.aac's
     frames in M4As (CodecAacMp4: AAC-LC, and HE-AAC with the explicit
     AOT-5 config, on the SBR kernel), phase 14's first mixed-block Vorbis
     stream, dryrun.opus and its packets in an M4A, ALAC escape frames of a
     seeded tone in an M4A and seeded SILK-mode Opus packets in Ogg (the
     host plug-ins), each through PipelineManager(device="cuda").play_uri
     and an AnimatorBatch and again on the CPU: the card within 1 LSB of
     the CPU (2 for HE-AAC, equal for the host plug-ins), ALAC equal to its
     input, mp3_window launched once a CodecMp3 group (ceil(frames / 16)),
     sbr_env on the HE file, no tns on the LC file (the plug-ins run TNS in
     their host prep); each warm play's decoded s per wall s; the Xing file
     through CodecMp3 with a seek to 4 s after 3 groups, card against CPU;
     a traced MP3 play's idle share; and the mp3_window kernel against its
     plain version at the plug-in's group shape (32 granules), timed;
 19. the multi-device layer (mesh_phase), on two meshes, each against the
     same work with no mesh on the card: make_mesh() over every visible card
     (dp 1, sp 1 on one) and the logical mesh of four entries on cuda:0
     (dp 2, sp 2).  The serving calls with mesh= over content whose
     streams all take the same number of groups (phase 0's 16 CD FLAC
     streams, phase 7's first 16 AAC-LC, phase 9's first 5 HE-AAC and phase
     13's first 8 MP3 streams): FLAC bit-exact, AAC-LC and MP3 within 1 LSB,
     HE-AAC within 2; each kernel's launches equal to the no-mesh call's
     (one a group) times dp; MESH_REPS no-mesh and mesh calls in turn,
     after a warm call, each codec's walls as median (min-max) and
     decoded s per wall s; FLAC over each mesh equal to the encoder's
     input.  The logical mesh's warm calls keep the inputs of each
     kernel's first launch (block 0, group 0: the block shapes, half the
     streams), and lpc, rice, tns, sbr_env and mp3_window are held against
     their plain versions on them at the gates of phases 2, 3, 6, 8 and
     13, and timed; an HE-AAC block's set-up (constants and runner) is
     timed for the whole batch and for a block.
     sharded_pipeline_step against the same step on a one-entry mesh
     (rendered and meters bit-exact, AAC PCM within 0.05, the Vorbis IMDCT
     within 1e-3), every room_fanout replica equal to its input, and
     room_render_grid equal to the one-entry grid; then
     dryrun_multichip(devices=MESH_LOGICAL);
 20. the Av layer (media_player_phase): a MediaPlayer(device="cuda") with
     the JAX end-to-end tests' pipeline params and Volume.Limit 100 plays a
     playlist through its Playlist source (track database inserts, then
     seek_id of the first) into an AnimatorBatch on the card, gaplessly to
     the pipeline's halt: phase 0's first CD FLAC stream, its first 24-bit
     / 96 kHz stream, phase 13's first MP3 stream and dryrun_he.aac, so the
     play crosses 44.1 -> 96 -> 44.1 kHz.  At volume 100 (unity) both FLAC
     tracks equal the encoder input; at volume 50 the volume chain's
     attenuation reaches the RenderBatcher's gain pass on the card (its
     apply_gain calls counted, one a non-unity tile), and the play is held
     to the same play on the CPU (FLAC bit for bit, MP3 <= 1 LSB, HE-AAC
     <= 2); in that play lpc launches equal the FLAC groups, mp3_window
     launches the MP3 groups (ceil(frames / 16)) and sbr_env runs; the
     pipeline announces the tracks in the database's order.  Its warm
     wall, decoded s per wall s and a traced play's idle share are
     printed.  The Radio source's play_uri of the CD file equals the
     encoder input, and a mute through the volume chain after 3 pulled
     events leaves the track up to that point and zero after it.  The LPC,
     MP3 window and SBR envelope kernels are held against their plain
     versions on the inputs of their first launch in the first play, at
     the gates of phases 2, 13 and 8, and timed;
 21. the net layer (net_phase).  (a) The control plane: a
     MediaPlayer(device="cuda") with Volume.Limit 100, an OdpServer with
     make_device(player) on 127.0.0.1 and an OdpClient, through which alone
     phase 20's CD FLAC, MP3 and HE-AAC tracks are inserted
     (Playlist.Insert), the volume set to 50 (Volume.SetVolume) and the play
     started (Playlist.SeekId); an AnimatorBatch on the card renders to the
     halt.  The play is held to phase 20's CPU play at volume 50 (FLAC bit
     for bit, MP3 <= 1 LSB, HE-AAC <= 2), lpc launches to the FLAC groups,
     mp3_window launches to the MP3 groups, sbr_env must run and the gain
     pass run on the card; the counted play's warm wall and decoded s per
     wall s are printed.  (b) Songcast: a sender MediaPlayer on the card at
     unity plays the CD FLAC and the MP3 track into an
     AnimatorSongcastSender(device="cuda", realtime=True) over a unicast
     OhmSender on 127.0.0.1, paced at its audio clock (OhmRecorder: the
     animator would send each 1.5 s FLAC group in one burst); a receiver
     MediaPlayer on the card at volume 50, its SourceReceiver joined to that
     sender, renders through AnimatorBasic(device="cuda", 5 ms quanta).  The
     sent audio (silence frames dropped) equals the encoder input for the
     FLAC track and phase 20's unity MP3 play within 1 LSB; every frame the
     receiver's OhmReceiver delivers equals the sent frame with its
     sample_start; at least 95% of the sent audio frames arrive; the
     receiver's non-zero rendered samples are at least 90% of the sent
     audio's and its rms over the audio delivered within 1% of its gain; its
     gain tiles run on the card.  Both animators' late quanta, worst
     lateness and gain tiles (count, mean host wall) are printed, and the
     host wall of the receiver's largest tile through a RenderBatcher
     alone.  (c) The
     player entry point: python -m ohpipeline_tpu_torch.tools.player on the
     first 16 frames of the CD stream (one CodecFlac group: a play of several
     groups starves its free-running render at a group boundary when the
     next group takes longer than the starvation ramper's 50 ms wait, as the
     JAX player's does, so its WAV depends on timing), once on the card and
     once with --cpu: both exit 0 and write the same WAV bytes, the track.
     (d) The LPC, MP3 window and SBR envelope kernels against their plain
     versions on the inputs of their first launch in (a)'s first play, at
     the gates of phases 2, 13 and 8, and timed.

A kernel's time is the mean of 20 launches captured in one CUDA graph
(kernel_ms: a launch from Python takes longer on the host than a short
kernel on the card); a plain version's is the mean of an eager loop between
CUDA events (cuda_ms).  Each kernel's record carries its bound: the larger
of the bytes it must move (each input read once, each output written once)
over 3.35 TB/s and its operations over 67 TFLOP/s (float32 outside the
tensor cores), the published peaks of an H100 SXM at 700 W, from this run's
inputs, whether the plays of the render path that phases 17-18 count
launched it and how often (on_render_path, render_launches), how often
phase 20's counted playlist play launched it (media_player_launches), and
phase 21 (a)'s counted play through the ODP control plane (net_launches).
No
single
PyTorch call computes the recurrences of the LPC,
rice, TNS, SBR-envelope, CELT-comb and PS kernels, so their library_ms
is null; the MP3 window pass's is the time
of one grouped conv1d (cuDNN, TF32 off) plus the pair-add, the one PyTorch
formulation of its FIR.

Float32 matrix products must run in full float32 (no TF32), which is
PyTorch's default; the script checks that the default holds before and
after the port runs.  Any failure raises and exits non-zero; so does a
machine without a CUDA device, before anything is built.  The last two
lines printed are the kernels' JSON record and {"ok": true, "device":
{...}}, after the card's name and power limit.  Imports no JAX.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import shutil
import subprocess
import sys
import tempfile
import time

from typing import Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CD_SEEDS = tuple(range(7, 23))        # 16 distinct CD-quality streams
CD_SECONDS = 8.0
HIRES_SEEDS = (101, 102)              # 2 streams at 24-bit / 96 kHz
HIRES_SECONDS = 3.7                   # as many 4096-sample frames as 8 s CD
FRAMES_PER_GROUP = 32
AAC_ASSET = os.path.join(HERE, "tests", "assets", "dryrun.aac")
AAC_STREAMS = 48                      # bench.py's headline AAC width
AAC_REPEATS = 3                       # whole-asset copies after the cut
AAC_FRAMES_PER_GROUP = 64             # the reference serving default
AAC_CPU_STREAMS = 8                   # streams held to the CPU decode
HE_ASSET = os.path.join(HERE, "tests", "assets", "dryrun_he.aac")
HE_STREAMS = 16                       # the JAX package's HE serving width
HE_FRAMES_PER_GROUP = 48
HE_HEADER_EVERY = 10                  # frames between the asset's SBR headers
HE_CPU_STREAMS = 4
CELT_ASSET = os.path.join(HERE, "tests", "assets", "dryrun.opus")
CELT_STREAMS = 16                     # the JAX package's CELT serving width
CELT_REPEATS = 3
CELT_GROUP = 32
CELT_CPU_STREAMS = 4
MP3_STREAMS = 16                      # the JAX package's MP3 serving width
MP3_SECONDS = 8.0
MP3_FRAMES_PER_GROUP = 32
MP3_CPU_STREAMS = 4
MP3_BLOCK_FRAMES = 70                 # frames of each block-type stream
VORBIS_STREAMS = 16                   # the JAX package's Vorbis width
VORBIS_SECONDS = 8.0
VORBIS_GROUP = 64
VORBIS_CPU_STREAMS = 4
PS_STREAMS = 16                       # the HE-AAC v1 serving width
PS_GROUP = 96                         # the plug-in's SBR_GROUP_FRAMES
PS_FRAMES = 2 * PS_GROUP              # frames a PS stream
MP3_SEEK_S = 4.0                      # phase 18: where the Xing play seeks
ALAC_FRAME = 4096                     # samples an ALAC packet
ALAC_SECONDS = 2.0
SILK_PACKETS = 60
MESH_FLAC_STREAMS = 16                # phase 19: the CD streams (8 s each)
MESH_AAC_STREAMS = 16                 # 341-356 frames: 6 groups each
MESH_HE_STREAMS = 5                   # 144-184 frames: 4 groups each
MESH_MP3_STREAMS = 8                  # 8 s each
MESH_LOGICAL = ["cuda:0"] * 4         # dp 2, sp 2 on one card
MESH_REPS = 3                         # alternating timed calls a codec
HBM_BYTES_PER_S = 3.35e12             # H100 SXM, 700 W
FP32_OPS_PER_S = 67e12


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, ops: float) -> tuple:
    """(bound ms, "bytes" or "operations"): the least time the card could
    take to move n_bytes and do ops float32 operations."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def flac_content() -> tuple:
    """Phase 0's content: the (seed, seconds, rate, bits) jobs and their
    (track, FLAC bytes), encoded in a spawned process pool."""
    jobs = ([(s, CD_SECONDS, 44100, 16) for s in CD_SEEDS]
            + [(s, HIRES_SECONDS, 96000, 24) for s in HIRES_SEEDS])
    with mp.get_context("spawn").Pool(min(len(jobs), os.cpu_count() or 1)) \
            as pool:
        return jobs, pool.map(encode_job, jobs)


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


def kernel_ms(fn, reps: int) -> float:
    """Mean device time of one fn() (a kernel launch, no host sync) over
    reps launches captured in one CUDA graph and replayed after a warm-up:
    a launch from Python through ctypes takes ~10 us on the host, longer
    than a short kernel, so an eager loop would time the host."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
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


def first_calls(module, names, run) -> tuple:
    """Runs run() with each function ``names`` of ``module`` wrapped, for
    that time only, to keep the arguments (tensors cloned before the call)
    and the result of its first call.  Returns (run()'s result, {name:
    (args, result)})."""
    import torch

    real = {name: getattr(module, name) for name in names}
    seen = {}

    def wrap(name):
        def rec(*args):
            if name in seen:
                return real[name](*args)
            kept = tuple(a.clone() if isinstance(a, torch.Tensor) else a
                         for a in args)
            seen[name] = (kept, real[name](*args))
            return seen[name][1]
        return rec

    for name in names:
        setattr(module, name, wrap(name))
    try:
        result = run()
    finally:
        for name, fn in real.items():
            setattr(module, name, fn)
    return result, seen


def lpc_group_inputs(t: dict) -> list:
    """The LPC kernel's arguments in the group pass over the FLAC wire
    planes ``t`` (on the card), captured from flac.synthesise_group_rice."""
    from ohpipeline_tpu_torch.codecs import flac
    from ohpipeline_tpu_torch.ops import lpc

    _, seen = first_calls(lpc, ["lpc_synthesize"], lambda: (
        flac.synthesise_group_rice(*(t[k] for k in flac.RICE_PLANES), 2)))
    return list(seen["lpc_synthesize"][0])


def lpc_taps(coeffs) -> np.ndarray:
    """(B,) taps of each row: one past its last nonzero coefficient."""
    nz = coeffs.cpu().numpy() != 0
    return np.where(nz.any(1), 32 - np.argmax(nz[:, ::-1], 1), 0)


def check_lpc(name, args, phase: int = 2):
    """LPC kernel against the plain version on the card, bit for bit;
    returns (max |err|, kernel ms, plain ms, (bound ms, bound by))."""
    import torch
    from ohpipeline_tpu_torch.ops import lpc

    got = lpc.lpc_synthesize(*args)
    want = lpc.lpc_synthesize_torch(*args)
    torch.cuda.synchronize()
    assert got.device.type == "cuda" and got.shape == want.shape
    err = int((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"lpc kernel != plain on {name} (max |err| "
                             f"{err})")
    ms = kernel_ms(lambda: lpc.lpc_synthesize(*args), 20)
    plain_ms = cuda_ms(lambda: lpc.lpc_synthesize_torch(*args), 2)
    B, N = args[0].shape
    # per sample one multiply and one add per coefficient of the row's order
    b = bound(nbytes(*args, got), 2 * N * int(args[3].long().sum()))
    taps = lpc_taps(args[1])
    pad = np.zeros(-len(taps) % 4, taps.dtype)
    narrow = float((np.concatenate([taps, pad]).reshape(-1, 4).max(1)
                    <= 8).mean())
    order = np.bincount(args[3].cpu().numpy())
    print(f"phase {phase}: lpc {name} {B}x{N} bit-exact; orders "
          f"{np.flatnonzero(order).min()}-{len(order) - 1}, "
          f"{order.max()} rows of order {order.argmax()}; blocks on the "
          f"8-lane path {narrow:.3f}; kernel {ms:.4f} ms, plain "
          f"{plain_ms:.2f} ms, bound {b[0] * 1e3:.2f} us ({b[1]})")
    return err, ms, plain_ms, b


def pack_fields(nbits: int, start, value, length) -> np.ndarray:
    """(ceil(nbits / 32),) int32 big-endian words (u32 bit patterns) holding
    each bit field: ``length[i]`` <= 64 bits of ``value[i]`` < 2^32, most
    significant first, at bit ``start[i]``; fields do not overlap, bits
    outside them are 0."""
    nw = -(-nbits // 32)
    start = np.asarray(start, np.int64)
    value = np.asarray(value, np.uint64)
    length = np.asarray(length, np.int64)
    acc = np.zeros(nw + 3, np.float64)      # disjoint fields: sums are exact
    for j in range(3):                      # a field spans at most 3 words
        w = (start >> 5) + j
        d = start + length - 32 * (w + 1)   # the word's last bit in the field
        part = np.where(d >= 0,
                        value >> np.clip(d, 0, 63).astype(np.uint64),
                        value << np.clip(-d, 0, 63).astype(np.uint64))
        part = np.where((d > -32) & (length > 0), part & 0xFFFFFFFF, 0)
        acc += np.bincount(w, weights=part.astype(np.float64),
                           minlength=nw + 3)
    return acc[:nw].astype(np.uint32).view(np.int32)


RICE_WORST_UNITS = 16384


def rice_worst_case(seed=0, U=RICE_WORST_UNITS) -> tuple:
    """Inputs of the rice-unit decode (words, cur, kk, mode, counts), numpy
    int32, reaching every corner of the reference's arithmetic, including
    inputs the host parser never emits.  Every fourth unit is verbatim, at
    widths 0-32 in turn; the others are rice at k 0-30 in turn, step i of
    the r-th rice unit coding quotient (i + r) mod 17 with random low bits
    (quotient 16: sixteen zeros, so the window's top half is empty), so
    codewords run up to 47 bits, past the 32-bit window.  Unit u starts at
    bit phase u mod 32 behind random filler bits.  Counts are 64, with 0, 1,
    63 and 2-62 scattered.  The slab ends inside the codewords of the last
    units, so their walks run past its last word; of those, one starts past
    the slab's end and one at a negative cursor."""
    rng = np.random.default_rng(seed)
    u = np.arange(U)
    raw = u % 4 == 3
    kk = np.where(raw, (np.cumsum(raw) - 1) % 33,
                  (np.cumsum(~raw) - 1) % 31).astype(np.int64)
    pick = rng.random(U)
    counts = np.select([pick < 0.04, pick < 0.08, pick < 0.12, pick < 0.2],
                       [0, 1, 63, rng.integers(2, 63, U)], 64)
    counts[-6:] = 64
    step = np.arange(64)[None, :]
    q = np.where(raw[:, None], 0, (step + np.cumsum(~raw)[:, None] - 1) % 17)
    kc = kk[:, None]
    field = rng.integers(0, np.left_shift(1, kc), (U, 64))
    value = np.where(raw[:, None], field, np.left_shift(1, kc) | field)
    length = np.where(raw[:, None], kc, q + 1 + kc)
    length = np.where(step < counts[:, None], length, 0)
    ends = np.cumsum(length, axis=1)
    cur = np.zeros(U, np.int64)
    fill = np.zeros(U, np.int64)
    pos = 0
    for i, total in enumerate(ends[:, -1].tolist()):
        fill[i] = (i - pos) % 32            # filler bits up to phase i mod 32
        cur[i] = pos + fill[i]
        pos = int(cur[i]) + total
    start = np.concatenate([(cur[:, None] + ends - length).reshape(-1),
                            cur - fill])
    value = np.concatenate([value.reshape(-1),
                            rng.integers(0, np.left_shift(1, fill))])
    length = np.concatenate([length.reshape(-1), fill])
    nbits = int(cur[U - 4] + ends[U - 4, -1] // 2)   # inside unit U - 4
    keep = start < nbits
    words = pack_fields(nbits, start[keep], value[keep], length[keep])
    cur[U - 2] = 32 * len(words) + 77
    cur[U - 1] = -45
    return (words, cur.astype(np.int32), kk.astype(np.int32),
            raw.astype(np.int32), counts.astype(np.int32))


def check_rice(name, lanes, phase: int = 3):
    """Rice kernel against the plain version on the card, bit for bit;
    returns (max |err|, kernel ms, plain ms, (bound ms, bound by))."""
    import torch
    from ohpipeline_tpu_torch.codecs.flac import rice

    got = rice.scan_units(*lanes)
    want = rice.scan_units_torch(*lanes)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"rice kernel != plain on {name} (max |err| "
                             f"{err})")
    ms = kernel_ms(lambda: rice.scan_units(*lanes), 20)
    plain_ms = cuda_ms(lambda: rice.scan_units_torch(*lanes), 3)
    # per decoded sample ~10 integer operations (leading-zero count,
    # shifts, masks, the zigzag fold), counted at the float32 rate
    b = bound(nbytes(*lanes, got), 10 * int(lanes[4].long().sum()))
    print(f"phase {phase}: rice {name}: {lanes[1].shape[0]} units over "
          f"{lanes[0].shape[0] * 4} slab bytes bit-exact; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
          f"{b[0] * 1e3:.2f} us ({b[1]})")
    return err, ms, plain_ms, b


def aac_streams() -> list:
    """Stream s: dryrun.aac's ADTS frames from frame s (mod the asset's
    frame count) onward, then the whole asset AAC_REPEATS more times."""
    from ohpipeline_tpu_torch._host import aac_bitstream

    with open(AAC_ASSET, "rb") as f:
        data = f.read()
    offsets, pos = [], 0
    while pos < len(data):
        h = aac_bitstream.parse_adts_header(data, pos)
        if h is None:
            break
        offsets.append(pos)
        pos += h.frame_bytes
    return [data[offsets[s % len(offsets)]:] + data * AAC_REPEATS
            for s in range(AAC_STREAMS)]


def he_streams() -> list:
    """Stream s: dryrun_he.aac from frame 10 * (s mod 5) onward, then the
    whole asset 3 + s // 5 more times."""
    from ohpipeline_tpu_torch._host import aac_bitstream

    with open(HE_ASSET, "rb") as f:
        data = f.read()
    offsets, pos = [], 0
    while pos < len(data):
        h = aac_bitstream.parse_adts_header(data, pos)
        if h is None:
            break
        offsets.append(pos)
        pos += h.frame_bytes
    cuts = len(offsets) // HE_HEADER_EVERY + 1
    return [data[offsets[HE_HEADER_EVERY * (s % cuts)]:]
            + data * (3 + s // cuts) for s in range(HE_STREAMS)]


def sbr_env_case(dev, kind="worst", C=32, F=48, M=24, seed=8):
    """Frame-scan arguments in the compact form envelope_scan takes, on
    ``dev``, with the noise and sine values made from counters over seeded
    tables.  ``worst``: every slot active, prev_id drawn from the frame's
    envelopes and the carry (8), carry_mask on the first 8 slots (the 6
    carried and 2 zeroed), smoothing ratios in [0, 1), sine bins, sine and
    noise levels all on, a quarter of the envelopes without noise.
    ``stale_filt``: as ``worst``, but a last envelope in ~6% of the frames
    and none in channel 0, and prev_id 8 on ~80% of the slots: the carried
    filt comes from far back, or from the input.  ``carry_high``: carry_mask
    on half the slots at random (slots >= 32 too) and ~30% of the slots
    inactive."""
    import torch
    from ohpipeline_tpu_torch.codecs.aac.sbr import slot_order

    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    gain, noise, sine = (np.abs(f32(C, F, 8, M)) for _ in range(3))
    bins = (rng.random((C, F, 8, M)) < 0.3).astype(np.float32)
    env_id = rng.integers(0, 8, (C, F, 38)).astype(np.int8)
    prev_id = rng.integers(0, 9, (C, F, 38)).astype(np.int8)
    last_env = rng.integers(-1, 8, (C, F)).astype(np.int8)
    r = rng.random((C, F, 38)).astype(np.float32)
    cmask = np.zeros((C, F, 38), np.float32)
    cmask[:, :, :8] = 1.0
    if kind == "stale_filt":
        keep = rng.random((C, F)) < 0.06
        last_env = np.where(keep, last_env.clip(0), -1).astype(np.int8)
        last_env[0] = -1
        prev_id[rng.random((C, F, 38)) < 0.8] = 8
    elif kind == "carry_high":
        cmask = (rng.random((C, F, 38)) < 0.5).astype(np.float32)
        env_id[rng.random((C, F, 38)) < 0.3] = -1
    elif kind != "worst":
        raise ValueError(f"no SBR case {kind!r}")
    no_noise = (rng.random((C, F, 8)) < 0.25).astype(np.float32)
    er, ei = f32(C, F, 38, M, scale=300.0), f32(C, F, 38, M, scale=300.0)
    tab_re, tab_im = f32(512), f32(512)
    parity = np.where(rng.random(M) < 0.5, -1.0, 1.0).astype(np.float32)
    cal = float(np.float32(rng.uniform(0.5, 2.0)))
    idx0 = rng.integers(0, 512, C).astype(np.int32)
    ph0 = rng.integers(0, 4, C).astype(np.int32)
    filt = np.abs(f32(C, 2, M))
    tail_r, tail_i = f32(C, 6, M, scale=300.0), f32(C, 6, M, scale=300.0)

    def t(a):
        return torch.from_numpy(a).to(dev)

    env_t = t(env_id)
    return (t(gain), t(noise), t(sine), t(bins), env_t, t(prev_id),
            t(last_env), t(r), t(cmask), slot_order(env_t), t(idx0), t(ph0),
            t(no_noise), t(tab_re), t(tab_im), t(parity), cal, t(er), t(ei),
            t(filt), t(tail_r), t(tail_i))


def sbr_env_bytes(args, got, planes=False) -> int:
    """Bytes the SBR frame map must move on the compact arguments ``args``
    and its outputs ``got``: each output once, and of the inputs what this
    data has the kernel read.  It computes slots 0-31 of every frame, 32-37
    of the last, and of an earlier frame those the next one carries.  Of
    the four envelope planes it reads the rows (channel, frame, envelope)
    that a computed active slot names: gain and noise through env_id or
    prev_id below 8, or, for prev_id 8 (the carried filt) and for the filt
    it leaves, through the last_env of the latest earlier frame that has
    one; sine and sine_bins (and no_noise) through env_id alone.  It reads
    er / ei where a computed slot is not carried, prev_id, r and k_ord at
    active slots, and env_id, carry_mask, last_env and the small
    per-channel inputs whole.  With ``planes`` the noise and sine values are
    read as four more slot planes at the active slots, in place of the
    counters and tables."""
    import torch

    (gain, _, _, _, env_id, prev_id, last_env, _, cmask, _, idx0, ph0,
     _, tab_re, tab_im, parity, _, _, _, filt, tail_r, tail_i) = args
    C, F, E, M = gain.shape
    dev = gain.device
    carried = cmask > 0
    used = torch.ones_like(carried)
    used[:, :-1, 32:] = carried[:, 1:, :6]
    active = used & (env_id >= 0)
    c, f, s = active.nonzero(as_tuple=True)
    cur = torch.zeros((C, F, E + 1), dtype=torch.bool, device=dev)
    cur[c, f, env_id[c, f, s].long()] = True
    gn = cur.clone()
    p = prev_id[c, f, s].long()
    gn[c, f, torch.where((p >= 0) & (p < E), p, E)] = True
    # the frame each frame's filt comes from (-1: the input filt), and the
    # frames that read it: a smoothing slot with prev_id 8, or the end
    seen = torch.where(last_env >= 0, torch.arange(F, device=dev),
                       -1).cummax(1).values
    src = torch.cat([torch.full((C, 1), -1, device=dev), seen], 1)
    reads = torch.zeros((C, F + 1), dtype=torch.bool, device=dev)
    reads[c[p >= E], f[p >= E]] = True
    reads[:, F] = True
    c, f = (reads & (src >= 0)).nonzero(as_tuple=True)
    k = src[c, f]
    gn[c, k, last_env[c, k].long()] = True
    n_act, row = int(active.sum()), 4 * M
    total = (2 * row * int(gn[..., :E].sum())
             + 2 * row * int(cur[..., :E].sum())
             + 2 * row * int((used & ~carried).sum())
             + n_act * (prev_id.element_size() + 8)
             + nbytes(env_id, cmask, last_env, filt, tail_r, tail_i, *got))
    if planes:
        return total + 4 * row * n_act
    return total + 4 * int(cur[..., :E].sum()) + nbytes(idx0, ph0, tab_re,
                                                        tab_im, parity)


def check_sbr_env(name, args, phase: int = 8):
    """SBR envelope kernel against the plain version (noise_sine_planes,
    then envelope_scan_torch) on the card, bit for bit; returns (max |err|,
    kernel ms, plain ms, bound ms, bound by)."""
    import torch
    from ohpipeline_tpu_torch.codecs.aac import sbr as sbrd

    planes = sbrd.plane_args(*args)
    got = sbrd.envelope_scan(*args)
    want = sbrd.envelope_scan_torch(*planes)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"sbr_env kernel != plain on {name} (max |err| "
                             f"{err:.4g})")
    ms = kernel_ms(lambda: sbrd.envelope_scan(*args), 20)
    plain_ms = cuda_ms(lambda: sbrd.envelope_scan_torch(
        *sbrd.plane_args(*args)), 2)
    C, F, _, M = args[0].shape
    # per active slot and bin: two smoothing mixes (4 ops each), the sine
    # bin's complement, two injections (6 each), the noise values (3) and
    # the sine values (5)
    ops = 29 * int((args[4] >= 0).sum()) * M
    b_ms, b_by = bound(sbr_env_bytes(args, got), ops)
    b_planes = bound(sbr_env_bytes(args, got, planes=True), ops)[0]
    print(f"phase {phase}: sbr_env {name}: C={C} F={F} M={M} bit-exact; "
          f"kernel "
          f"{ms:.4f} ms, plain {plain_ms:.2f} ms, bound {b_ms * 1e3:.2f} us "
          f"({b_by}; {b_planes * 1e3:.2f} us with the noise and sine planes "
          f"read)")
    return err, ms, plain_ms, b_ms, b_by


def numpy_sbr_chain(stream: bytes, core, nframes: int):
    """sbr.py's SbrDecoder (float64, per frame) over ``stream``'s first
    ``nframes`` frames, fed the core PCM ``core`` (2, nframes, 1024):
    returns (2, nframes * 2048)."""
    from ohpipeline_tpu_torch._host import aac_bitstream, aac_native, aac_sbr

    n, _, b = aac_native().aac_parse_group_sbr(stream, 0, channels=2,
                                               max_frames=nframes)
    dec = aac_sbr.SbrDecoder(aac_bitstream.parse_adts_header(stream)
                             .sample_rate)
    outs = []
    for f in range(n):
        payload, nbits, crc = b["sbr"][f]
        chans, coupling = dec.parse_payload(payload, nbits, stereo=True,
                                            crc=crc)
        outs.append(dec.process_frame(core[:, f].astype(np.float64), chans,
                                      coupling))
    return np.concatenate(outs, axis=1)


def _ps_row(rng, n: int, stride: int, lo: int, hi: int, prev) -> tuple:
    """Raw IID or ICC deltas of one envelope (n bins at ``stride`` in the
    34-wide rows) whose decoded values stay within [lo, hi]: targets near
    the previous row ``prev``, coded in time (against ``prev``) or in
    frequency.  Returns (raw, dt, the decoded targets)."""
    base = np.asarray(prev)[np.arange(n) * stride]
    v = np.clip(base + rng.integers(-3, 4, n), lo, hi)
    dt = int(rng.random() < 0.5)
    raw = v - base if dt else np.diff(v, prepend=0)
    return [int(x) for x in raw], dt, v


def ps_frame(rng, f: int, prev_iid, prev_icc):
    """A seeded parametric-stereo frame (sbr.py PsData) at stream frame
    ``f``, or None on every fifth frame (f % 5 == 4: the previous
    parameters hold).  Frame by frame the modes cycle: mode_iid f % 6,
    mode_icc (f // 2) % 6 (0-2 coarse or 20 bins, 3-5 fine IID; 2 and 5 the
    34-band map), frame_class (f // 3) % 2, and the FIX envelope count
    0, 1, 2, 4 by (f // 6) % 4; a VAR frame takes 1-4 envelopes at random
    borders.  prev_iid / prev_icc are the decoder's 34-wide rows before
    the frame."""
    from ohpipeline_tpu_torch._host import aac_sbr

    if f % 5 == 4:
        return None
    ps = aac_sbr.PsData(header_valid=True, enable_iid=True, mode_iid=f % 6,
                        enable_icc=True, mode_icc=(f // 2) % 6,
                        frame_class=(f // 3) % 2)
    if ps.frame_class == 0:
        ps.n_env = (0, 1, 2, 4)[(f // 6) % 4]
    else:
        ps.n_env = int(rng.integers(1, 5))
        ps.borders = sorted(int(b) for b in rng.choice(
            np.arange(1, 33), ps.n_env, replace=False))
    fine = ps.mode_iid > 2
    steps = 15 if fine else 7
    res_iid, res_icc = ps.mode_iid % 3, ps.mode_icc % 3
    bins = (10, 20, 34)
    ps.iid_index, ps.iid_dt, ps.icc_index, ps.icc_dt = [], [], [], []
    pi, pc = prev_iid, prev_icc
    for _e in range(ps.n_env):
        raw, dt, v = _ps_row(rng, bins[res_iid], 2 if res_iid == 0 else 1,
                             -steps, steps, pi)
        ps.iid_index.append(raw)
        ps.iid_dt.append(dt)
        pi = np.repeat(v, 2) if res_iid == 0 else v
        raw, dt, v = _ps_row(rng, bins[res_icc], 2 if res_icc == 0 else 1,
                             0, 7, pc)
        ps.icc_index.append(raw)
        ps.icc_dt.append(dt)
        pc = np.repeat(v, 2) if res_icc == 0 else v
    return ps


PS_LEVEL = 0.5              # ps_content's core level against the asset's
PS_BURST_EVERY = 8          # frames between its bursts, from frame 5
PS_BURST_GAIN = 2.0         # a burst frame: back at the asset's level


def ps_content(s: int, F: int) -> dict:
    """Parametric-stereo content of stream s, F frames (the repository has
    no HE-AAC v2 stream): tests/assets/dryrun_he.aac's frames from frame
    10 * (s mod 5) on (an SBR header comes every 10 frames), then the whole
    asset again as often as F needs.  The mono core is the left channel:
    its prepared spectra and operator indices (the native parse and
    synthesis.prepare_group, as the plug-in's spec mode takes them), scaled
    by PS_LEVEL, and every PS_BURST_EVERY-th frame (from frame 5) by
    PS_BURST_GAIN more: a burst whose decay drives transient factors below
    1 (the asset's own onsets do so in most frames too); its SBR channel
    data, parsed (stereo) with one SbrDecoder, and envelope and noise
    levels from that decoder's dequant.  Each frame's channel data carries
    a seeded PsData or None (ps_frame, seed 900 + s).  Returns dict(specs
    (F, 1024) float32, ops (F,) int32, datas, Es, Qs, ps (per frame), dec
    (the SbrDecoder: its header and tables for the runners, its DSP state
    untouched for numpy_ps_chain))."""
    from ohpipeline_tpu_torch._host import (aac_bitstream, aac_native,
                                            aac_sbr, sbr_native)
    from ohpipeline_tpu_torch.codecs.aac import synthesis as asyn

    with open(HE_ASSET, "rb") as f:
        data = f.read()
    offsets, pos = [], 0
    while pos < len(data):
        h = aac_bitstream.parse_adts_header(data, pos)
        if h is None:
            break
        offsets.append(pos)
        pos += h.frame_bytes
    cut = HE_HEADER_EVERY * (s % (len(offsets) // HE_HEADER_EVERY + 1))
    stream = data[offsets[cut]:] + data * (F // len(offsets) + 1)
    n, _, b = aac_native().aac_parse_group_sbr(stream, 0, channels=2,
                                               max_frames=F)
    assert n == F, (n, F)
    specs, ops = asyn.prepare_group(b, F, 2, np.zeros(2, np.int32))
    specs = specs[:, 0] * np.float32(PS_LEVEL)
    specs[5::PS_BURST_EVERY] *= np.float32(PS_BURST_GAIN)
    sbr_native()
    dec = aac_sbr.SbrDecoder(aac_bitstream.parse_adts_header(stream)
                             .sample_rate)
    rng = np.random.default_rng(900 + s)
    prev_iid, prev_icc = np.zeros(34, np.int64), np.zeros(34, np.int64)
    datas, Es, Qs, pss = [], [], [], []
    for f in range(F):
        payload, nbits, crc = b["sbr"][f]
        chans, _ = dec.parse_payload(payload, nbits, stereo=True, crc=crc)
        E, Q, _a = dec.dequant(dec.header, chans[0].grid, chans[0].env,
                               chans[0].noise)
        ps = ps_frame(rng, f, prev_iid, prev_icc)
        if ps is not None:
            _, _, prev_iid, prev_icc = aac_sbr.decode_ps_indices(
                ps, prev_iid, prev_icc)
        chans[0].ps = ps
        datas.append(chans[0])
        Es.append(E)
        Qs.append(Q)
        pss.append(ps)
    return dict(specs=specs, ops=ops[:, 0].copy(), datas=datas, Es=Es,
                Qs=Qs, ps=pss, dec=dec)


def ps_mix_worst_case(dev, C=16, S=3072, seed=15) -> tuple:
    """Arguments of the PS scan (ps_scan / ps_scan_torch) on ``dev``: C
    streams of S slots with every channel near full scale (complex normal
    at 2^15) on a burst slot every 8 slots and at 1/20 of that between
    them, so each burst's decay drives transient factors below 1; mixing
    matrices uniform in [-2, 2), every group's distinct; a seeded carry
    (positive power states, live delay lines and rings); the real
    coefficient and index tables."""
    import torch
    from ohpipeline_tpu_torch.codecs.aac import sbr as sbrd

    rng = np.random.default_rng(seed)
    env = np.where(np.arange(S) % 8 == 0, 1.0, 0.05)[None, :, None]
    mr, mi = ((rng.standard_normal((C, S, sbrd.PS_CH)) * 32768.0 * env)
              .astype(np.float32) for _ in range(2))
    H = rng.uniform(-2.0, 2.0, (C, S, 4, sbrd.PS_MIX)).astype(np.float32)
    carry = (rng.standard_normal((C, sbrd._size(sbrd.PS_CARRY))) * 3000.0) \
        .astype(np.float32)
    carry[:, :3 * sbrd.PS_GROUPS] = np.abs(carry[:, :3 * sbrd.PS_GROUPS]) \
        ** 2
    k = sbrd.ps_constants(sbrd.PsStatic(), dev)
    return (*(torch.from_numpy(a).to(dev) for a in (mr, mi, H, carry)),
            k["coef"], k["imap"])


def numpy_ps_chain(content: dict) -> np.ndarray:
    """sbr.py's per-frame HE-AAC v2 chain (SbrDecoder.process_frame_ps,
    float64) over ps_content's frames, fed the same core: the float32
    numpy IMDCT of its spectra (the plug-in's _core_float_from_specs).
    Returns (2, F * 2048)."""
    from ohpipeline_tpu_torch.codecs import aac

    F = len(content["datas"])
    core = aac._core_float_from_specs(content["specs"][:, None],
                                      content["ops"][:, None],
                                      aac._StreamState(1))
    dec = content["dec"]
    return np.concatenate(
        [dec.process_frame_ps(core[:, f * 1024:(f + 1) * 1024],
                              [content["datas"][f]]) for f in range(F)],
        axis=1)


def celt_streams() -> list:
    """Stream s: dryrun.opus's OpusHead and OpusTags packets, its audio
    packets from frame 3 s (mod 50) on, then all of them CELT_REPEATS more
    times, paged with the port's build_pages."""
    from ohpipeline_tpu_torch._host import base, ogg

    with open(CELT_ASSET, "rb") as f:
        data = f.read()
    head, tags, *audio = ogg.OggReader(base.BufferReader(data)).packets()
    out = []
    for s in range(CELT_STREAMS):
        pk = audio[(3 * s) % len(audio):] + audio * CELT_REPEATS
        out.append(ogg.build_pages(s + 1, [head], bos=True)
                   + ogg.build_pages(s + 1, [tags], first_sequence=1)
                   + ogg.build_pages(s + 1, pk, first_sequence=2,
                                     granule=960 * len(pk), eos=True))
    return out


def host_celt_decode(data: bytes) -> np.ndarray:
    """The host celt.py decode (float64, frame by frame), int16."""
    from ohpipeline_tpu_torch._host import base, celt, ogg
    from ohpipeline_tpu_torch._host import split_packet_frames

    st, outs = celt.CeltDecoderState(2), []
    for pk in list(ogg.OggReader(base.BufferReader(data)).packets())[2:]:
        for f in split_packet_frames(pk)[1]:
            outs.append(celt.decode_frame(st, f, 960))
    pcm = np.concatenate(outs, axis=1) * 32768.0
    return np.clip(np.rint(pcm), -32768, 32767).astype(np.int16)


def celt_comb_worst_case(dev, S=CELT_STREAMS, F=CELT_GROUP, seed=10):
    """Comb rows with every frame filtered: lags cycling through (15, 15,
    15), (1024, 1024, 1024), (15, 1024, 15), (1024, 15, 1024) and random
    ones, tapsets (f, f + 1, f + 2) mod 3 so every crossfade between them
    occurs, gains in [0.1, 0.75)."""
    import torch
    from ohpipeline_tpu_torch._host import celt

    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((2 * S, 1026 + F * 960)) * 3000) \
        .astype(np.float32)
    Tv = rng.integers(15, 1025, (S, F, 3)).astype(np.int32)
    fixed = ((15, 15, 15), (1024, 1024, 1024), (15, 1024, 15),
             (1024, 15, 1024))
    for f in range(F):
        if f % 5 < 4:
            Tv[:, f] = fixed[f % 5]
    tap = (np.arange(F)[:, None] + np.arange(3)[None, :]) % 3
    gain = rng.uniform(0.1, 0.75, (S, F, 3))
    gt = (gain[..., None] * np.asarray(celt.COMB_GAINS)[tap][None]) \
        .astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (y, Tv, gt)]


def celt_comb_lag_case(dev, S=CELT_STREAMS, F=CELT_GROUP, seed=11):
    """Comb rows whose lags are 33, 34, 35, 66 and 67 (runs of 31-33 and
    64-65 samples: either side of one and two warp widths), every frame
    filtered, tapsets and gains at random."""
    import torch
    from ohpipeline_tpu_torch._host import celt

    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((2 * S, 1026 + F * 960)) * 3000) \
        .astype(np.float32)
    lags = np.array([33, 34, 35, 66, 67], np.int32)
    Tv = lags[rng.integers(0, len(lags), (S, F, 3))]
    tap = rng.integers(0, 3, (S, F, 3))
    gain = rng.uniform(0.1, 0.75, (S, F, 3))
    gt = (gain[..., None] * np.asarray(celt.COMB_GAINS)[tap]) \
        .astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (y, Tv, gt)]


def comb_ops(Tv, gt, channels: int) -> int:
    """Float operations the comb needs for these frames: per sample 5 for
    the crossfade and 7 for each tap set with a nonzero gain it reads (both
    in the first 120 samples of each segment, the second alone after)."""
    on = (gt.abs().sum(-1) > 0).cpu().numpy()             # (S, F, 3)
    per = (120 * (5 + 7 * (on[..., 0] + on[..., 1]))
           + 120 * (5 + 7 * (on[..., 1] + on[..., 2]))
           + 720 * (5 + 7 * on[..., 2]))
    return int(per.sum()) * channels


def check_celt_comb(name, args, win2):
    """celt_comb kernel against comb_torch on the card, bit for bit;
    returns (max |err|, kernel ms, plain ms, bound ms, bound by)."""
    import torch
    from ohpipeline_tpu_torch import _kernels
    from ohpipeline_tpu_torch.codecs.opus import celt as pc

    y, Tv, gt = args
    got = _kernels.celt_comb(y, Tv, gt, win2)
    want = pc.comb_torch(y, Tv, gt, win2)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"celt_comb kernel != plain on {name} "
                             f"(max |err| {err})")
    ms = kernel_ms(lambda: _kernels.celt_comb(y, Tv, gt, win2), 20)
    plain_ms = cuda_ms(lambda: pc.comb_torch(y, Tv, gt, win2), 2)
    S, F = Tv.shape[:2]
    b_ms, b_by = bound(nbytes(y, Tv, gt, win2, *got),
                       comb_ops(Tv, gt, y.shape[0] // S))
    print(f"phase 10: celt_comb {name}: {y.shape[0]} rows x {F} frames "
          f"bit-exact; kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
          f"{b_ms * 1e3:.2f} us ({b_by})")
    return err, ms, plain_ms, b_ms, b_by


def mp3_bench_stream(i: int, seconds: float = MP3_SECONDS) -> bytes:
    """bench_secondary.py's MP3 content (mp3_16stream_device): stereo
    MPEG-1 frames at 44.1 kHz, 25% of the lines set to 1-11, global gain
    174-184, from seed 300 + i, built with the port's encoder copy."""
    from ohpipeline_tpu_torch._host import mp3_encoder

    rng = np.random.default_rng(300 + i)
    frames = []
    for _ in range(int(seconds * 44100 / 1152)):
        spec = np.zeros((2, 576), np.int32)
        m = rng.random((2, 576)) < 0.25
        spec[m] = rng.integers(1, 12, m.sum())
        frames.append(mp3_encoder.build_frame(
            [spec[0], spec[1]], global_gain=int(rng.integers(174, 184))))
    return b"".join(frames)


#: block types of the frames of mp3_block_stream, in turn: long, start,
#: three short, stop (the order an encoder switches in)
MP3_BLOCK_CYCLE = (0, 0, 1, 2, 2, 2, 3)


def mp3_block_stream(seed: int, nframes: int, lsf: bool = False) -> bytes:
    """Stereo frames cycling through MP3_BLOCK_CYCLE, each with its own
    spectra (22% of the lines at 1-11, random signs) and global gain 172-
    185: MPEG-1 at 44.1 kHz and 320 kbps, or with ``lsf`` MPEG-2 at 22.05
    kHz and 160 kbps (one granule a frame)."""
    from ohpipeline_tpu_torch._host import mp3_encoder

    rng = np.random.default_rng(seed)
    kw = (dict(version=2, sample_rate=22050, bitrate=160) if lsf else {})
    frames = []
    for f in range(nframes):
        spec = np.zeros((2, 576), np.int32)
        m = rng.random((2, 576)) < 0.22
        spec[m] = rng.integers(1, 12, m.sum())
        spec[rng.random((2, 576)) < 0.5] *= -1
        frames.append(mp3_encoder.build_frame(
            [spec[0], spec[1]], global_gain=int(rng.integers(172, 186)),
            block_type=MP3_BLOCK_CYCLE[f % len(MP3_BLOCK_CYCLE)], **kw))
    return b"".join(frames)


def vorbis_stream(i: int, mode: str, seconds: float = VORBIS_SECONDS,
                  ch: int = 2, coupling: bool = True) -> bytes:
    """Ogg Vorbis content built with the port's StreamSpec copy, bs
    256/1024 at 44.1 kHz.  ``bench``: bench_secondary.py's
    vorbis_16stream_device content (seed 100 + i, all long blocks, 30% of
    the residues at -2..2, floor posts (140, 120)); ``mixed`` / ``long`` /
    ``short``: tests/test_vorbis_device.py's blocks (seed i, 70% long
    blocks for ``mixed``, random floor posts)."""
    from ohpipeline_tpu_torch._host import vorbis_encoder

    seed = 100 + i if mode == "bench" else i
    rng = np.random.default_rng(seed)
    spec = vorbis_encoder.StreamSpec(channels=ch, sample_rate=44100, bs0=256,
                                     bs1=1024, coupling=coupling)
    blocks, n = [], 0
    while n < seconds * 44100:
        if mode == "bench":
            lng, fy = 1, [(140, 120)] * ch
        else:
            lng = {"long": 1, "short": 0}.get(mode,
                                              int(rng.random() < 0.7))
        half = 512 if lng else 128
        r = np.zeros((ch, half), np.int64)
        m = rng.random((ch, half)) < 0.3
        r[m] = rng.integers(-2, 3, m.sum())
        if mode != "bench":
            fy = [(int(rng.integers(100, 200)), int(rng.integers(80, 200)))
                  for _ in range(ch)]
        blocks.append((lng, fy, r))
        n += half
    return spec.build(blocks)


def codec_job(job: tuple) -> bytes:
    """One stream of codec_content's jobs; runs in a pool worker."""
    kind, *args = job
    return {"mp3": mp3_bench_stream, "mp3_blocks": mp3_block_stream,
            "vorbis": vorbis_stream}[kind](*args)


def codec_content() -> dict:
    """The MP3 and Vorbis content of phases 12-14, built in a spawned
    process pool: ``mp3`` (the bench's 16 streams), ``mp3_blocks`` (4
    MPEG-1 streams through every block type), ``mp3_lsf`` (4 MPEG-2 LSF
    streams, the same cycle), ``vorbis`` (8 bench streams, then 8 with
    mixed blocks)."""
    half = VORBIS_STREAMS // 2
    jobs = {"mp3": [("mp3", i) for i in range(MP3_STREAMS)],
            "mp3_blocks": [("mp3_blocks", 40 + s, MP3_BLOCK_FRAMES)
                           for s in range(MP3_CPU_STREAMS)],
            "mp3_lsf": [("mp3_blocks", 50 + s, MP3_BLOCK_FRAMES, True)
                        for s in range(MP3_CPU_STREAMS)],
            "vorbis": [("vorbis", i, "bench") for i in range(half)]
            + [("vorbis", i, "mixed") for i in range(half)]}
    flat = [j for js in jobs.values() for j in js]
    with mp.get_context("spawn").Pool(min(len(flat), os.cpu_count() or 1)) \
            as pool:
        made = iter(pool.map(codec_job, flat))
    return {k: [next(made) for _ in js] for k, js in jobs.items()}


def mp3_scan_f64(xr_t: np.ndarray, bt_t: np.ndarray) -> np.ndarray:
    """The scan form of the MP3 hybrid filterbank (``hybrid_synthesis``:
    a granule loop carrying the IMDCT overlap, an 18-step loop carrying
    the 16 x 64 V-FIFO) in float64 numpy from a zero state, over (Tg, C,
    576) spectra and (Tg, C, 32) block types -> (C, Tg * 576) float PCM
    in [-1, 1) units."""
    from ohpipeline_tpu_torch._host import mp3_prep

    ops = mp3_prep._imdct_operators()
    poly = mp3_prep._polyphase_matrix()
    wnd = mp3_prep._window_matrix().astype(np.float64)
    Tg, C = xr_t.shape[:2]
    ov = np.zeros((C, 32, 18))
    vf = np.zeros((C, 16, 64))
    out = np.zeros((C, Tg, 18, 32))
    for g in range(Tg):
        bands = xr_t[g].reshape(C, 32, 18).astype(np.float64)
        x36 = np.einsum("csk,cskn->csn", bands, ops[bt_t[g]])
        t = x36[..., :18] + ov
        ov = x36[..., 18:]
        t[:, 1::2, 1::2] *= -1.0                # frequency inversion
        V = t.transpose(0, 2, 1) @ poly         # (C, 18, 64)
        for s in range(18):
            vf = np.concatenate([V[:, s:s + 1], vf[:, :-1]], axis=1)
            U = np.stack([vf[:, 0::2, :32], vf[:, 1::2, 32:]],
                         axis=2).reshape(C, 16, 32)
            out[:, g, s] = (U * wnd).sum(axis=1)
    return out.reshape(C, Tg * 576)


def mp3_host_reference(data: bytes) -> np.ndarray:
    """A whole MP3 stream's (C, n) int16-range PCM from mp3_scan_f64 fed
    the prepare_granules spectra of its frames (parsed in order by one
    Mp3Stream, as the serving call parses each stream)."""
    from ohpipeline_tpu_torch._host import mp3_bitstream, mp3_prep

    hdr = mp3_bitstream.parse_frame_header(data)
    st, frames = mp3_bitstream.Mp3Stream(data), []
    while (fr := st.next_frame()) is not None:
        frames.append(fr)
    xr, bt = mp3_prep.prepare_granules(frames, hdr.channels)
    pcm = mp3_scan_f64(xr, bt) * 32768.0
    return np.clip(np.rint(pcm), -32768, 32767)


def snr_db(ref, got) -> float:
    """10 log10 of the reference's power over the error's."""
    ref = np.asarray(ref, np.float64)
    err = np.asarray(got, np.float64) - ref
    return float(10 * np.log10((ref ** 2).mean()
                               / max((err ** 2).mean(), 1e-30)))


def mp3_window_case(dev, Tg=64, B=33, n_real=40, seed=12):
    """Window-pass input vfull (15 + 18 Tg, B, 64) float32 on ``dev``:
    broadband V (the 15 history rows and the real slots) at magnitudes
    whose sums saturate both clip ends on ~15% of the samples, zero past
    the n_real real granules (a partial group's padding); B odd, so the
    last channel tile is half full."""
    import torch

    rng = np.random.default_rng(seed)
    v = rng.standard_normal((15 + 18 * Tg, B, 64))
    v *= np.exp(rng.uniform(np.log(0.02), np.log(3.0), (1, B, 1)))
    v[15 + 18 * n_real:] = 0.0
    return torch.from_numpy(v.astype(np.float32)).to(dev)


def mp3_window_library(vfull, wnd):
    """The window pass's FIR as PyTorch's own calls (no rounding or
    layout): one ``conv1d`` over time with groups=64, one 16-tap filter
    per V lane (lane i < 32 takes wnd[2m][i] at tap 15 - 2m, lane 32 + i
    wnd[2m + 1][i] at tap 14 - 2m), then the pair-add of lanes i and 32 +
    i.  Returns a function of no arguments that computes it on vfull's
    lanes laid out as (B, 64, 15 + T) and returns (B, 32, T) float32."""
    import torch

    w = torch.zeros((64, 1, 16), device=vfull.device)
    for m in range(8):
        w[:32, 0, 15 - 2 * m] = wnd[2 * m]
        w[32:, 0, 14 - 2 * m] = wnd[2 * m + 1]
    x = vfull.permute(1, 2, 0).contiguous()                 # (B, 64, 15 + T)

    def run():
        y = torch.nn.functional.conv1d(x, w, groups=64)     # (B, 64, T)
        return y[:, :32] + y[:, 32:]

    return run


def check_mp3_window(name, vfull, wnd, bit_depth: int,
                     library: bool = False, phase: int = 12):
    """mp3_window kernel against mp3_window_torch on the card, <= 1 LSB;
    with ``library`` also times the conv1d formulation
    (mp3_window_library) and holds its rounded result to the plain
    version's to 1 LSB (at 16 bits: at 24 bits its other summation order
    parts from it by float32's rounding, ~10 LSB).  Returns (max |err| in
    LSB, kernel ms, plain ms, bound ms, bound by, library ms or None)."""
    import torch
    from ohpipeline_tpu_torch import _kernels
    from ohpipeline_tpu_torch.codecs.mp3 import synthesis as msyn

    got = _kernels.mp3_window(vfull, wnd, bit_depth)
    want = msyn.mp3_window_torch(vfull, wnd, bit_depth)
    torch.cuda.synchronize()
    diff = (got.long() - want.long()).abs()
    err, n_diff = int(diff.max()), int((diff > 0).sum())
    if err > 1:
        raise AssertionError(f"mp3_window kernel vs plain on {name}: {err} "
                             f"LSB ({n_diff} samples differ)")
    ms = kernel_ms(lambda: _kernels.mp3_window(vfull, wnd, bit_depth), 20)
    plain_ms = cuda_ms(lambda: msyn.mp3_window_torch(vfull, wnd, bit_depth),
                       5)
    Tg, B = got.shape[:2]
    lim = float(1 << (bit_depth - 1))
    lib_ms, lib_note = None, ""
    if library:
        lib = mp3_window_library(vfull, wnd)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            y = lib()
            lib_ms = cuda_ms(lib, 20)
        y = (y.permute(2, 0, 1).reshape(Tg, 18, B, 32).transpose(1, 2)
             .reshape(Tg, B, 576))
        lib_err = int((torch.round(y * lim).clamp(-lim, lim - 1).long()
                       - want.long()).abs().max())
        if lib_err > 1:
            raise AssertionError(f"conv1d formulation vs plain on {name}: "
                                 f"{lib_err} LSB")
        lib_note = f", conv1d {lib_ms:.4f} ms (<= {lib_err} LSB)"
    # 16 multiplies and 16 adds a sample
    b_ms, b_by = bound(nbytes(vfull, wnd, got), 32 * got.numel())
    clipped = float(((want == int(lim) - 1) | (want == -int(lim)))
                    .float().mean())
    print(f"phase {phase}: mp3_window {name}: Tg={Tg} B={B} bit depth "
          f"{bit_depth}: <= {err} LSB against plain, {n_diff} of "
          f"{got.numel()} samples differ, {clipped:.3f} at a clip end; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms{lib_note}, bound "
          f"{b_ms * 1e3:.2f} us ({b_by})")
    return err, ms, plain_ms, b_ms, b_by, lib_ms


def tns_worst_case(P=1024, seed=0):
    """P short-window rows with all 24 filter slots in use (3 regions per
    window), order 12, directions alternating between neighbours, stable
    coefficients from 4-bit reflection coefficients shrinking with the tap
    (as an encoder's do); spec is (P, 1024) with row j filtered by pooled
    row j."""
    from ohpipeline_tpu_torch.codecs.aac.synthesis import _lattice_to_lpc

    rng = np.random.default_rng(seed)
    tfi = np.zeros((P, 1024), np.uint8)
    tco = np.zeros((P, 24, 12), np.float32)
    tdir = np.zeros((P, 24), np.uint8)
    lim = np.minimum(7, 8 >> np.minimum(np.arange(12), 2))
    for j in range(P):
        for w in range(8):
            edges = [0, *sorted(rng.choice(np.arange(8, 120), 2,
                                           replace=False)), 128]
            for fi in range(3):
                slot = w * 3 + fi
                qc = rng.integers(-lim, lim + 1)
                refl = np.where(qc >= 0, np.sin(qc / (7.5 / (np.pi / 2))),
                                np.sin(qc / (8.5 / (np.pi / 2))))
                tco[j, slot] = _lattice_to_lpc(refl)
                tdir[j, slot] = (j + w + fi) % 2
                tfi[j, w * 128 + edges[fi]:w * 128 + edges[fi + 1]] = slot + 1
    spec = (rng.standard_normal((P, 1024)) * 3000).astype(np.float32)
    return spec, tfi, tco, tdir, np.arange(P, dtype=np.int32)


TNS_LIMIT_SEEDS = range(100, 106)


def tns_encoder_limits(seed):
    """4 pooled rows, each one 1024-bin run of order 12 (up, down, up,
    down), whose 12 quantised reflection coefficients all sit at the
    encoder's limits (magnitudes 7, 4, then 2 as they shrink with the tap;
    signs drawn from the seed): the filters of the largest gain an encoder
    emits."""
    from ohpipeline_tpu_torch.codecs.aac.synthesis import _lattice_to_lpc

    lim = np.minimum(7, 8 >> np.minimum(np.arange(12), 2))
    rng = np.random.default_rng(seed)
    tfi = np.ones((4, 1024), np.uint8)
    tco = np.zeros((4, 24, 12), np.float32)
    tdir = np.zeros((4, 24), np.uint8)
    tdir[1::2, 0] = 1
    for j in range(4):
        qc = rng.choice([-1, 1], 12) * lim
        refl = np.where(qc >= 0, np.sin(qc / (7.5 / (np.pi / 2))),
                        np.sin(qc / (8.5 / (np.pi / 2))))
        tco[j, 0] = _lattice_to_lpc(refl)
    spec = (rng.standard_normal((4, 1024)) * 3000).astype(np.float32)
    return spec, tfi, tco, tdir, np.arange(4, dtype=np.int32)


def tns_f64(spec, tfi, tco, tdir, trow):
    """The float64 reference apply_tns_zz_reference on these planes, as
    the kernel reads them (slot bytes past 24 inactive, rows past the end
    padding): returns (reference spectra, trow with those rows as -1)."""
    from ohpipeline_tpu_torch.codecs.aac.synthesis import (
        apply_tns_zz_reference)

    tfi = np.where(tfi <= 24, tfi, 0).astype(np.uint8)
    trow = np.where(trow < spec.shape[0], trow, -1)
    return (apply_tns_zz_reference(spec.astype(np.float64), tfi, tco, tdir,
                                   trow), trow)


def tns_row_errs(got, ref, rows) -> np.ndarray:
    """|got - ref| over each row's peak of ref, for the rows ``rows``."""
    got = np.asarray(got, np.float64)[rows]
    ref = np.asarray(ref, np.float64)[rows]
    return np.abs(got - ref).max(1) / np.abs(ref).max(1)


def tns_gate(got, plain, ref, rows) -> tuple:
    """The TNS gate, row by row: got within 1e-5 of the row's peak of the
    float64 reference ref; and within 1e-5 of the plain version, unless the
    plain version is the further of the two from ref (on filters at the
    encoder's limits the plain version drifts up to ~1.1e-5 from float64,
    so a row nearer float64 can be more than 1e-5 from it).  Returns (got's
    and the plain version's worst error against ref, and a list of (row,
    got's error, the plain version's, their distance) for the rows that
    fail)."""
    err = tns_row_errs(got, ref, rows)
    plain_err = tns_row_errs(plain, ref, rows)
    apart = tns_row_errs(got, plain, rows)
    ok = (err <= 1e-5) & ((apart <= 1e-5) | (plain_err > err))
    bad = [(int(r), float(e), float(p), float(d)) for r, e, p, d, o in
           zip(rows, err, plain_err, apart, ok) if not o]
    return float(err.max()), float(plain_err.max()), bad


def check_tns(name, arrays, dev, phase: int = 6):
    """TNS kernel on the card against the float64 reference and its plain
    version (tns_gate); returns (max |err| against the plain version,
    kernel ms, plain ms, bound ms, bound by)."""
    import torch
    from ohpipeline_tpu_torch.codecs.aac import synthesis as asyn

    spec, *pool = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                   for a in arrays]
    got = asyn.apply_tns_zz(spec, *pool)
    want = asyn.tns_scan_torch(spec.clone(), *pool)
    torch.cuda.synchronize()
    ref, inside = tns_f64(*arrays)
    rows = inside[inside >= 0]
    got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
    k_err, p_err, bad = tns_gate(got_np, want_np, ref, rows)
    if bad:
        raise AssertionError(f"tns kernel fails the gate on {name} (row, "
                             f"|err|/peak against float64, the plain "
                             f"version's, the two apart): {bad[:8]}")
    err = np.abs(got_np[rows].astype(np.float64) - want_np[rows]).max(1)
    work = spec.clone()
    ms = kernel_ms(lambda: asyn.tns_scan(work, *pool), 20)
    plain_ms = cuda_ms(lambda: asyn.tns_scan_torch(work, *pool), 2)
    # the rows in use: each read and written once with its pooled planes;
    # per filtered bin one multiply and one add per tap of its slot's order
    _, tfi, tco, _, trow = arrays
    live = trow >= 0
    nz = tco[live] != 0
    order = np.where(nz.any(-1), 12 - np.argmax(nz[..., ::-1], -1), 0)
    slot = tfi[live].astype(np.int64) - 1
    taps = np.take_along_axis(order, np.clip(slot, 0, None), 1) * (slot >= 0)
    n_rows = int(live.sum())
    b_ms, b_by = bound(n_rows * (2 * 1024 * 4 + 1024 + 24 * 12 * 4 + 24 + 4),
                       2 * int(taps.sum()))
    print(f"phase {phase}: tns {name}: {len(rows)} rows of "
          f"{spec.shape[0]} "
          f"within 1e-5 of each row's peak of float64 (worst {k_err:.3g}; "
          f"plain version {p_err:.3g}) and of the plain version unless "
          f"that is the further (max |err| against plain "
          f"{float(err.max()):.4g}); "
          f"kernel {ms:.4f} ms, plain {plain_ms:.2f} ms, bound "
          f"{b_ms * 1e3:.2f} us ({b_by})")
    return float(err.max()), ms, plain_ms, b_ms, b_by


#: Float32 operations the PS scan does per slot of a stream: group powers
#: (3 per member channel, 71 of them, and one add each: 284), the power
#: recurrence (12 per group: 240), the 32 all-pass channels' delay phase,
#: decay ramp and three links (56 each: 1792), the transient factor (2 per
#: channel: 146) and the mix (12 per channel: 876).
PS_OPS_PER_SLOT = 284 + 240 + 1792 + 146 + 876


#: The kernels of the PS scan's three stages (csrc/ps_mix.cu), by name: the
#: group powers, the recurrences (one block a stream), the mix.
PS_STAGES = ("ps_powers", "ps_chains", "ps_mix_out")


def ps_mix_stages(args, reps: int = 10) -> dict:
    """Device ms of one launch of each PS_STAGES kernel on ``args``: the
    mean over the launches of it that a torch.profiler trace of reps
    ps_scan calls records, by kernel name (the trace may miss a launch at
    its start)."""
    from ohpipeline_tpu_torch.codecs.aac import sbr as sbrd
    from ohpipeline_tpu_torch.tools import trace_call

    _prof, events, _ = trace_call(
        lambda: [sbrd.ps_scan(*args) for _ in range(reps)])
    out = {}
    for stage in PS_STAGES:
        spans = [e.time_range.end - e.time_range.start for e in events
                 if stage in e.name]
        if not reps // 2 <= len(spans) <= reps:
            raise AssertionError(f"ps_mix stage {stage}: {len(spans)} "
                                 f"kernels in a trace of {reps} calls")
        out[stage] = sum(spans) / len(spans) / 1e3
    return out


def check_ps_mix(name, args):
    """PS decorrelator kernel against its plain version (ps_scan_torch) on
    the card, bit for bit; returns (max |err|, kernel ms, plain ms, bound
    ms, bound by, chain floor ms: the chains stage alone)."""
    import torch
    from ohpipeline_tpu_torch.codecs.aac import sbr as sbrd

    got = sbrd.ps_scan(*args)
    want = sbrd.ps_scan_torch(*args)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"ps_mix kernel != plain on {name} (max |err| "
                             f"{err:.4g})")
    ms = kernel_ms(lambda: sbrd.ps_scan(*args), 20)
    stages = ps_mix_stages(args)
    plain_ms = cuda_ms(lambda: sbrd.ps_scan_torch(*args), 1)
    C, S = args[0].shape[:2]
    b_ms, b_by = bound(nbytes(*args, *got), PS_OPS_PER_SLOT * C * S)
    split = ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
    print(f"phase 15: ps_mix {name}: C={C} S={S} bit-exact; kernel "
          f"{ms:.4f} ms (stages, traced: {split} ms; chain floor, the "
          f"chains stage: {stages['ps_chains']:.4f}), plain "
          f"{plain_ms:.1f} ms, bound {b_ms * 1e3:.2f} us ({b_by})")
    return err, ms, plain_ms, b_ms, b_by, stages["ps_chains"]


def serve_ps(contents: list, device) -> tuple:
    """The PS streams ``contents`` (ps_content) through one
    SbrPsDeviceRunner each in spec mode, PS_GROUP frames a group, one
    group in flight: every stream's group g is queued, then group g - 1's
    PCM copied back.  Returns ([(2, F * 2048) int16 per stream], wall s)."""
    import torch
    from ohpipeline_tpu_torch.codecs.aac import sbr as sbrd

    t0 = time.perf_counter()
    runners = [sbrd.SbrPsDeviceRunner(c["dec"], device=device)
               for c in contents]
    zeros = np.zeros(1024, np.float32)
    outs = [[] for _ in contents]
    pending = []
    for g0 in range(0, len(contents[0]["datas"]), PS_GROUP):
        sl = slice(g0, g0 + PS_GROUP)
        queued = [r.decode_group_lazy_spec(
            c["specs"][sl], c["ops"][sl], c["datas"][sl], c["Es"][sl],
            c["Qs"][sl], c["ps"][sl], zeros)
            for r, c in zip(runners, contents)]
        for o, resolve in zip(outs, pending):
            o.append(resolve())
        pending = queued
    for o, resolve in zip(outs, pending):
        o.append(resolve())
    if device != "cpu":
        torch.cuda.synchronize()
    return ([np.concatenate(o, axis=1) for o in outs],
            time.perf_counter() - t0)


def plugin_decode(path: str, device) -> tuple:
    """The ADTS codec plug-in (CodecAacAdts) over the file ``path`` on
    ``device``: returns (stream info, (channels, n) int32 PCM, the codec)."""
    import torch
    from ohpipeline_tpu_torch.codecs import aac
    from ohpipeline_tpu_torch.host.codecs.base import (BufferReader,
                                                       EndOfStream)

    with open(path, "rb") as f:
        reader = BufferReader(f.read())
    codec = aac.CodecAacAdts(device=device)
    info = codec.stream_initialise(reader)
    parts = []
    while True:
        try:
            parts.append(codec.process(reader).resolve())
        except EndOfStream:
            break
    if device != "cpu":
        torch.cuda.synchronize()
    return info, np.concatenate(parts, axis=1), codec


class Sink:
    """An animator's sink that keeps what it is given: the rendered (ch, n)
    chunks and their stream infos."""

    def __init__(self):
        self.chunks, self.infos = [], []

    def __call__(self, samples, info) -> None:
        self.chunks.append(samples)
        self.infos.append(info)

    @property
    def samples(self) -> int:
        return sum(c.shape[1] for c in self.chunks)

    @property
    def pcm(self) -> np.ndarray:
        return (np.concatenate(self.chunks, axis=1) if self.chunks
                else np.zeros((2, 0), np.int32))


def render_params(params):
    """``params`` (a PipelineInitParams of the port or of the JAX package)
    set as the JAX package's end-to-end tests set them
    (tests/test_pipeline_e2e.py make_manager): no gorge, and the starvation
    ramper pulled inline, so a run is the same event for event each time."""
    params.gorge_jiffies = 0
    params.threaded_starvation_ramper = False
    return params


def ramp_play(mgr, animator, uri: str, before: int) -> None:
    """Plays ``uri`` through ``mgr`` (a PipelineManager of the port or of the
    JAX package) into ``animator`` (an AnimatorBatch on its render chain)
    with a pause after ``before`` pulled events: the Stopper's down ramp is
    pulled one event at a time until it has paused, then a play ramps up
    and the track plays to its end.  Both ramps pass through the animator's
    RenderBatcher."""
    mgr.play_uri(uri)
    animator.run(max_events=before)
    mgr.pause()
    while mgr.pipeline.stopper.state.value != "paused":
        animator.run(max_events=1)
    mgr.play()
    animator.run()


def render_play(path: str, device, ramp_before: int = 0):
    """Plays the file ``path`` through the port's PipelineManager and an
    AnimatorBatch on ``device`` (with a pause and play, through
    :func:`ramp_play`, when ``ramp_before``).  Returns (sink, wall seconds,
    the animator's RenderBatcher)."""
    import torch
    from ohpipeline_tpu_torch import pipeline

    mgr = pipeline.PipelineManager(
        render_params(pipeline.PipelineInitParams()), device=device)
    try:
        sink = Sink()
        anim = pipeline.AnimatorBatch(mgr.pipeline.predriver, sink,
                                      device=device)
        t0 = time.perf_counter()
        if ramp_before:
            ramp_play(mgr, anim, f"file://{path}", ramp_before)
        else:
            mgr.play_uri(f"file://{path}")
            anim.run()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        return sink, time.perf_counter() - t0, anim.batcher
    finally:
        mgr.quit()


def realtime_play(path: str, device, n: int, limit_s: float = 30.0):
    """Plays ``path`` through the port's PipelineManager with the default
    PipelineInitParams into an AnimatorBasic(realtime=True, quantum_ms=5)
    on ``device`` until its sink has ``n`` samples of the decoded track or
    ``limit_s`` passed, then stops it.  Returns (the decoded track's samples
    the sink got, the samples the starvation ramper put in between (its
    flywheel ramp and silence while the decoded reservoir ran dry), the
    animator, wall seconds); raises if the animator does not end.  A chunk
    is the track's when it is the sample array of an audio event the pump
    pushed into the decoded reservoir, which a unity gain passes through."""
    from ohpipeline_tpu_torch import pipeline

    mgr = pipeline.PipelineManager(device=device)
    sink = Sink()
    decoded = set()
    push = mgr.pipeline.decoded.push

    def recording_push(e):
        if e.kind == "audio_pcm":
            decoded.add(id(e.samples))
        push(e)

    mgr.pipeline.decoded.push = recording_push
    anim = pipeline.AnimatorBasic(mgr.pipeline.predriver, sink,
                                  quantum_ms=5, device=device,
                                  realtime=True)

    def track():
        return [c for c in list(sink.chunks) if id(c) in decoded]

    t0 = time.perf_counter()
    try:
        mgr.play_uri(f"file://{path}")
        anim.start()
        while sum(c.shape[1] for c in track()) < n and anim.is_alive() \
                and time.perf_counter() - t0 < limit_s:
            time.sleep(0.01)
    finally:
        anim.quit()
        mgr.quit()
        anim.join(10.0)
    wall = time.perf_counter() - t0
    if anim.is_alive():
        raise AssertionError("the realtime animator did not end")
    got = track()
    pcm = (np.concatenate(got, axis=1) if got
           else np.zeros((2, 0), np.int32))
    return pcm, sink.samples - pcm.shape[1], anim, wall


class TrackIds:
    """A pipeline observer that keeps the id of each track the pipeline's
    Reporter announces, in order."""

    def __init__(self):
        self.ids = []

    def notify_track(self, track, start_of_stream: bool) -> None:
        self.ids.append(track.id)


def media_player(device, volume: int = 100, setup=None):
    """The port's MediaPlayer on ``device`` with the JAX end-to-end tests'
    pipeline params (:func:`render_params`), started (the Playlist source is
    current), Volume.Limit 100 and the volume at ``volume``: 100 is unity
    gain, so the render chain's gain pass has nothing to do.  ``setup``
    (player) is called before the start (to add a source)."""
    from ohpipeline_tpu_torch import av, pipeline

    player = av.MediaPlayer(av.MediaPlayerInitParams(
        pipeline_params=render_params(pipeline.PipelineInitParams())),
        device=device)
    try:
        if setup is not None:
            setup(player)
        player.start()
        player.config.get("Volume.Limit").set(100)
        player.volumes.set_volume(volume)
    except BaseException:
        player.quit()
        raise
    return player


def playlist(paths):
    """A start for :func:`player_run`: inserts ``paths`` (files) into the
    Playlist source's track database in order and plays from the first;
    returns their database ids."""

    def start(player) -> list:
        ids, after = [], 0
        for path in paths:
            after = player.source_playlist.db.insert(after, f"file://{path}")
            ids.append(after)
        player.source_playlist.seek_id(ids[0])
        return ids

    return start


def player_run(player, start, midway: Optional[tuple] = None,
               animator=None):
    """Calls start(player) and runs an AnimatorBatch on the player's device
    to the pipeline's halt, then quits the player.  With ``midway`` (n,
    action), the animator pulls n events, action(player) is called (a mute,
    say) and the run goes on.  ``animator(upstream, sink)`` builds another
    animator (the JAX package's, for a MediaPlayer of the JAX package).
    Returns (sink, wall seconds, the animator's RenderBatcher, the ids of
    the tracks the pipeline announced, start's result, the samples the sink
    had when the action was called)."""
    import torch
    from ohpipeline_tpu_torch import pipeline

    try:
        sink, tracks = Sink(), TrackIds()
        player.pipeline.add_observer(tracks)
        upstream = player.pipeline.pipeline.predriver
        anim = (animator(upstream, sink) if animator else
                pipeline.AnimatorBatch(upstream, sink, device=player.device))
        t0 = time.perf_counter()
        started = start(player)
        acted_at = None
        if midway:
            anim.run(max_events=midway[0])
            acted_at = sink.samples
            midway[1](player)
        anim.run()
        if getattr(player, "device", torch.device("cpu")).type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        player.pipeline.flush_observers()
    finally:
        player.quit()
    return sink, wall, anim.batcher, tracks.ids, started, acted_at


def stream_pcm(sink) -> list:
    """The sink's output split at each change of stream: a list of (stream
    info, (channels, samples) PCM)."""
    out = []
    for chunk, info in zip(sink.chunks, sink.infos):
        if out and out[-1][0] is info:
            out[-1][1].append(chunk)
        else:
            out.append((info, [chunk]))
    return [(info, np.concatenate(chunks, axis=1)) for info, chunks in out]


def count_calls(module, name: str, run) -> tuple:
    """Runs run() with ``module.name`` wrapped, for that time only, to count
    its calls.  Returns (run()'s result, the count)."""
    real = getattr(module, name)
    calls = [0]

    def counted(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    setattr(module, name, counted)
    try:
        result = run()
    finally:
        setattr(module, name, real)
    return result, calls[0]


def mp3_with_xing(data: bytes) -> bytes:
    """``data`` (CBR MP3 frames) behind a Xing frame, made as
    tests/test_mp3_vbr_seek.py makes it: the stream's first frame with a
    Xing header (frame count, byte count and a linear TOC, which is true of
    CBR content) written over its main data.  A player reads the duration
    from it, seeks through the TOC and decodes no audio from it."""
    from ohpipeline_tpu_torch._host import mp3_bitstream as BS

    hdr = BS.parse_frame_header(data)
    frames = pos = 0
    while True:
        h = BS.parse_frame_header(data, pos)
        if h is None or pos + h.frame_bytes > len(data):
            break
        frames += 1
        pos += h.frame_bytes
    frame = bytearray(data[:hdr.frame_bytes])
    side = 32 if (hdr.version == 1 and hdr.channels == 2) else (
        17 if hdr.version == 1 or hdr.channels == 2 else 9)
    xing = (b"Xing" + (1 | 2 | 4).to_bytes(4, "big")
            + frames.to_bytes(4, "big")
            + (hdr.frame_bytes + len(data)).to_bytes(4, "big")
            + bytes(min(255, int(i * 2.56)) for i in range(100)))
    frame[4 + side:4 + side + len(xing)] = xing
    return bytes(frame) + data


def aac_asc(rate_index: int, channels: int, sbr: bool = False) -> bytes:
    """An AudioSpecificConfig: AOT 2 (AAC-LC) at the core's rate, or with
    ``sbr`` the explicit AOT-5 hierarchy (the extension at twice the core
    rate, then core AOT 2), as tests/test_sbr.py:256-260 builds it."""
    if sbr:
        bits = (f"00101{rate_index:04b}{channels:04b}{rate_index - 3:04b}"
                f"00010000")
    else:
        bits = f"00010{rate_index:04b}{channels:04b}000"
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def m4a_from_adts(path: str, sbr: bool = False) -> bytes:
    """The raw frames of the ADTS file ``path`` in an M4A
    (host/containers/mpeg4.write_m4a) at the core's rate, with an AAC-LC
    config (for an HE-AAC core the implicit signalling: the decoder finds
    SBR in the first sample), or with ``sbr`` the explicit AOT-5 config."""
    from ohpipeline_tpu_torch._host import aac_bitstream as BS
    from ohpipeline_tpu_torch._host import aac_tables
    from ohpipeline_tpu_torch.host.containers.mpeg4 import write_m4a

    with open(path, "rb") as f:
        data = f.read()
    frames, pos, hdr = [], 0, None
    while (h := BS.parse_adts_header(data, pos)) is not None:
        hdr = h
        frames.append(data[pos + h.header_bytes:pos + h.frame_bytes])
        pos += h.frame_bytes
    asc = aac_asc(hdr.rate_index, hdr.channels, sbr)
    return write_m4a(frames, asc, aac_tables.SAMPLE_RATES[hdr.rate_index],
                     hdr.channels)


def opus_mp4(ogg_data: bytes) -> bytes:
    """The audio packets of an Ogg Opus stream muxed into an M4A with a dOps
    box made from its OpusHead, as tests/test_opus_mp4.py:62-78 does."""
    from ohpipeline_tpu_torch._host import base, ogg, opus_headers
    from ohpipeline_tpu_torch.host.containers.mpeg4 import write_m4a

    head_pk, _tags, *audio = ogg.OggReader(
        base.BufferReader(ogg_data)).packets()
    head = opus_headers.parse_opus_head(head_pk)
    dops = (bytes([0, head.channels]) + head.pre_skip.to_bytes(2, "big")
            + head.input_rate.to_bytes(4, "big")
            + head.output_gain_q8.to_bytes(2, "big", signed=True)
            + bytes([head.mapping_family]))
    return write_m4a(audio, dops, 48000, head.channels, codec="Opus",
                     samples_per_frame=960)


def alac_escape_packet(pcm: np.ndarray) -> bytes:
    """One ALAC packet holding ``pcm`` ((channels, n) int16 range, n at most
    ALAC_FRAME) as an escape (verbatim) element, SCE or CPE, with the
    sample count written when the packet is short, then END."""
    nch, n = pcm.shape

    def bits(v: int, width: int) -> np.ndarray:
        return (v >> np.arange(width - 1, -1, -1)) & 1

    partial = n < ALAC_FRAME
    head = [bits(1 if nch == 2 else 0, 3), bits(0, 4), bits(0, 12),
            bits(8 * partial + 1, 4)]           # partial, no shift, escape
    if partial:
        head.append(bits(n, 32))
    body = np.unpackbits(np.ascontiguousarray(pcm.T).astype(">i2")
                         .view(np.uint8))
    stream = np.concatenate([*head, body, bits(7, 3)]).astype(np.uint8)
    return np.packbits(stream).tobytes()


def alac_escape_stream(seed: int, seconds: float = ALAC_SECONDS,
                       rate: int = 44100) -> tuple:
    """A seeded stereo tone (a sine a channel at seeded pitch and level,
    plus noise) as ALAC escape packets of ALAC_FRAME samples in an M4A.
    Returns (the M4A bytes, the (2, n) int32 PCM it holds).  The repository
    has no ALAC encoder, and escape frames are the ALAC frames a test can
    write."""
    import struct

    from ohpipeline_tpu_torch.host.containers.mpeg4 import write_m4a

    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * rate)) / rate
    pcm = np.stack([rng.uniform(4000, 20000)
                    * np.sin(2 * np.pi * rng.uniform(200, 2000) * t)
                    + rng.normal(0, 300, t.size) for _ in range(2)])
    pcm = np.clip(np.rint(pcm), -32768, 32767).astype(np.int32)
    packets = [alac_escape_packet(pcm[:, i:i + ALAC_FRAME])
               for i in range(0, pcm.shape[1], ALAC_FRAME)]
    cookie = struct.pack(">IBBBBBBHIII", ALAC_FRAME, 0, 16, 40, 10, 14, 2,
                         255, 0, 0, rate)
    return write_m4a(packets, cookie, rate, 2, codec="alac",
                     samples_per_frame=ALAC_FRAME), pcm


def silk_packets(seed: int, n: int = SILK_PACKETS) -> list:
    """Seeded SILK-only Opus packets, one frame each: packet k's TOC config
    is k mod 12 (NB, MB and WB at 10, 20, 40 and 60 ms), its stereo flag
    and its 20-100 payload bytes come from the seed.  The range decoder
    reads any bytes as SILK parameters; the repository has no SILK
    encoder."""
    rng = np.random.default_rng(seed)
    return [bytes([(k % 12) << 3 | int(rng.integers(0, 2)) << 2])
            + rng.integers(0, 256, int(rng.integers(20, 101)),
                           dtype=np.uint8).tobytes() for k in range(n)]


def opus_ogg(packets: list, channels: int = 2, pre_skip: int = 312,
             serial: int = 1) -> bytes:
    """Opus ``packets`` in an Ogg stream behind an OpusHead (family 0) and
    an OpusTags packet, the last page's granule their length plus the
    pre-skip."""
    from ohpipeline_tpu_torch._host import ogg, opus_headers

    head = (b"OpusHead" + bytes([1, channels])
            + pre_skip.to_bytes(2, "little") + (48000).to_bytes(4, "little")
            + bytes(3))
    vendor = b"ohpipeline_tpu_torch"
    tags = (b"OpusTags" + len(vendor).to_bytes(4, "little") + vendor
            + bytes(4))
    granule = pre_skip + sum(opus_headers.packet_samples(p)
                             for p in packets)
    return (ogg.build_pages(serial, [head], bos=True)
            + ogg.build_pages(serial, [tags], first_sequence=1)
            + ogg.build_pages(serial, packets, first_sequence=2,
                              granule=granule, eos=True))


def plugin_run(codec, data: bytes, seek: Optional[tuple] = None,
               eos=None) -> tuple:
    """Runs the codec plug-in ``codec`` (the port's, or with ``eos`` its
    EndOfStream class, the JAX package's) over ``data`` as the codec
    controller does: stream_initialise, then process() and each batch's
    resolve() to the end of the stream.  With ``seek`` (batches before it,
    sample), after that many batches it calls try_seek(sample) and moves the
    reader to the byte returned, as the controller and a seekable protocol
    do.  Returns (stream info, [(track offset, (channels, n) PCM) of each
    batch])."""
    from ohpipeline_tpu_torch.host.codecs.base import (BufferReader,
                                                       EndOfStream)

    eos = eos or EndOfStream
    reader = BufferReader(data)
    info = codec.stream_initialise(reader)
    out = []
    while True:
        if seek and len(out) == seek[0]:
            byte = codec.try_seek(seek[1])
            if byte is None or not reader.try_seek_bytes(byte):
                raise AssertionError(f"seek to sample {seek[1]} refused")
        try:
            batch = codec.process(reader)
        except eos:
            return info, out
        out.append((batch.track_offset_samples, batch.resolve()))


#: phase 18's files: name -> card vs CPU gate in LSB (0 for the host-only
#: plug-ins, whose output must not depend on the device)
PLUGIN_GATES = {"mp3": 1, "mp3_xing": 1, "m4a_lc": 1, "m4a_he": 2,
                "vorbis": 0, "opus": 0, "opus_mp4": 0, "alac": 0, "silk": 0}


def plugin_files(content: dict) -> tuple:
    """Phase 18's content, each as the bytes of a file: phase 13's first MP3
    stream (8 s CBR) and the same frames behind a Xing frame; dryrun.aac's
    89 frames (AAC-LC, ASC 0x12 0x10) and dryrun_he.aac's 46 (the explicit
    AOT-5 ASC) in M4As; phase 14's first mixed-block Vorbis stream;
    dryrun.opus, and its packets in an M4A with a dOps box; a seeded stereo
    tone as ALAC escape frames in an M4A; seeded SILK-mode Opus packets in
    Ogg.  Returns ({name: bytes}, the ALAC file's PCM)."""
    with open(CELT_ASSET, "rb") as f:
        opus = f.read()
    alac, alac_pcm = alac_escape_stream(0)
    mp3 = content["mp3"][0]
    return {"mp3": mp3, "mp3_xing": mp3_with_xing(mp3),
            "m4a_lc": m4a_from_adts(AAC_ASSET),
            "m4a_he": m4a_from_adts(HE_ASSET, True),
            "vorbis": content["vorbis"][VORBIS_STREAMS // 2], "opus": opus,
            "opus_mp4": opus_mp4(opus), "alac": alac,
            "silk": opus_ogg(silk_packets(0))}, alac_pcm


def plugin_phase(content: dict, device="cuda") -> tuple:
    """Phase 18: every other plug-in of the registry through the render
    path.  Each of plugin_files' files plays through
    PipelineManager(device).play_uri and an AnimatorBatch on the card and
    on the CPU: the same stream info and length, the card within
    PLUGIN_GATES of the CPU (equal for the host-only plug-ins), the ALAC
    file equal to its input.  A warm play of each gives its decoded s per
    wall s and its kernels' launches: mp3_window once a CodecMp3 group
    (ceil(frames / 16)), sbr_env on the HE M4A, no tns on the LC M4A (the
    plug-in runs TNS in its host prep).  The Xing file is decoded through
    CodecMp3 with a seek to MP3_SEEK_S after 3 groups (plugin_run), card
    against CPU; a traced MP3 play gives the card's idle share.  Returns
    (check_mp3_window's record at the plug-in's group shape, the launches
    of all the warm plays)."""
    from ohpipeline_tpu_torch import _kernels
    from ohpipeline_tpu_torch._host import mp3_bitstream
    from ohpipeline_tpu_torch.codecs import mp3 as mp3_codec
    from ohpipeline_tpu_torch.codecs.mp3 import synthesis as msyn
    from ohpipeline_tpu_torch.tools import trace_call

    files, alac_pcm = plugin_files(content)
    mp3_frames = 0
    stream = mp3_bitstream.Mp3Stream(files["mp3"])
    while stream.next_frame() is not None:
        mp3_frames += 1
    mp3_groups = -(-mp3_frames // mp3_codec.GROUP_FRAMES)
    launches = {k: 0 for k in _kernels.launches}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, data in files.items():
            paths[name] = os.path.join(tmp, name)
            with open(paths[name], "wb") as f:
                f.write(data)
        (first, _, _), seen = first_calls(
            msyn, ["mp3_window"], lambda: render_play(paths["mp3"], device))
        plays = []
        for name, gate in PLUGIN_GATES.items():
            card = first if name == "mp3" else render_play(paths[name],
                                                           device)[0]
            cpu = render_play(paths[name], "cpu")[0]
            ci, pi = card.infos[0], cpu.infos[0]
            if card.pcm.shape != cpu.pcm.shape or ci != pi \
                    or not card.pcm.any():
                raise AssertionError(f"phase 18 {name}: card "
                                     f"{card.pcm.shape} {ci} != cpu "
                                     f"{cpu.pcm.shape} {pi}")
            lsb = int(np.abs(card.pcm.astype(np.int64) - cpu.pcm).max())
            if lsb > gate:
                raise AssertionError(f"phase 18 {name}: card vs CPU {lsb} "
                                     f"LSB, gate {gate}")
            if name == "alac" and not np.array_equal(card.pcm, alac_pcm):
                raise AssertionError("phase 18 alac: output != its input")
            # a warm play: its wall and its launches alone
            before = dict(_kernels.launches)
            (warm, wall, _), groups = count_calls(
                mp3_codec, "decode_frames_lazy",
                lambda: render_play(paths[name], device))
            got = {k: _kernels.launches[k] - before[k] for k in before}
            for k, v in got.items():
                launches[k] += v
            if not np.array_equal(warm.pcm, card.pcm):
                raise AssertionError(f"phase 18 {name}: warm play != first")
            if name.startswith("mp3") and not (
                    got["mp3_window"] == groups == mp3_groups):
                raise AssertionError(f"phase 18 {name}: {got['mp3_window']} "
                                     f"mp3_window launches for {groups} "
                                     f"groups, want {mp3_groups}")
            if name == "m4a_he" and got["sbr_env"] <= 0:
                raise AssertionError("phase 18: sbr_env did not run on the "
                                     "HE M4A")
            if name == "m4a_lc" and got["tns"] != 0:
                raise AssertionError(f"phase 18: {got['tns']} tns launches "
                                     f"on the LC M4A")
            secs = card.pcm.shape[1] / ci.sample_rate
            plays.append(f"{name} ({ci.codec_name}, {ci.num_channels} ch, "
                         f"{secs:.2f} s) <= {lsb} LSB, warm "
                         f"{secs / wall:.1f} decoded s per wall s, launches "
                         f"{ {k: v for k, v in got.items() if v} }")
        print("phase 18: through PipelineManager.play_uri and AnimatorBatch, "
              "card vs cpu: " + "; ".join(plays))
        # a seek through the plug-in, card against CPU
        target = int(MP3_SEEK_S * first.infos[0].sample_rate)
        spf = mp3_bitstream.parse_frame_header(files["mp3"]).samples_per_frame
        runs = {}
        for dev in (device, "cpu"):
            runs[dev] = plugin_run(mp3_codec.CodecMp3(device=dev),
                                   files["mp3_xing"], seek=(3, target))[1]
        card_run, cpu_run = runs[device], runs["cpu"]
        offs = [o for o, _ in card_run]
        if offs != [o for o, _ in cpu_run] or offs[3] != target // spf * spf \
                or any(a.shape != b.shape for (_, a), (_, b)
                       in zip(card_run, cpu_run)):
            raise AssertionError(f"phase 18 seek: card offsets {offs}, cpu "
                                 f"{[o for o, _ in cpu_run]}")
        seek_lsb = max(int(np.abs(a.astype(np.int64) - b).max())
                       for (_, a), (_, b) in zip(card_run, cpu_run))
        if seek_lsb > 1:
            raise AssertionError(f"phase 18 seek: card vs CPU {seek_lsb} LSB")
        print(f"phase 18: CodecMp3 over the Xing file with a seek to "
              f"{MP3_SEEK_S} s after 3 groups: {len(offs)} groups, the "
              f"first after the seek at sample {offs[3]}, card vs cpu <= "
              f"{seek_lsb} LSB")
        _prof, _events, trace = trace_call(
            lambda: render_play(paths["mp3"], device))
        print(f"phase 18: traced MP3 play {trace['wall_s']:.3f} s, device "
              f"busy {trace['device_busy_ms']:.2f} ms, idle share "
              f"{trace['idle_share']:.4f}")
    vfull, wnd, bd = seen["mp3_window"][0]
    return check_mp3_window("CodecMp3 group 0", vfull, wnd, bd,
                            phase=18), launches


def render_phase(jobs, tracks, streams, device="cuda") -> tuple:
    """Phase 17: the port's render path on ``device``, through
    PipelineManager.play_uri, the codec controller, AnimatorBatch and its
    RenderBatcher.  Phase 0's first CD and first 24-bit / 96 kHz streams
    play bit-exact to the encoder input, with the LPC launches of a warm run
    equal to the FLAC groups the plug-in resolved, the device's idle share
    of a traced play and each play's wall; a play paused and played again
    (both ramps through the RenderBatcher) equals the same play on the CPU
    bit for bit; the ADTS assets are held to the CPU (<= 1 and <= 2 LSB) with
    sbr_env launched; a 3 s cut of the CD track plays through a realtime
    AnimatorBasic with the default params (its late quanta are printed).
    Returns (check_lpc's record for the LPC kernel on the first group's
    rows of the render path, the launches of the warm FLAC plays and the
    ADTS plays)."""
    from ohpipeline_tpu_torch import _kernels
    from ohpipeline_tpu_torch._host import encode_flac
    from ohpipeline_tpu_torch.codecs import flac as flac_codec
    from ohpipeline_tpu_torch.ops import lpc as lpc_ops
    from ohpipeline_tpu_torch.tools import trace_call

    hi = len(CD_SEEDS)                  # the first 24-bit / 96 kHz stream
    render = []
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, i in (("cd", 0), ("hires", hi)):
            paths[name] = os.path.join(tmp, f"{name}.flac")
            with open(paths[name], "wb") as f:
                f.write(streams[i])
        # first plays: bit-exact, and the LPC rows of the first group
        (sink, cd_first, _), seen = first_calls(
            lpc_ops, ["lpc_synthesize"],
            lambda: render_play(paths["cd"], device))
        render_lpc = list(seen["lpc_synthesize"][0])
        for name, i in (("cd", 0), ("hires", hi)):
            if name != "cd":
                sink, _, _ = render_play(paths[name], device)
            if sink.pcm.shape != tracks[i].shape \
                    or not np.array_equal(sink.pcm, tracks[i]):
                raise AssertionError(f"render path {name}: output != "
                                     f"encoder input")
        # warm plays, with the kernels' launches of that run alone
        _kernels.reset_launches()
        walls, groups = {}, 0
        for name in ("cd", "hires"):
            (_sink, walls[name], _), n = count_calls(
                flac_codec, "synthesise_batch",
                lambda: render_play(paths[name], device))
            groups += n
        render_launches = dict(_kernels.launches)
        if render_launches["lpc"] != groups or groups == 0:
            raise AssertionError(f"render path: {render_launches['lpc']} lpc "
                                 f"launches for {groups} FLAC groups")
        for name, i in (("cd", 0), ("hires", hi)):
            rate = jobs[i][2]
            render.append(f"{name} {tracks[i].shape} bit-exact, warm wall "
                          f"{walls[name]:.3f} s, "
                          f"{tracks[i].shape[1] / rate / walls[name]:.1f} "
                          f"decoded s per wall s")
        print(f"phase 17: FLAC through PipelineManager.play_uri and "
              f"AnimatorBatch on the card: {'; '.join(render)} (first CD "
              f"play {cd_first:.3f} s); {groups} FLAC groups, launches "
              f"{render_launches}")
        _prof, _events, render_trace = trace_call(
            lambda: render_play(paths["cd"], device))
        print(f"phase 17: traced CD play {render_trace['wall_s']:.3f} s, "
              f"device busy {render_trace['device_busy_ms']:.2f} ms, idle "
              f"share {render_trace['idle_share']:.4f}")
        # the pause and play ramps through RenderBatcher: card == CPU
        ramp_card, _, batcher = render_play(paths["cd"], device,
                                            ramp_before=4)
        ramp_cpu, _, _ = render_play(paths["cd"], "cpu", ramp_before=4)
        if batcher.gain_tiles == 0:
            raise AssertionError("the ramp run rendered no non-unity tile")
        if not np.array_equal(ramp_card.pcm, ramp_cpu.pcm):
            raise AssertionError("ramp run on the card != on the CPU")
        ramped = int((ramp_card.pcm != tracks[0]).any(0).sum())
        print(f"phase 17: pause and play ramps: {ramp_card.pcm.shape} card "
              f"== cpu bit for bit; {batcher.gain_tiles} non-unity tiles, "
              f"{ramped} samples ramped")
        # the ADTS plug-in through the pipeline, card against CPU
        _kernels.reset_launches()
        plays = []
        for path, lsb_max in ((AAC_ASSET, 1), (HE_ASSET, 2)):
            card, _, _ = render_play(path, device)
            cpu, _, _ = render_play(path, "cpu")
            ci, pi = card.infos[0], cpu.infos[0]
            if card.pcm.shape != cpu.pcm.shape \
                    or (ci.codec_name, ci.sample_rate) \
                    != (pi.codec_name, pi.sample_rate):
                raise AssertionError(f"render path {path}: card "
                                     f"{card.pcm.shape} != cpu "
                                     f"{cpu.pcm.shape}")
            lsb = int(np.abs(card.pcm.astype(np.int64) - cpu.pcm).max())
            if lsb > lsb_max:
                raise AssertionError(f"render path {path}: card vs CPU "
                                     f"{lsb} LSB")
            plays.append(f"{os.path.basename(path)} ({ci.codec_name}) "
                         f"{card.pcm.shape} <= {lsb} LSB")
        played = {k: render_launches[k] + v
                  for k, v in _kernels.launches.items()}
        aac_launches = {k: _kernels.launches[k] for k in ("sbr_env", "tns")}
        if aac_launches["sbr_env"] <= 0:
            raise AssertionError("the sbr_env kernel did not run on the "
                                 "render path")
        print(f"phase 17: ADTS through the pipeline, card vs cpu: "
              f"{'; '.join(plays)}; launches {aac_launches} (the plug-in "
              f"runs TNS in its host prep, as the JAX one does)")
        # a short realtime run: AnimatorBasic with the default params
        rt_track = tracks[0][:, :3 * 44100]
        paths["rt"] = os.path.join(tmp, "rt.flac")
        with open(paths["rt"], "wb") as f:
            f.write(encode_flac(rt_track, 44100, 16))
        rt_pcm, rt_fill, rt_anim, rt_wall = realtime_play(
            paths["rt"], device, rt_track.shape[1])
        if not np.array_equal(rt_pcm, rt_track[:, :rt_pcm.shape[1]]) \
                or rt_pcm.shape[1] < rt_track.shape[1]:
            raise AssertionError(f"realtime run delivered {rt_pcm.shape}, "
                                 f"not the track")
        print(f"phase 17: realtime AnimatorBasic (5 ms quanta, default "
              f"params) delivered the 3 s track in {rt_wall:.3f} s, with "
              f"{rt_fill} samples of starvation fill; late quanta "
              f"{rt_anim.late_quanta}, worst lateness "
              f"{rt_anim.worst_late_s * 1e3:.3f} ms")
    return check_lpc("render path group 0", render_lpc, phase=17), played


#: phase 20's playlist: name -> the card's gate against the CPU at volume 50
#: in LSB (FLAC bit for bit, as phase 17's ramp run)
PLAYER_GATES = {"cd": 0, "hires": 0, "mp3": 1, "he": 2}
PLAYER_CODECS = ["FLAC", "FLAC", "MP3", "HE-AAC"]


def player_files(tmp: str, streams, mstreams) -> list:
    """Phase 20's playlist as files in ``tmp``: phase 0's first CD and
    first 24-bit / 96 kHz FLAC streams, phase 13's first MP3 stream and
    tests/assets/dryrun_he.aac (HE-AAC v1)."""
    paths = []
    for name, data in (("cd.flac", streams[0]),
                       ("hires.flac", streams[len(CD_SEEDS)]),
                       ("mp3.mp3", mstreams[0])):
        paths.append(os.path.join(tmp, name))
        with open(paths[-1], "wb") as f:
            f.write(data)
    return paths + [HE_ASSET]


def radio_uri(path: str):
    """A start for :func:`player_run`: the Radio source plays ``path``."""

    def start(player) -> None:
        player.product.set_source_by_name("Radio")
        player.source_radio.play_uri(f"file://{path}")

    return start


def media_player_phase(tracks, streams, mstreams, device="cuda") -> tuple:
    """Phase 20: the Av layer's MediaPlayer on ``device`` (see the module
    docstring).  Returns ({kernel: (args, result) of its first launch in
    the first play}, the kernels' launches in the counted play, the unity
    play and the CPU's play at volume 50: {track name: (stream info,
    PCM)})."""
    import torch
    from ohpipeline_tpu_torch import _kernels
    from ohpipeline_tpu_torch._host import mp3_bitstream
    from ohpipeline_tpu_torch.codecs import flac as flac_codec
    from ohpipeline_tpu_torch.codecs import mp3 as mp3_codec
    from ohpipeline_tpu_torch.codecs.aac import sbr as sbrd
    from ohpipeline_tpu_torch.codecs.mp3 import synthesis as msyn
    from ohpipeline_tpu_torch.ops import lpc as lpc_ops
    from ohpipeline_tpu_torch.ops import pcm as pcm_ops
    from ohpipeline_tpu_torch.tools import trace_call

    stream, mp3_frames = mp3_bitstream.Mp3Stream(mstreams[0]), 0
    while stream.next_frame() is not None:
        mp3_frames += 1
    mp3_groups = -(-mp3_frames // mp3_codec.GROUP_FRAMES)
    flac_tracks = {"cd": tracks[0], "hires": tracks[len(CD_SEEDS)]}
    t_phase = time.perf_counter()

    def outputs(sink, track_ids, ids, what: str) -> dict:
        parts = stream_pcm(sink)
        if [i.codec_name for i, _ in parts] != PLAYER_CODECS \
                or track_ids != ids or len(ids) != len(PLAYER_GATES):
            raise AssertionError(
                f"phase 20 {what}: streams "
                f"{[i.codec_name for i, _ in parts]}, tracks {track_ids} "
                f"for playlist ids {ids}")
        return dict(zip(PLAYER_GATES, parts))

    with tempfile.TemporaryDirectory() as tmp:
        paths = player_files(tmp, streams, mstreams)
        start = playlist(paths)
        # the first play, at unity: the FLAC tracks are the encoder input
        first, seen = first_calls_of(
            [(lpc_ops, "lpc_synthesize"), (msyn, "mp3_window"),
             (sbrd, "envelope_scan")],
            lambda: player_run(media_player(device), start))
        unity = outputs(first[0], first[3], first[4], "unity")
        for name, track in flac_tracks.items():
            if not np.array_equal(unity[name][1], track):
                raise AssertionError(f"phase 20 unity: {name} != encoder "
                                     f"input")
        # the counted play, at volume 50: its launches alone
        _kernels.reset_launches()
        ((run, mp3_n), flac_n), gain_n = count_calls(
            pcm_ops, "apply_gain", lambda: count_calls(
                flac_codec, "synthesise_batch", lambda: count_calls(
                    mp3_codec, "decode_frames_lazy", lambda: player_run(
                        media_player(device, 50), start))))
        launches = dict(_kernels.launches)
        sink, wall, batcher, track_ids = run[:4]
        half = outputs(sink, track_ids, run[4], "volume 50")
        if launches["lpc"] != flac_n or flac_n == 0 \
                or launches["mp3_window"] != mp3_n or mp3_n != mp3_groups \
                or launches["sbr_env"] <= 0:
            raise AssertionError(
                f"phase 20: launches {launches} for {flac_n} FLAC groups "
                f"and {mp3_n} MP3 groups (want {mp3_groups})")
        if batcher.device != torch.device(device) or gain_n == 0 \
                or batcher.gain_tiles != gain_n:
            raise AssertionError(
                f"phase 20: the gain pass ran {gain_n} times "
                f"({batcher.gain_tiles} tiles) on {batcher.device}")
        # the same play on the CPU
        t_cpu = time.perf_counter()
        cpu_run = player_run(media_player("cpu", 50), start)
        t_cpu = time.perf_counter() - t_cpu
        cpu = outputs(cpu_run[0], cpu_run[3], cpu_run[4], "cpu")
        errs = []
        for name, gate in PLAYER_GATES.items():
            (info, got), (cinfo, want) = half[name], cpu[name]
            if got.shape != want.shape or info.sample_rate \
                    != cinfo.sample_rate:
                raise AssertionError(f"phase 20 {name}: card {got.shape} "
                                     f"!= cpu {want.shape}")
            lsb = int(np.abs(got.astype(np.int64) - want).max())
            if lsb > gate:
                raise AssertionError(f"phase 20 {name}: card vs CPU {lsb} "
                                     f"LSB, gate {gate}")
            errs.append(f"{name} ({info.codec_name}, {info.sample_rate} Hz, "
                        f"{got.shape[1] / info.sample_rate:.2f} s) <= {lsb}")
        decoded_s = sum(p.shape[1] / i.sample_rate for i, p in half.values())
        print(f"phase 20: MediaPlayer(device={device!r}) Playlist of "
              f"{len(paths)} tracks, one gapless play to the halt: unity "
              f"FLAC == encoder input (first play {first[1]:.3f} s); at "
              f"volume 50 card vs cpu in LSB: {'; '.join(errs)}; track ids "
              f"{track_ids} in the playlist's order")
        print(f"phase 20: counted play at volume 50: warm wall {wall:.3f} s "
              f"for {decoded_s:.2f} s of audio, {decoded_s / wall:.1f} "
              f"decoded s per wall s; {flac_n} FLAC groups, {mp3_n} MP3 "
              f"groups, launches {launches}; the gain pass ran {gain_n} "
              f"times on {batcher.device}")
        _prof, _events, trace = trace_call(
            lambda: player_run(media_player(device, 50), start))
        print(f"phase 20: traced play {trace['wall_s']:.3f} s, device busy "
              f"{trace['device_busy_ms']:.2f} ms, idle share "
              f"{trace['idle_share']:.4f}")
        # the Radio source, and a mute through the volume chain
        radio = player_run(media_player(device), radio_uri(paths[0]))[0]
        if not np.array_equal(radio.pcm, flac_tracks["cd"]):
            raise AssertionError("phase 20 radio: play_uri != encoder input")
        sink, _, batcher, _, _, at = player_run(
            media_player(device), playlist(paths[:1]),
            midway=(3, lambda player: player.volumes.mute()))
        track = flac_tracks["cd"]
        if not 0 < at < track.shape[1] or sink.samples != track.shape[1] \
                or not np.array_equal(sink.pcm[:, :at], track[:, :at]) \
                or sink.pcm[:, at:].any():
            raise AssertionError(f"phase 20 mute at sample {at}: the output "
                                 f"is not the track up to it and zero after")
        print(f"phase 20: Radio play_uri of the CD file == encoder input; a "
              f"mute after 3 events: the track up to sample {at}, zero for "
              f"the {track.shape[1] - at} after it ({batcher.gain_tiles} "
              f"tiles through the gain pass)")
    print(f"phase 20: the plays took {time.perf_counter() - t_phase:.1f} s, "
          f"{t_cpu:.1f} s of it the CPU play")
    return seen, launches, unity, cpu


#: phase 21 (b): how far ahead of its audio clock a paced OHM sender sends
OHM_LEAD_S = 0.05
#: phase 21 (b): seconds the sender sends silence after its halt, and the
#: receiver renders on after that: the receiver's pipeline decodes its raw
#: PCM in blocks of 16384 samples (0.37 s), so the last block of audio
#: leaves it only when the silence after it fills the block
RX_TAIL_S = 0.6
#: phase 21 (c): frames of phase 0's first CD stream the player plays: one
#: CodecFlac group (see player_cli)
PLAYER_FRAMES = 16
#: phase 21 (b): the gates on the receiver's output against the sent audio
RX_ARRIVED_MIN = 0.95          # sent audio frames the receiver delivers
RX_RENDERED_MIN = 0.90         # non-zero rendered columns / sent ones
RX_RMS_TOL = 0.01              # |rms ratio / gain - 1|


class OhmRecorder:
    """An OHM sender for AnimatorSongcastSender that keeps what it is sent:
    each frame's (sample_start, samples, halt flag, the samples or None
    where they are all zero).  It forwards each frame to ``ohm`` (an
    OhmSender) when given one.  With ``paced`` it holds each frame until
    its audio clock (started at the first frame) is within OHM_LEAD_S of the
    frame's sample_start, as a sender clocked by its audio would: the
    animator pulls a whole decoded event a quantum (a 16-frame FLAC group is
    1.5 s) and would otherwise send it in one burst, more than a loopback
    receiver's socket holds."""

    def __init__(self, ohm=None, paced: bool = False):
        self.ohm = ohm
        self.paced = paced
        self.frames = []
        self.halt_after_audio = False
        self._audio_seen = False
        self._t0 = None

    def send_audio(self, samples, sample_rate, bit_depth, sample_start=0,
                   samples_total=0, halt=False):
        if self.paced:
            now = time.monotonic()
            if self._t0 is None:
                self._t0 = now - sample_start / sample_rate
            wait = self._t0 + sample_start / sample_rate - OHM_LEAD_S - now
            if wait > 0:
                time.sleep(wait)
        audio = np.array(samples) if samples.any() else None
        self._audio_seen = self._audio_seen or audio is not None
        self.halt_after_audio = self.halt_after_audio or (
            halt and self._audio_seen)
        self.frames.append((sample_start, samples.shape[1], halt, audio))
        if self.ohm is None:
            return 0
        return self.ohm.send_audio(samples, sample_rate, bit_depth,
                                   sample_start=sample_start,
                                   samples_total=samples_total, halt=halt)

    def audio(self) -> np.ndarray:
        """The sent audio: the frames that are not all zero, in order."""
        got = [f[3] for f in self.frames if f[3] is not None]
        return (np.concatenate(got, axis=1) if got
                else np.zeros((2, 0), np.int32))

    def positions_run_on(self) -> bool:
        """Whether each frame's sample_start is where the frame before it
        ended, so the positions rise monotonically."""
        pos = np.array([f[0] for f in self.frames], np.int64)
        n = np.array([f[1] for f in self.frames], np.int64)
        return len(pos) > 1 and bool((pos[1:] == pos[:-1] + n[:-1]).all())


def drop_silent_chunks(pcm: np.ndarray) -> np.ndarray:
    """``pcm`` cut into OHM frames (AnimatorSongcastSender.FRAME_SAMPLES)
    from its start, the all-zero frames dropped: what an OhmRecorder keeps
    of a track whose decoded events are whole frames (but the last)."""
    from ohpipeline_tpu_torch.pipeline import AnimatorSongcastSender

    n = AnimatorSongcastSender.FRAME_SAMPLES
    chunks = [pcm[:, i:i + n] for i in range(0, pcm.shape[1], n)]
    kept = [c for c in chunks if c.any()]
    return (np.concatenate(kept, axis=1) if kept
            else np.zeros((pcm.shape[0], 0), pcm.dtype))


def songcast_send(player, start, ohm, realtime: bool, animator=None,
                  tail_s: float = 0.0) -> tuple:
    """Calls start(player) and renders the player's pipeline through an
    AnimatorSongcastSender on the player's device into ``ohm`` (an
    OhmRecorder) until the sender has sent a halted frame after its audio
    and ``tail_s`` seconds more (of the Silencer's silence), then quits the
    player.  ``animator(upstream, ohm)`` builds another sender (the JAX
    package's).  Returns (the animator, start's result, wall seconds);
    raises if the sender failed or did not end."""
    from ohpipeline_tpu_torch import pipeline

    upstream = player.pipeline.pipeline.predriver
    anim = None
    t0 = time.perf_counter()
    try:
        anim = (animator(upstream, ohm) if animator else
                pipeline.AnimatorSongcastSender(upstream, ohm,
                                                device=player.device,
                                                realtime=realtime))
        started = start(player)
        anim.start()
        while not ohm.halt_after_audio and anim._thread.is_alive() \
                and time.perf_counter() - t0 < 120.0:
            time.sleep(0.01)
        time.sleep(tail_s)
    finally:
        if anim is not None:
            anim.quit()
        player.quit()
        if anim is not None:
            anim.join(10.0)
    wall = time.perf_counter() - t0
    if anim._thread.is_alive() or not ohm.halt_after_audio:
        raise AssertionError(f"the Songcast sender did not reach the halt "
                             f"after its audio in {wall:.1f} s")
    return anim, started, wall


def receiver_player(device, volume: int, sender_endpoint=None) -> tuple:
    """:func:`media_player` with a unicast Songcast SourceReceiver added
    (joining ``sender_endpoint`` when given).  Returns (player, source)."""
    from ohpipeline_tpu_torch.host.av.receiver_sources import SourceReceiver

    sources = []

    def add(player):
        sources.append(SourceReceiver(player.pipeline, multicast=False,
                                      sender_endpoint=sender_endpoint))
        player.add_source(sources[0])

    return media_player(device, volume, add), sources[0]


def receiver_push(player, src, frames, ohm_audio, animator=None):
    """Selects the player's SourceReceiver ``src`` (pointed at a sender)
    and hands it ``frames`` ((sample_start, (channels, n) int32 samples) at
    44.1 kHz / 16 bits) as its OhmReceiver would, each with an
    ``ohm_audio`` message (the OhmAudio class of the player's package);
    once its protocol has taken them all, pushes a halt.  An AnimatorBatch
    on the player's device (``animator(upstream, sink)`` builds another)
    renders alongside, on a thread, to the pipeline's halt.  Quits the
    player; returns the sink."""
    import threading

    from ohpipeline_tpu_torch import pipeline

    sink = Sink()
    upstream = player.pipeline.pipeline.predriver
    errors = []

    def render():
        try:
            (animator(upstream, sink) if animator else pipeline.AnimatorBatch(
                upstream, sink, device=player.device)).run()
        except BaseException as e:                     # noqa: BLE001
            errors.append(e)

    thread = threading.Thread(target=render, daemon=True)
    try:
        src.set_sender("ohm://127.0.0.1:9")
        player.product.set_source_by_name("Receiver")
        thread.start()
        for i, (start, samples) in enumerate(frames):
            src._on_audio(samples, ohm_audio(
                frame=i + 1, sample_start=start, samples_total=0,
                sample_rate=44100, bit_depth=16, channels=samples.shape[0],
                payload=b"", media_latency=150 * 44100 * 256 // 1000))
        deadline = time.monotonic() + 60.0
        while src.protocol._buffer and time.monotonic() < deadline:
            time.sleep(0.01)
        src.protocol.push_halt()
        thread.join(60.0)
    finally:
        src.deactivate()
        player.quit()
        thread.join(10.0)
    if errors:
        raise errors[0]
    if thread.is_alive():
        raise AssertionError("the receiver's animator did not reach the halt")
    return sink


def timed_gain_tiles(batcher) -> list:
    """Wraps ``batcher``'s render to keep the wall seconds of each call that
    ran the gain pass (the tile to the device, apply_gain, the copy back);
    returns the list it fills."""
    times = []
    render = batcher.render

    def timed(events):
        n, t0 = batcher.gain_tiles, time.perf_counter()
        out = render(events)
        if batcher.gain_tiles > n:
            times.append(time.perf_counter() - t0)
        return out

    batcher.render = timed
    return times


def songcast_loopback(paths, device, volume: int = 50) -> dict:
    """Phase 21 (b): a sender MediaPlayer on ``device`` at unity gain plays
    ``paths`` through its Playlist source into an AnimatorSongcastSender
    (realtime) over a unicast OhmSender on 127.0.0.1, paced at its audio
    clock (OhmRecorder); a receiver MediaPlayer on ``device`` at ``volume``,
    its SourceReceiver joined to that sender, renders through a realtime
    AnimatorBasic (5 ms quanta); the sender sends RX_TAIL_S of silence after
    its halt and the receiver renders RX_TAIL_S more.
    Returns {"sent": the OhmRecorder, "delivered": [(sample_start, samples)
    of each frame the receiver's OhmReceiver delivered], "rendered": the
    receiver's Sink, "tx" / "rx": the animators, "tiles": the receiver's
    gain tiles' wall seconds, "gain": its gain (attenuation / 2^14), "wall":
    the sender's wall}."""
    from ohpipeline_tpu_torch import pipeline
    from ohpipeline_tpu_torch.host.net.songcast import OhmSender

    ohm = OhmSender(multicast=False)
    ohm.start()
    sent = OhmRecorder(ohm, paced=True)
    delivered, rendered = [], Sink()
    rx = rx_anim = None
    try:
        endpoint = ("127.0.0.1", ohm.endpoint[1])
        rx, src = receiver_player(device, volume, endpoint)
        on_audio = src._on_audio

        def record(samples, msg):
            delivered.append((msg.sample_start, samples))
            on_audio(samples, msg)

        src._on_audio = record
        src.set_sender(f"ohm://{endpoint[0]}:{endpoint[1]}")
        rx.product.set_source_by_name("Receiver")
        deadline = time.monotonic() + 5.0
        while not ohm._listeners and time.monotonic() < deadline:
            time.sleep(0.01)
        if not ohm._listeners:
            raise AssertionError("the receiver did not join the sender")
        rx_anim = pipeline.AnimatorBasic(rx.pipeline.pipeline.predriver,
                                         rendered, quantum_ms=5,
                                         device=device, realtime=True)
        tiles = timed_gain_tiles(rx_anim.batcher)
        rx_anim.start()
        tx_anim, _, wall = songcast_send(media_player(device),
                                         playlist(paths), sent,
                                         realtime=True, tail_s=RX_TAIL_S)
        time.sleep(RX_TAIL_S)
        gain = rx.pipeline.pipeline.attenuator.attenuation / (1 << 14)
    finally:
        if rx_anim is not None:
            rx_anim.quit()
        if rx is not None:
            src.deactivate()
            rx.quit()
        if rx_anim is not None:
            rx_anim.join(10.0)
        ohm.stop()
    if rx_anim.is_alive():
        raise AssertionError("the receiver's animator did not end")
    return {"sent": sent, "delivered": delivered, "rendered": rendered,
            "tx": tx_anim, "rx": rx_anim, "tiles": tiles, "gain": gain,
            "wall": wall}


def loopback_gates(lb: dict) -> dict:
    """Phase 21 (b)'s gates on a :func:`songcast_loopback`: every frame the
    receiver delivered equals the sent frame with its sample_start, bit for
    bit; at least RX_ARRIVED_MIN of the sent audio frames arrived; the
    receiver's non-zero rendered columns are at least RX_RENDERED_MIN of
    the sent audio's, and its rms over the audio it was delivered within
    RX_RMS_TOL of the receiver's gain (both counted over all their samples,
    so the silence the receiver adds, and the sent audio lost on the way,
    weigh nothing); the sender's positions run on.  Raises on a
    failed gate; returns the measures."""
    sent = {f[0]: f for f in lb["sent"].frames}
    for start, samples in lb["delivered"]:
        f = sent.get(start)
        want = (None if f is None else f[3] if f[3] is not None
                else np.zeros((samples.shape[0], f[1]), np.int32))
        if want is None or not np.array_equal(samples, want):
            raise AssertionError(f"phase 21 songcast: the frame delivered at "
                                 f"sample {start} is not the frame sent")
    got = {start for start, _ in lb["delivered"]}
    audio_starts = [f[0] for f in lb["sent"].frames if f[3] is not None]
    arrived = sum(s in got for s in audio_starts) / max(len(audio_starts), 1)
    audio = lb["sent"].audio()
    heard = [s for _, s in lb["delivered"] if s.any()]
    heard = np.concatenate(heard, axis=1) if heard else audio[:, :0]
    pcm = lb["rendered"].pcm
    rendered = (int(pcm.any(axis=0).sum())
                / max(int(audio.any(axis=0).sum()), 1))

    def energy(x):
        return float((x.astype(np.float64) ** 2).sum())

    # rms over the same count of samples: silence adds nothing to either
    ratio = float(np.sqrt(energy(pcm) / max(energy(heard), 1.0)))
    out = {"frames_sent": len(lb["sent"].frames),
           "audio_frames": len(audio_starts),
           "delivered": len(lb["delivered"]), "arrived": arrived,
           "rendered": rendered, "rms_ratio": ratio, "gain": lb["gain"]}
    if not lb["sent"].positions_run_on() or arrived < RX_ARRIVED_MIN \
            or rendered < RX_RENDERED_MIN \
            or abs(ratio / lb["gain"] - 1) > RX_RMS_TOL:
        raise AssertionError(f"phase 21 songcast gates: {out}")
    return out


#: phase 21 (b): renders of the receiver's largest tile alone
TILE_REPS = 20


def gain_tile_alone(lb: dict, device) -> dict:
    """The host wall of the receiver's gain pass on its largest tile alone:
    one event of that many samples of the sent audio at the receiver's
    attenuation, through a fresh RenderBatcher on ``device``, TILE_REPS
    times (after one warm-up), with no other player in the process
    running."""
    from ohpipeline_tpu_torch.host.core import events as ev
    from ohpipeline_tpu_torch.host.core.streaminfo import PcmStreamInfo
    from ohpipeline_tpu_torch.pipeline import RenderBatcher

    n = max(c.shape[1] for c in lb["rendered"].chunks)
    event = ev.AudioPcmEvent(
        np.ascontiguousarray(lb["sent"].audio()[:, :n]),
        PcmStreamInfo(sample_rate=44100, bit_depth=16, num_channels=2),
        attenuation=int(round(lb["gain"] * (1 << 14))))
    batcher = RenderBatcher(device)
    times = timed_gain_tiles(batcher)
    for _ in range(TILE_REPS + 1):
        batcher.render([event])
    ms = 1e3 * np.array(times[1:])
    return {"samples": n, "mean_ms": float(ms.mean()),
            "median_ms": float(np.median(ms))}


def odp_play(device, paths, volume: int = 50) -> tuple:
    """Phase 21 (a): a MediaPlayer on ``device`` (:func:`media_player`, at
    unity) driven only through its ODP control plane: an OdpServer with
    make_device(player) on 127.0.0.1 and an OdpClient insert ``paths`` with
    Playlist.Insert, set Volume.SetVolume ``volume`` and press
    Playlist.SeekId on the first; :func:`player_run` renders to the halt.
    Returns player_run's result."""
    from ohpipeline_tpu_torch.host.net.odp import OdpClient, OdpServer
    from ohpipeline_tpu_torch.host.net.providers import make_device

    player = media_player(device)
    server = client = None
    try:
        server = OdpServer(host="127.0.0.1")
        server.add_device(make_device(player))
        client = OdpClient("127.0.0.1", server.port)
    except BaseException:
        if server is not None:
            server.close()
        player.quit()
        raise

    def start(player) -> list:
        ids, after = [], 0
        for path in paths:
            after = client.invoke("Playlist", "Insert", afterId=after,
                                  uri=f"file://{path}",
                                  metadata="")["newId"]
            ids.append(after)
        client.invoke("Volume", "SetVolume", value=volume)
        client.invoke("Playlist", "SeekId", value=ids[0])
        return ids

    try:
        return player_run(player, start)
    finally:
        client.close()
        server.close()


def player_cli(uri: str, wav: str, *flags) -> str:
    """Runs ``python -m ohpipeline_tpu_torch.tools.player --uri uri --wav
    wav *flags`` from the repository root; returns its output, raising on a
    non-zero exit."""
    proc = subprocess.run(
        [sys.executable, "-m", "ohpipeline_tpu_torch.tools.player", "--uri",
         uri, "--wav", wav, *flags], cwd=HERE, capture_output=True,
        text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the player {' '.join(flags)} exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout


#: phase 21 (a)'s playlist: phase 20's CD FLAC, MP3 and HE-AAC tracks
NET_TRACKS = ("cd", "mp3", "he")


def net_phase(tracks, streams, mstreams, unity, cpu, device="cuda") -> tuple:
    """Phase 21: the net layer on ``device`` (see the module docstring).
    ``unity`` and ``cpu`` are phase 20's plays at unity on the card and at
    volume 50 on the CPU ({track name: (stream info, PCM)}).  Returns
    ({kernel: (args, result) of its first launch in (a)'s first play}, the
    kernels' launches in (a)'s counted play)."""
    import torch
    from ohpipeline_tpu_torch import _host, _kernels
    from ohpipeline_tpu_torch.codecs import flac as flac_codec
    from ohpipeline_tpu_torch.codecs import mp3 as mp3_codec
    from ohpipeline_tpu_torch.codecs.aac import sbr as sbrd
    from ohpipeline_tpu_torch.codecs.mp3 import synthesis as msyn
    from ohpipeline_tpu_torch.host.codecs.wav import parse_wav
    from ohpipeline_tpu_torch.ops import lpc as lpc_ops
    from ohpipeline_tpu_torch.ops import pcm as pcm_ops

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        files = dict(zip(PLAYER_GATES, player_files(tmp, streams, mstreams)))
        paths = [files[name] for name in NET_TRACKS]
        # (a) the control plane: a first play, then the counted one
        first, seen = first_calls_of(
            [(lpc_ops, "lpc_synthesize"), (msyn, "mp3_window"),
             (sbrd, "envelope_scan")], lambda: odp_play(device, paths))
        _kernels.reset_launches()
        ((run, mp3_n), flac_n), gain_n = count_calls(
            pcm_ops, "apply_gain", lambda: count_calls(
                flac_codec, "synthesise_batch", lambda: count_calls(
                    mp3_codec, "decode_frames_lazy",
                    lambda: odp_play(device, paths))))
        launches = dict(_kernels.launches)
        sink, wall, batcher, track_ids, ids = run[:5]
        parts = stream_pcm(sink)
        codecs = [i.codec_name for i, _ in parts]
        if codecs != ["FLAC", "MP3", "HE-AAC"] or track_ids != ids:
            raise AssertionError(f"phase 21 odp: streams {codecs}, tracks "
                                 f"{track_ids} for playlist ids {ids}")
        errs = []
        for name, (info, got) in zip(NET_TRACKS, parts):
            want = cpu[name][1]
            if got.shape != want.shape:
                raise AssertionError(f"phase 21 odp {name}: {got.shape} != "
                                     f"phase 20's cpu {want.shape}")
            lsb = int(np.abs(got.astype(np.int64) - want).max())
            if lsb > PLAYER_GATES[name]:
                raise AssertionError(f"phase 21 odp {name}: {lsb} LSB from "
                                     f"phase 20's cpu play")
            errs.append(f"{name} <= {lsb}")
        if launches["lpc"] != flac_n or flac_n == 0 \
                or launches["mp3_window"] != mp3_n or mp3_n == 0 \
                or launches["sbr_env"] <= 0:
            raise AssertionError(f"phase 21 odp: launches {launches} for "
                                 f"{flac_n} FLAC and {mp3_n} MP3 groups")
        if batcher.device != torch.device(device) or gain_n == 0 \
                or batcher.gain_tiles != gain_n:
            raise AssertionError(f"phase 21 odp: the gain pass ran {gain_n} "
                                 f"times on {batcher.device}")
        decoded_s = sum(p.shape[1] / i.sample_rate for i, p in parts)
        print(f"phase 21 (a): OdpClient -> OdpServer -> MediaPlayer(device="
              f"{device!r}): Playlist.Insert x3, Volume.SetVolume 50, "
              f"Playlist.SeekId; vs phase 20's cpu play in LSB: "
              f"{'; '.join(errs)} (first play {first[1]:.3f} s)")
        print(f"phase 21 (a): counted play: warm wall {wall:.3f} s for "
              f"{decoded_s:.2f} s of audio, {decoded_s / wall:.1f} decoded s "
              f"per wall s; {flac_n} FLAC groups, {mp3_n} MP3 groups, "
              f"launches {launches}; the gain pass ran {gain_n} times on "
              f"{batcher.device}")
        # (b) Songcast: sender and receiver players on the card
        lb = songcast_loopback([files["cd"], files["mp3"]], device)
        audio = lb["sent"].audio()
        n_cd = tracks[0].shape[1]
        mp3_ref = drop_silent_chunks(unity["mp3"][1])
        if not np.array_equal(audio[:, :n_cd], tracks[0]):
            raise AssertionError("phase 21 songcast: the sent FLAC audio != "
                                 "the encoder input")
        if audio[:, n_cd:].shape != mp3_ref.shape:
            raise AssertionError(f"phase 21 songcast: sent MP3 audio "
                                 f"{audio[:, n_cd:].shape}, phase 20's "
                                 f"{mp3_ref.shape}")
        mp3_lsb = int(np.abs(audio[:, n_cd:].astype(np.int64)
                             - mp3_ref).max())
        if mp3_lsb > PLAYER_GATES["mp3"]:
            raise AssertionError(f"phase 21 songcast: sent MP3 {mp3_lsb} "
                                 f"LSB from phase 20's")
        g = loopback_gates(lb)
        if lb["rx"].batcher.device != torch.device(device) or not lb["tiles"]:
            raise AssertionError("phase 21 songcast: the receiver's gain "
                                 "pass did not run on the card")
        print(f"phase 21 (b): Songcast sender MediaPlayer(device={device!r}) "
              f"-> AnimatorSongcastSender -> OhmSender (unicast, paced) -> "
              f"receiver MediaPlayer's SourceReceiver: sent {audio.shape[1]} "
              f"audio samples (FLAC == encoder input, MP3 <= {mp3_lsb} LSB "
              f"of phase 20's) in {g['audio_frames']} audio frames of "
              f"{g['frames_sent']}; {g['delivered']} frames delivered, each "
              f"== the frame sent; {g['arrived']:.4f} of the audio frames "
              f"arrived; rendered non-zero {g['rendered']:.4f} of the sent "
              f"audio, rms ratio {g['rms_ratio']:.6g} for gain "
              f"{g['gain']:.6g}; sender wall {lb['wall']:.2f} s")
        for who in ("tx", "rx"):
            anim = lb[who]
            tiles = lb["tiles"] if who == "rx" else []
            mean_ms = 1e3 * float(np.mean(tiles)) if tiles else 0.0
            print(f"phase 21 (b): {who} animator: late_quanta "
                  f"{anim.late_quanta}, worst_late_s {anim.worst_late_s:.4f}, "
                  f"gain tiles {anim.batcher.gain_tiles} (mean "
                  f"{mean_ms:.3f} ms, host wall with both copies)")
        alone = gain_tile_alone(lb, device)
        print(f"phase 21 (b): the receiver's largest tile "
              f"({alone['samples']} samples) alone through a RenderBatcher "
              f"on {device}, {TILE_REPS} times: mean {alone['mean_ms']:.3f} "
              f"ms, median {alone['median_ms']:.3f} ms")
        # (c) the player entry point, on the card and with --cpu
        cut = os.path.join(tmp, "cut.flac")
        track = tracks[0][:, :PLAYER_FRAMES * 4096]
        with open(cut, "wb") as f:
            f.write(_host.encode_flac(track, 44100, 16))
        wavs, t_cli = {}, time.perf_counter()
        for flags in ((), ("--cpu",)):
            out = os.path.join(tmp, f"player{len(flags)}.wav")
            player_cli(f"file://{cut}", out, *flags)
            with open(out, "rb") as f:
                wavs[flags] = f.read()
        _, pcm = parse_wav(wavs[()])
        if wavs[()] != wavs[("--cpu",)] or not np.array_equal(pcm, track):
            raise AssertionError("phase 21 player: the card's and the CPU's "
                                 "WAVs differ, or differ from the track")
        print(f"phase 21 (c): python -m ohpipeline_tpu_torch.tools.player "
              f"--uri file://<{PLAYER_FRAMES} CD frames> --wav: the card's "
              f"WAV == the --cpu WAV ({len(wavs[()])} bytes) == the track; "
              f"both runs {time.perf_counter() - t_cli:.1f} s")
    print(f"phase 21: {time.perf_counter() - t_phase:.1f} s")
    return seen, launches


def first_calls_of(targets, run) -> tuple:
    """first_calls over several (module, name) targets at once: (run()'s
    result, {name: (args, result)} of each target's first call)."""
    if not targets:
        return run(), {}
    (module, name), rest = targets[0], targets[1:]
    (result, seen), own = first_calls(module, [name],
                                      lambda: first_calls_of(rest, run))
    return result, {**seen, **own}


def spread(walls: list) -> str:
    """'median (min-max)' of walls in seconds."""
    return (f"{np.median(walls):.4f} s ({min(walls):.4f}-"
            f"{max(walls):.4f})")


def mesh_serving(mesh, name: str, calls: dict, base: dict,
                 capture: bool) -> tuple:
    """One mesh's serving calls against the no-mesh calls ``base`` (name
    -> (outs, launches)): outputs within the codec's bound, launches equal
    to the no-mesh launches times dp in every timed call.  MESH_REPS rounds
    each time one no-mesh call and one mesh call, in turn, after a warm
    mesh call, which with ``capture`` keeps the first block's first kernel
    inputs.  Returns (the printed parts, {kernel: (args, result)} of the
    captured launches, {codec: (no-mesh walls, mesh walls)})."""
    import torch

    from ohpipeline_tpu_torch import _kernels

    dp = mesh.shape["dp"]
    parts, seen, walls = [], {}, {}
    for codec, (fn, streams, group, bound, kernels, rate, targets) \
            in calls.items():
        # warm every device (and keep block 0's first kernel inputs)
        seen.update(first_calls_of(targets if capture else [],
                                   lambda: fn(streams, group, mesh=mesh))[1])
        want, base_launches = base[codec]
        none_w, mesh_w = [], []
        for _ in range(MESH_REPS):
            t0 = time.perf_counter()
            fn(streams, group, device="cuda")
            torch.cuda.synchronize()
            none_w.append(time.perf_counter() - t0)
            _kernels.reset_launches()
            t0 = time.perf_counter()
            outs = fn(streams, group, mesh=mesh)
            torch.cuda.synchronize()
            mesh_w.append(time.perf_counter() - t0)
            launches = {k: _kernels.launches[k] for k in kernels}
            if launches != {k: v * dp for k, v in base_launches.items()} \
                    or min(launches.values()) <= 0:
                raise AssertionError(f"{name} {codec}: launches {launches}, "
                                     f"want {dp} x {base_launches}")
        lsb = 0
        for s, (o, w) in enumerate(zip(outs, want)):
            if o.shape != w.shape:
                raise AssertionError(f"{name} {codec} stream {s}: {o.shape} "
                                     f"!= {w.shape}")
            lsb = max(lsb, int(np.abs(o.astype(np.int64) - w).max()))
        if lsb > bound:
            raise AssertionError(f"{name} {codec}: {lsb} LSB from mesh=None")
        audio_s = sum(o.shape[1] for o in outs) / rate
        walls[codec] = (none_w, mesh_w)
        parts.append(f"{codec} <= {lsb} LSB, launches {launches} "
                     f"(mesh=None {base_launches}); {audio_s:.1f} s of audio "
                     f"in {spread(mesh_w)} (mesh=None {spread(none_w)}): "
                     f"{audio_s / np.median(mesh_w):.1f} decoded s per wall s "
                     f"(mesh=None {audio_s / np.median(none_w):.1f}), "
                     f"median ratio "
                     f"{np.median(none_w) / np.median(mesh_w):.3f}")
    return parts, seen, walls


def mesh_kernels(seen: dict, dev) -> dict:
    """Each kernel of the mesh path against its plain version on the inputs
    of its first launch on the logical mesh's first block (block shapes:
    half the streams of each call), at the gates of phases 2, 3, 6, 8 and
    13.  Returns {kernel: max |err|}."""
    lpc_args = list(seen["lpc_synthesize"][0])
    tns_arrays = [t.cpu().numpy() for t in seen["tns_scan"][0]]
    vfull, wnd, bd = seen["mp3_window"][0]
    return {
        "lpc": check_lpc("mesh block 0 group 0", lpc_args, phase=19)[0],
        "rice": check_rice("mesh block 0 group 0", seen["scan_units"][0],
                           phase=19)[0],
        "tns": check_tns("mesh block 0 group 0 (AAC-LC)", tns_arrays, dev,
                         phase=19)[0],
        "sbr_env": check_sbr_env("mesh block 0 group 0",
                                 seen["envelope_scan"][0], phase=19)[0],
        "mp3_window": check_mp3_window("mesh block 0 group 0", vfull, wnd,
                                       bd, phase=19)[0],
    }


def he_block_setup_ms(stream: bytes, nch: int, reps: int = 5) -> float:
    """Median ms of the set-up an HE-AAC serving block makes before its
    first group, warm: the AAC constants on the card and an
    ``SbrDeviceRunner`` of ``nch`` channels (its static tables and state
    rows)."""
    import torch

    from ohpipeline_tpu_torch import _host
    from ohpipeline_tpu_torch.codecs.aac import sbr as sbrd
    from ohpipeline_tpu_torch.codecs.aac import synthesis as asyn

    _host.sbr_native()
    h = _host.aac_bitstream.parse_adts_header(stream)
    dec = _host.aac_sbr.SbrDecoder(h.sample_rate)
    _, _, b = _host.aac_native().aac_parse_group_sbr(
        stream, 0, channels=h.channels, max_frames=1)
    payload, nbits, crc = b["sbr"][0]
    dec.parse_payload(payload, nbits, stereo=h.channels == 2, crc=crc)
    times = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        asyn.device_constants(h.rate_index, device="cuda")
        sbrd.SbrDeviceRunner(dec, nch, device="cuda")
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times[1:]) * 1e3)


def mesh_phase(streams, tracks, astreams, hstreams, mstreams) -> dict:
    """Phase 19: the multi-device layer on make_mesh() and on the logical
    mesh MESH_LOGICAL, each against the same work with no mesh on the
    card (see the module docstring).  Returns {kernel: max |err| against
    its plain version at the logical mesh's block shapes}."""
    import torch

    from ohpipeline_tpu_torch import _host, _kernels, parallel
    from ohpipeline_tpu_torch.codecs.aac import sbr as sbrd
    from ohpipeline_tpu_torch.codecs.aac import synthesis as asyn
    from ohpipeline_tpu_torch.codecs.aac.serving import (
        decode_aac_streams_device, decode_he_streams_device)
    from ohpipeline_tpu_torch.codecs.flac import rice
    from ohpipeline_tpu_torch.codecs.flac.serving import (
        decode_flac_streams_device)
    from ohpipeline_tpu_torch.codecs.mp3 import synthesis as msyn
    from ohpipeline_tpu_torch.codecs.mp3.serving import (
        decode_mp3_streams_device)
    from ohpipeline_tpu_torch.entry import dryrun_multichip
    from ohpipeline_tpu_torch.ops import lpc

    he_rate = 2 * _host.aac_bitstream.parse_adts_header(
        hstreams[0]).sample_rate
    calls = {
        "FLAC": (decode_flac_streams_device, streams[:MESH_FLAC_STREAMS],
                 FRAMES_PER_GROUP, 0, ("lpc", "rice"), 44100.0,
                 [(lpc, "lpc_synthesize"), (rice, "scan_units")]),
        "AAC-LC": (decode_aac_streams_device, astreams[:MESH_AAC_STREAMS],
                   AAC_FRAMES_PER_GROUP, 1, ("tns",), 44100.0,
                   [(asyn, "tns_scan")]),
        "HE-AAC": (decode_he_streams_device, hstreams[:MESH_HE_STREAMS],
                   HE_FRAMES_PER_GROUP, 2, ("sbr_env", "tns"), he_rate,
                   [(sbrd, "envelope_scan")]),
        "MP3": (decode_mp3_streams_device, mstreams[:MESH_MP3_STREAMS],
                MP3_FRAMES_PER_GROUP, 1, ("mp3_window",), 44100.0,
                [(msyn, "mp3_window")]),
    }
    base = {}
    for codec, (fn, cstreams, group, _b, kernels, _r, _t) in calls.items():
        fn(cstreams, group, device="cuda")
        _kernels.reset_launches()
        outs = fn(cstreams, group, device="cuda")
        torch.cuda.synchronize()
        base[codec] = (outs, {k: _kernels.launches[k] for k in kernels})
    meshes = [("make_mesh()", parallel.make_mesh()),
              ("logical", parallel.make_mesh(devices=MESH_LOGICAL))]
    one = parallel.make_mesh(devices=["cuda:0"])
    step_args = parallel.example_step_args(nframes=8, n=1024)
    rng = np.random.default_rng(19)
    step_args += (rng.standard_normal((4, 8, 1024)).astype(np.float32),
                  rng.integers(0, 16, (4, 8)).astype(np.int32),
                  rng.standard_normal((8, 1024)).astype(np.float32),
                  rng.standard_normal((8, 1024)).astype(np.float32))
    want_step = [o.full("cpu") for o in
                 parallel.sharded_pipeline_step(one)(*step_args)]
    master = (rng.standard_normal((2, 4096)) * 8000).astype(np.float32)
    rooms = 4
    grid_args = (master, np.linspace(0.25, 1.0, rooms).astype(np.float32),
                 (np.arange(rooms) * 2.5).astype(np.float32),
                 np.linspace(-150.0, 150.0, rooms).astype(np.float32),
                 np.zeros(rooms, np.float32), np.ones(rooms, np.float32))
    want_grid = parallel.room_render_grid(one, *grid_args).full("cpu")
    errs = {}
    for name, mesh in meshes:
        logical = name == "logical"
        parts, seen, _walls = mesh_serving(mesh, name, calls, base, logical)
        flac_outs = decode_flac_streams_device(
            streams[:MESH_FLAC_STREAMS], FRAMES_PER_GROUP, mesh=mesh)
        for s, (o, tr) in enumerate(zip(flac_outs, tracks)):
            if o.shape != tr.shape or not np.array_equal(o, tr):
                raise AssertionError(f"{name} FLAC stream {s}: decode != "
                                     f"encoder input")
        got = [o.full("cpu") for o in
               parallel.sharded_pipeline_step(mesh)(*step_args)]
        for i in (0, 1):
            if not torch.equal(got[i], want_step[i]):
                raise AssertionError(f"{name}: step output {i} != one "
                                     f"device")
        step_err = [float((got[i] - want_step[i]).abs().max())
                    for i in (2, 3, 4)]
        if not (max(step_err[:2]) <= 0.05 and step_err[2] <= 1e-3):
            raise AssertionError(f"{name}: step AAC / Vorbis vs one device "
                                 f"{step_err}")
        full, peak = parallel.room_fanout(mesh, master)
        if len(full.shards) != mesh.size or not all(
                torch.equal(t.cpu(), torch.from_numpy(master))
                for _, _, t in full.shards) \
                or float(peak) != float(np.abs(master).max()):
            raise AssertionError(f"{name}: a room_fanout replica differs")
        if not torch.equal(parallel.room_render_grid(mesh, *grid_args)
                           .full("cpu"), want_grid):
            raise AssertionError(f"{name}: room_render_grid != one device")
        torch.cuda.synchronize()
        print(f"phase 19: mesh {name} {mesh.shape} on "
              f"{[str(d) for d in mesh.flat()]}: {'; '.join(parts)}; FLAC "
              f"== the encoder's input; sharded_pipeline_step == one device "
              f"(rendered, meters), AAC {step_err[0]:.2e} / "
              f"{step_err[1]:.2e}, Vorbis {step_err[2]:.2e}; "
              f"{len(full.shards)} room_fanout replicas equal; "
              f"room_render_grid == one device")
        if logical:
            errs = mesh_kernels(seen, torch.device("cuda"))
    nch = _host.aac_bitstream.parse_adts_header(hstreams[0]).channels
    blk = -(-MESH_HE_STREAMS // 2)
    print(f"phase 19: HE-AAC set-up a serving block (AAC constants and an "
          f"SbrDeviceRunner), warm median: {MESH_HE_STREAMS} streams "
          f"{he_block_setup_ms(hstreams[0], MESH_HE_STREAMS * nch):.3f} ms, "
          f"a block of {blk} {he_block_setup_ms(hstreams[0], blk * nch):.3f} "
          f"ms")
    t0 = time.perf_counter()
    dryrun_multichip(devices=MESH_LOGICAL)
    torch.cuda.synchronize()
    print(f"phase 19: dryrun_multichip on {MESH_LOGICAL} in "
          f"{time.perf_counter() - t0:.1f} s")
    return errs


def check_precision() -> None:
    import torch

    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("float32 matmuls are not in full float32 "
                             "(TF32 on)")


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "ohpipeline_tpu_torch")):
        fail("the ohpipeline_tpu_torch package is missing; run from the "
             "repository root")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False); this "
             "smoke test runs the port on an NVIDIA GPU")

    # --- phase 0: content, encoded in spawned workers ----------------------
    t_start = t0 = time.perf_counter()
    jobs, encoded = flac_content()
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

    try:
        import triton
        triton_note = f"triton {triton.__version__}"
    except ImportError as e:
        triton_note = f"no triton ({e})"
    print(f"phase 1: torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{triton_note}; nvcc {_kernels.find_nvcc()}; "
          f"g++ {shutil.which('g++')}")
    dev = torch.device("cuda")
    check_precision()
    t0 = time.perf_counter()
    _kernels.library()
    torch.cuda.synchronize()
    print(f"phase 1: kernels built in {time.perf_counter() - t0:.1f} s "
          f"({' '.join(_kernels.NVCC_FLAGS)})")
    for line in _kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")

    # --- phase 2: LPC kernel vs plain: one serving group's shape, then the
    # rows of the first real serving group ---------------------------------
    lpc_args = [torch.from_numpy(a).to(dev) for a in lpc_case()]
    lpc_err, lpc_ms, lpc_plain_ms, lpc_bound = check_lpc("synthetic",
                                                         lpc_args)
    planes, _meta = next(iter_groups(streams, FRAMES_PER_GROUP))
    t = flac.to_device(planes, dev)
    lpc_err = max(lpc_err, check_lpc("serving group 0",
                                     lpc_group_inputs(t))[0])

    # --- phase 3: rice kernel vs plain on real wire planes and the worst
    # case --------------------------------------------------------------------
    lanes = rice.unit_lanes(*(t[k] for k in flac.RICE_PLANES[:7]))
    rice_err, rice_ms, rice_plain_ms, rice_bound = check_rice(
        "serving group 0", lanes)
    worst = [torch.from_numpy(a).to(dev) for a in rice_worst_case()]
    rice_err = max(rice_err, check_rice("worst case", worst)[0])
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
    counts = {k: _kernels.launches[k] for k in ("lpc", "rice")}
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
    from ohpipeline_tpu_torch.ops import pcm

    rng = np.random.default_rng(5)
    bits = np.tile(np.array([8, 16, 24, 32], np.int32), 4)
    tile = (rng.integers(-(1 << 31), 1 << 31, (16, 2, 4096))
            >> (32 - bits)[:, None, None]).astype(np.int32)
    att = rng.integers(0, pcm.UNITY_ATTENUATION + 1, 16).astype(np.int32)
    for name, args in (("to_float", (tile, bits)),
                       ("attenuate", (tile, att)),
                       ("bit_depth_convert", (tile, bits,
                                              np.roll(bits, 1)))):
        fn = getattr(pcm, name)
        want = fn(*(torch.from_numpy(a) for a in args))
        got = fn(*(torch.from_numpy(a).to(dev) for a in args))
        torch.cuda.synchronize()
        assert got.device.type == "cuda" and got.dtype == want.dtype
        if not torch.equal(got.cpu().view(torch.int32),
                           want.view(torch.int32)):
            raise AssertionError(f"pcm.{name} on the card != CPU")
    print("phase 5: pcm to_float, attenuate, bit_depth_convert over bit "
          "depths 8/16/24/32: card == cpu bit for bit")

    # --- phase 6: TNS kernel vs plain ------------------------------------
    from ohpipeline_tpu_torch.codecs.aac import synthesis as asyn
    from ohpipeline_tpu_torch.codecs.aac.serving import (
        decode_aac_streams_device, decode_planes, iter_groups)
    from ohpipeline_tpu_torch.codecs.aac.serving import to_device as \
        aac_to_device

    t0 = time.perf_counter()
    astreams = aac_streams()
    planes0, _ = next(iter_groups(astreams, AAC_FRAMES_PER_GROUP))
    print(f"phase 6: {len(astreams)} AAC streams, first group parsed in "
          f"{time.perf_counter() - t0:.2f} s")
    TB = planes0["q4"].shape[0] * planes0["q4"].shape[1]
    serving_spec = (np.random.default_rng(6).standard_normal((TB, 1024))
                    * 3000).astype(np.float32)
    tns_err, tns_ms, tns_plain_ms, *tns_bound = check_tns(
        "serving group 0", (serving_spec, planes0["tfi"], planes0["tco"],
                            planes0["tdir"], planes0["trow"]), dev)
    # the six seeds' pools as one, pooled row j filtering spectrum row j
    limits = [np.concatenate(p) for p in
              zip(*map(tns_encoder_limits, TNS_LIMIT_SEEDS))]
    limits[4] = np.arange(len(limits[4]), dtype=np.int32)
    for name, arrays in (("worst case", tns_worst_case()),
                         (f"encoder limits (seeds {TNS_LIMIT_SEEDS.start}-"
                          f"{TNS_LIMIT_SEEDS.stop - 1})", limits)):
        tns_err = max(tns_err, check_tns(name, arrays, dev)[0])

    # --- phase 7: AAC-LC serving at the headline width --------------------
    def serve_aac():
        t0 = time.perf_counter()
        outs = decode_aac_streams_device(astreams, AAC_FRAMES_PER_GROUP,
                                         device="cuda")
        torch.cuda.synchronize()
        return outs, time.perf_counter() - t0

    _outs, aac_first = serve_aac()
    _kernels.reset_launches()
    aac_outs, aac_wall = serve_aac()
    tns_launches = _kernels.launches["tns"]
    if tns_launches <= 0:
        raise AssertionError("the TNS kernel did not run on the AAC path")
    aac_audio_s = sum(o.shape[1] for o in aac_outs) / 44100.0
    SC = 2 * len(astreams)
    consts = asyn.device_constants(planes0["rate_index"], device=dev)
    pcm0, _ = decode_planes(aac_to_device(planes0, dev),
                            torch.zeros((SC, 1024), device=dev), consts)
    ref0, _ = asyn.decode_chunk_zz_reference(
        *(planes0[k] for k in ("q4", "sfb", "ssf", "ssr", "msb", "opx",
                               "epak")), None,
        *(planes0[k] for k in ("eva2", "side", "srow")),
        np.zeros((SC, 1024), np.float32), consts[-1].cpu().numpy(),
        *(planes0[k] for k in ("tfi", "tco", "tdir", "trow")))
    d = pcm0.cpu().numpy() - ref0
    rms, mx = float(np.sqrt((d ** 2).mean())), float(np.abs(d).max())
    if not (rms <= 0.25 and mx <= 1.0):
        raise AssertionError(f"AAC group 0 vs float64: rms {rms}, max {mx}")
    cpu_outs = decode_aac_streams_device(astreams[:AAC_CPU_STREAMS],
                                         AAC_FRAMES_PER_GROUP, device="cpu")
    lsb = 0
    for s, (o, c) in enumerate(zip(aac_outs, cpu_outs)):
        if o.shape != c.shape:
            raise AssertionError(f"AAC stream {s}: {o.shape} != {c.shape}")
        lsb = max(lsb, int(np.abs(o.astype(np.int64) - c).max()))
    if lsb > 1:
        raise AssertionError(f"AAC card vs CPU: {lsb} LSB")
    print(f"phase 7: {len(astreams)} AAC streams, {aac_audio_s:.1f} s of "
          f"audio; group 0 vs float64 rms {rms:.4f} max {mx:.4f} LSB; "
          f"first {AAC_CPU_STREAMS} streams card vs cpu <= {lsb} LSB; tns "
          f"launches {tns_launches}; wall {aac_wall:.3f} s (first call "
          f"{aac_first:.3f} s); {aac_audio_s / aac_wall:.1f} decoded audio "
          f"s per wall s")
    check_precision()

    # --- phases 8-9: HE-AAC v1 serving, SBR envelope kernel ---------------
    from ohpipeline_tpu_torch.codecs.aac import sbr as sbrd
    from ohpipeline_tpu_torch.codecs.aac.serving import (
        decode_he_streams_device)

    hstreams = he_streams()

    def serve_he(streams, device):
        t0 = time.perf_counter()
        outs = decode_he_streams_device(streams, HE_FRAMES_PER_GROUP,
                                        device=device)
        torch.cuda.synchronize()
        return outs, time.perf_counter() - t0

    # the first call also captures group 0's scan inputs and its core PCM
    # and SBR output
    (_outs, he_first), seen = first_calls(
        sbrd, ["envelope_scan", "device_decode_group"],
        lambda: serve_he(hstreams, "cuda"))
    sbr_err, sbr_ms, sbr_plain_ms, *sbr_bound = check_sbr_env(
        "serving group 0", seen["envelope_scan"][0])
    for name, kind, M in (("worst case", "worst", 24),
                          ("worst case, 40 bins", "worst", 40),
                          ("stale filt", "stale_filt", 24),
                          ("carry on high slots", "carry_high", 24)):
        worst = check_sbr_env(name, sbr_env_case(dev, kind, M=M))
        sbr_err = max(sbr_err, worst[0])

    check_precision()
    _kernels.reset_launches()
    he_outs, he_wall = serve_he(hstreams, "cuda")
    he_launches = {k: _kernels.launches[k] for k in ("sbr_env", "tns")}
    if min(he_launches.values()) <= 0:
        raise AssertionError(f"a kernel did not run on the HE path: "
                             f"{he_launches}")
    from ohpipeline_tpu_torch._host import aac_bitstream

    out_rate = 2 * aac_bitstream.parse_adts_header(hstreams[0]).sample_rate
    he_audio_s = sum(o.shape[1] for o in he_outs) / out_rate
    cpu_he = decode_he_streams_device(hstreams[:HE_CPU_STREAMS],
                                      HE_FRAMES_PER_GROUP, device="cpu")
    he_lsb = 0
    for s, (o, c) in enumerate(zip(he_outs, cpu_he)):
        if o.shape != c.shape:
            raise AssertionError(f"HE stream {s}: {o.shape} != {c.shape}")
        he_lsb = max(he_lsb, int(np.abs(o.astype(np.int64) - c).max()))
    if he_lsb > 2:
        raise AssertionError(f"HE card vs CPU: {he_lsb} LSB")
    (_static, pcm, _cond, _state), (out, _) = seen["device_decode_group"]
    core, out = pcm.cpu().numpy(), out.cpu().numpy()
    ref = numpy_sbr_chain(hstreams[0], core[:2], core.shape[1])
    d = out[:2, :ref.shape[1]].astype(np.float64) - ref
    rel = float(np.abs(d).max() / max(np.abs(ref).max(), 1.0))
    he_rms = float(np.sqrt((d ** 2).mean() / ((ref ** 2).mean() + 1e-9)))
    if not (rel < 2e-3 and he_rms < 5e-4):
        raise AssertionError(f"HE group 0 vs numpy SBR chain: rel {rel:.3g}, "
                             f"rms {he_rms:.3g}")
    print(f"phase 9: {len(hstreams)} HE-AAC streams, {he_audio_s:.1f} s of "
          f"audio at {out_rate} Hz; stream 0 group 0 vs numpy SBR chain max "
          f"{rel:.3g} rms {he_rms:.3g} (relative); first {HE_CPU_STREAMS} "
          f"streams card vs cpu <= {he_lsb} LSB; launches {he_launches}; "
          f"wall {he_wall:.3f} s (first call {he_first:.3f} s); "
          f"{he_audio_s / he_wall:.1f} decoded audio s per wall s")
    check_precision()

    # --- phases 10-11: CELT serving, comb post-filter kernel --------------
    from ohpipeline_tpu_torch.codecs.opus import celt as pc

    cstreams = celt_streams()

    def serve_celt():
        t0 = time.perf_counter()
        out = pc.decode_celt_streams_device(cstreams, CELT_GROUP)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # the first call (it builds the CELT entropy core) also captures the
    # comb's arguments in group 0
    (_outs, celt_first), seen = first_calls(pc, ["comb"], serve_celt)
    *comb_args, win2 = seen["comb"][0]
    comb_err, comb_ms, comb_plain_ms, *comb_bound = check_celt_comb(
        "serving group 0", comb_args, win2)
    for name, case in (("worst case", celt_comb_worst_case(dev)),
                       ("lags 33-35 and 66-67", celt_comb_lag_case(dev))):
        comb_err = max(comb_err, check_celt_comb(name, case, win2)[0])

    check_precision()
    _kernels.reset_launches()
    celt_outs, celt_wall = serve_celt()
    celt_launches = _kernels.launches["celt_comb"]
    if celt_launches <= 0:
        raise AssertionError("the celt_comb kernel did not run on the CELT "
                             "path")
    S, CH, n = celt_outs.shape
    celt_audio_s = S * n / 48000.0
    cpu_celt = pc.decode_celt_streams_device(cstreams[:CELT_CPU_STREAMS],
                                             CELT_GROUP, device="cpu")
    celt_lsb = int(np.abs(celt_outs[:CELT_CPU_STREAMS].astype(np.int32)
                          - cpu_celt[..., :n]).max())
    if celt_lsb > 1:
        raise AssertionError(f"CELT card vs CPU: {celt_lsb} LSB")
    ref = host_celt_decode(cstreams[0])[:, :n]
    err = np.abs(celt_outs[0].astype(np.int32) - ref)
    snr = 20 * np.log10(np.sqrt((ref.astype(np.float64) ** 2).mean())
                        / max(np.sqrt((err ** 2.0).mean()), 1e-9))
    if not (err.max() <= 2 and snr >= 70.0):
        raise AssertionError(f"CELT stream 0 vs host decode: max "
                             f"{err.max()} LSB, {snr:.1f} dB")
    print(f"phase 11: {S} CELT streams of {CH} channels, {celt_audio_s:.1f} "
          f"s of audio at 48000 Hz; first {CELT_CPU_STREAMS} streams card vs "
          f"cpu <= {celt_lsb} LSB; stream 0 vs host celt.py max "
          f"{err.max()} LSB, {snr:.1f} dB; celt_comb launches "
          f"{celt_launches}; wall {celt_wall:.3f} s (first call "
          f"{celt_first:.3f} s); {celt_audio_s / celt_wall:.1f} decoded audio "
          f"s per wall s")
    check_precision()

    # --- phases 12-13: MP3 serving, polyphase window kernel ---------------
    from ohpipeline_tpu_torch.codecs.mp3 import synthesis as msyn
    from ohpipeline_tpu_torch.codecs.mp3.serving import (
        decode_mp3_streams_device)

    t0 = time.perf_counter()
    content = codec_content()
    mstreams = content["mp3"]
    print(f"phase 12: built {len(mstreams)} MP3 streams, "
          f"{2 * len(content['mp3_blocks'])} block-type and LSF streams and "
          f"{len(content['vorbis'])} Vorbis streams in "
          f"{time.perf_counter() - t0:.1f} s")

    def serve_mp3(streams, device="cuda"):
        t0 = time.perf_counter()
        outs = decode_mp3_streams_device(streams, MP3_FRAMES_PER_GROUP,
                                         device=device)
        torch.cuda.synchronize()
        return outs, time.perf_counter() - t0

    # the first call (it builds the MP3 Huffman core) also captures the
    # window pass's arguments in group 0
    (_outs, mp3_first), seen = first_calls(msyn, ["mp3_window"],
                                           lambda: serve_mp3(mstreams))
    vfull0, wnd, bd0 = seen["mp3_window"][0]
    win = [check_mp3_window("serving group 0", vfull0, wnd, bd0,
                            library=True)]
    worst = mp3_window_case(dev)
    for bd in (16, 24):
        win.append(check_mp3_window(f"worst case, {bd} bits", worst, wnd,
                                    bd))
    win_err = max(w[0] for w in win)
    _, win_ms, win_plain_ms, *win_bound, win_lib_ms = win[0]

    check_precision()
    _kernels.reset_launches()
    mp3_outs, mp3_wall = serve_mp3(mstreams)
    win_launches = _kernels.launches["mp3_window"]
    if win_launches <= 0:
        raise AssertionError("the mp3_window kernel did not run on the MP3 "
                             "path")
    mp3_audio_s = sum(o.shape[1] for o in mp3_outs) / 44100.0
    mp3_lsb = 0
    for name, card, batch in (
            ("bench", mp3_outs[:MP3_CPU_STREAMS], mstreams[:MP3_CPU_STREAMS]),
            ("block types", serve_mp3(content["mp3_blocks"])[0],
             content["mp3_blocks"]),
            ("LSF", serve_mp3(content["mp3_lsf"])[0], content["mp3_lsf"])):
        cpu = decode_mp3_streams_device(batch, MP3_FRAMES_PER_GROUP,
                                        device="cpu")
        for s, (o, c) in enumerate(zip(card, cpu)):
            if o.shape != c.shape:
                raise AssertionError(f"MP3 {name} stream {s}: {o.shape} != "
                                     f"{c.shape}")
            mp3_lsb = max(mp3_lsb, int(np.abs(o.astype(np.int64) - c).max()))
        if name != "bench":       # stream 0 through every block type
            ref = mp3_host_reference(batch[0])
            ref_err = np.abs(card[0] - ref).max()
            ref_snr = snr_db(ref, card[0])
            if not (ref_err <= 6 and ref_snr >= 80.0):
                raise AssertionError(f"MP3 {name} stream 0 vs float64 scan: "
                                     f"{ref_err} LSB, {ref_snr:.1f} dB")
    if mp3_lsb > 1:
        raise AssertionError(f"MP3 card vs CPU: {mp3_lsb} LSB")
    ref = mp3_host_reference(mstreams[0])
    mp3_err = float(np.abs(mp3_outs[0] - ref).max())
    mp3_snr = snr_db(ref, mp3_outs[0])
    if not (mp3_outs[0].shape == ref.shape and mp3_err <= 6
            and mp3_snr >= 80.0):
        raise AssertionError(f"MP3 stream 0 vs float64 scan: {mp3_err} LSB, "
                             f"{mp3_snr:.1f} dB")
    print(f"phase 13: {len(mstreams)} MP3 streams, {mp3_audio_s:.1f} s of "
          f"audio at 44100 Hz; first {MP3_CPU_STREAMS} streams and the "
          f"block-type and LSF streams card vs cpu <= {mp3_lsb} LSB; stream "
          f"0 vs the float64 scan {mp3_err:.0f} LSB, {mp3_snr:.1f} dB; "
          f"mp3_window launches {win_launches}; wall {mp3_wall:.3f} s "
          f"(first call {mp3_first:.3f} s); {mp3_audio_s / mp3_wall:.1f} "
          f"decoded audio s per wall s")
    check_precision()

    # --- phase 14: Vorbis serving -----------------------------------------
    from ohpipeline_tpu_torch._host import vorbis_synthesis as vsyn
    from ohpipeline_tpu_torch.codecs.vorbis import device as vdev

    vstreams = content["vorbis"]

    def serve_vorbis(streams, device="cuda"):
        t0 = time.perf_counter()
        outs = vdev.decode_vorbis_streams_device(streams, VORBIS_GROUP,
                                                 device=device)
        torch.cuda.synchronize()
        return outs, time.perf_counter() - t0

    _outs, vorbis_first = serve_vorbis(vstreams)
    vorbis_outs, vorbis_wall = serve_vorbis(vstreams)
    vorbis_audio_s = sum(o.shape[1] for o in vorbis_outs) / 44100.0
    cpu_v = vdev.decode_vorbis_streams_device(
        vstreams[:VORBIS_CPU_STREAMS], VORBIS_GROUP, device="cpu")
    v_lsb = 0
    for s, (o, c) in enumerate(zip(vorbis_outs, cpu_v)):
        if o.shape != c.shape:
            raise AssertionError(f"Vorbis stream {s}: {o.shape} != "
                                 f"{c.shape}")
        v_lsb = max(v_lsb, int(np.abs(o.astype(np.int64) - c).max()))
    if v_lsb > 1:
        raise AssertionError(f"Vorbis card vs CPU: {v_lsb} LSB")
    v_ref = []
    for s in (0, VORBIS_STREAMS // 2):      # a bench and a mixed stream
        info, blocks = vdev.capture_stream(vstreams[s])
        lap = vsyn.Lapper(info.channels, info.blocksize[0])
        ref = np.concatenate([lap.add_block(vsyn.imdct_many(x, n), n, pf, nf)
                              for n, pf, nf, x in blocks], axis=1)
        ref = np.clip(np.rint(ref * 32768.0), -32768, 32767)
        err = float(np.abs(vorbis_outs[s] - ref).max())
        db = snr_db(ref, vorbis_outs[s])
        if not (vorbis_outs[s].shape == ref.shape and err <= 2
                and db >= 60.0):
            raise AssertionError(f"Vorbis stream {s} vs host synthesis: "
                                 f"{err} LSB, {db:.1f} dB")
        v_ref.append(f"stream {s} {err:.0f} LSB {db:.1f} dB")
    print(f"phase 14: {len(vstreams)} Vorbis streams, {vorbis_audio_s:.1f} s "
          f"of audio at 44100 Hz; first {VORBIS_CPU_STREAMS} streams card vs "
          f"cpu <= {v_lsb} LSB; vs the host synthesis {', '.join(v_ref)}; "
          f"wall {vorbis_wall:.3f} s (first call {vorbis_first:.3f} s); "
          f"{vorbis_audio_s / vorbis_wall:.1f} decoded audio s per wall s")
    check_precision()

    # --- phases 15-16: the AAC codec plug-in, the HE-AAC v2 (PS) runner and
    # the PS decorrelator kernel --------------------------------------------
    _kernels.reset_launches()
    plug = []
    for path, lsb_max in ((AAC_ASSET, 1), (HE_ASSET, 2)):
        name = os.path.basename(path)
        info, card, codec = plugin_decode(path, "cuda")
        runner = getattr(codec._sbr, "_device_runner", None)
        if path == HE_ASSET and (runner is None
                                 or runner.device.type != "cuda"):
            raise AssertionError("the plug-in's HE groups did not take the "
                                 "device runner")
        cpu_info, cpu, _ = plugin_decode(path, "cpu")
        if card.shape != cpu.shape or info != cpu_info:
            raise AssertionError(f"plug-in {name}: card {card.shape} != cpu "
                                 f"{cpu.shape}")
        lsb = int(np.abs(card.astype(np.int64) - cpu).max())
        if lsb > lsb_max:
            raise AssertionError(f"plug-in {name} card vs CPU: {lsb} LSB")
        plug.append(f"{name} ({info.codec_name}) {card.shape} card vs cpu "
                    f"<= {lsb} LSB")
    plug_launches = {k: _kernels.launches[k] for k in ("sbr_env", "tns")}
    if plug_launches["sbr_env"] <= 0:
        raise AssertionError("the sbr_env kernel did not run in the plug-in")
    print(f"phase 16: CodecAacAdts on the card: {'; '.join(plug)}; launches "
          f"{plug_launches} (the plug-in runs TNS in the host prep, as the "
          f"reference's does)")

    t0 = time.perf_counter()
    pcontents = [ps_content(s, PS_FRAMES) for s in range(PS_STREAMS)]
    print(f"phase 16: built {PS_STREAMS} PS streams of {PS_FRAMES} frames in "
          f"{time.perf_counter() - t0:.1f} s")
    # the first call also captures the PS scan's arguments in group 0
    (_outs, ps_first), seen = first_calls(
        sbrd, ["ps_scan"], lambda: serve_ps(pcontents, "cuda"))
    real = seen["ps_scan"][0]
    psm_err, psm_ms, psm_plain_ms, *psm_bound, psm_floor = check_ps_mix(
        "PS group 0", real)
    worst = ps_mix_worst_case(dev)
    psm_err = max(psm_err, check_ps_mix("worst case", worst)[0])
    first_out = sbrd.ps_scan(*worst)
    chained = (*ps_mix_worst_case(dev, seed=16)[:3], first_out[4],
               *worst[4:])
    psm_err = max(psm_err, check_ps_mix("worst case, second of a chained "
                                        "pair", chained)[0])

    check_precision()
    _kernels.reset_launches()
    ps_outs, ps_wall = serve_ps(pcontents, "cuda")
    ps_launches = {k: _kernels.launches[k] for k in ("ps_mix", "sbr_env")}
    ps_groups = PS_STREAMS * -(-PS_FRAMES // PS_GROUP)
    if ps_launches["ps_mix"] != ps_groups or ps_launches["sbr_env"] <= 0:
        raise AssertionError(f"PS path launches {ps_launches}, want "
                             f"{ps_groups} ps_mix")
    ps_audio_s = sum(o.shape[1] for o in ps_outs) / 44100.0
    cpu_ps, _ = serve_ps(pcontents[:1], "cpu")
    ps_lsb = int(np.abs(ps_outs[0].astype(np.int64) - cpu_ps[0]).max())
    if ps_outs[0].shape != cpu_ps[0].shape or ps_lsb > 2:
        raise AssertionError(f"PS stream 0 card vs CPU: {ps_lsb} LSB")
    ref = numpy_ps_chain(ps_content(0, PS_FRAMES))
    d = ps_outs[0].astype(np.float64) - ref
    ps_rel = float(np.abs(d).max() / np.abs(ref).max())
    ps_rms = float(np.sqrt((d ** 2).mean() / (ref ** 2).mean()))
    if not (ps_rel < 5e-3 and ps_rms < 1e-3):
        raise AssertionError(f"PS stream 0 vs numpy chain: rel {ps_rel:.3g}, "
                             f"rms {ps_rms:.3g}")
    from ohpipeline_tpu_torch.tools import trace_call

    _prof, _events, ps_trace = trace_call(lambda: serve_ps(pcontents, "cuda"))
    print(f"phase 16: {PS_STREAMS} PS streams, {ps_audio_s:.1f} s of audio "
          f"at 44100 Hz in {ps_groups} groups; stream 0 card vs cpu <= "
          f"{ps_lsb} LSB, vs the numpy process_frame_ps chain max "
          f"{ps_rel:.3g} rms {ps_rms:.3g} (relative); launches {ps_launches}; "
          f"wall {ps_wall:.3f} s (first call {ps_first:.3f} s); "
          f"{ps_audio_s / ps_wall:.1f} decoded audio s per wall s; traced "
          f"call {ps_trace['wall_s']:.3f} s, device busy "
          f"{ps_trace['device_busy_ms']:.1f} ms, idle share "
          f"{ps_trace['idle_share']:.4f}")
    check_precision()

    # --- phase 17: the render path on the card ---------------------------
    lpc_render, render_launches = render_phase(jobs, tracks, streams)
    lpc_err = max(lpc_err, lpc_render[0])
    check_precision()

    # --- phase 18: the other plug-ins through the render path -------------
    win_plugin, plugin_launches = plugin_phase(content)
    win_err = max(win_err, win_plugin[0])
    on_path = {k: render_launches[k] + plugin_launches[k]
               for k in render_launches}
    check_precision()

    # --- phase 19: the multi-device layer --------------------------------
    mesh_errs = mesh_phase(streams, tracks, astreams, hstreams, mstreams)
    lpc_err = max(lpc_err, mesh_errs["lpc"])
    rice_err = max(rice_err, mesh_errs["rice"])
    tns_err = max(tns_err, mesh_errs["tns"])
    sbr_err = max(sbr_err, mesh_errs["sbr_env"])
    win_err = max(win_err, mesh_errs["mp3_window"])
    check_precision()

    # --- phase 20: the Av layer's MediaPlayer on the card -----------------
    seen, player_launches, unity, cpu = media_player_phase(tracks, streams,
                                                           mstreams)
    lpc_err = max(lpc_err, check_lpc("media player group 0",
                                     list(seen["lpc_synthesize"][0]),
                                     phase=20)[0])
    win_err = max(win_err, check_mp3_window("media player group 0",
                                            *seen["mp3_window"][0],
                                            phase=20)[0])
    sbr_err = max(sbr_err, check_sbr_env("media player group 0",
                                         seen["envelope_scan"][0],
                                         phase=20)[0])
    check_precision()

    # --- phase 21: the net layer on the card -------------------------------
    seen, net_launches = net_phase(tracks, streams, mstreams, unity, cpu)
    lpc_err = max(lpc_err, check_lpc("net play group 0",
                                     list(seen["lpc_synthesize"][0]),
                                     phase=21)[0])
    win_err = max(win_err, check_mp3_window("net play group 0",
                                            *seen["mp3_window"][0],
                                            phase=21)[0])
    sbr_err = max(sbr_err, check_sbr_env("net play group 0",
                                         seen["envelope_scan"][0],
                                         phase=21)[0])
    check_precision()

    def bounds(b, library_ms=None):
        return {"bound_ms": b[0], "bound_by": b[1], "library_ms": library_ms}

    def flag(name):
        """Whether the render path's counted plays (phase 17's warm FLAC
        and ADTS plays, phase 18's warm plays) launched the kernel, and how
        often; how often phase 20's counted playlist play did, and phase
        21 (a)'s counted play through the ODP control plane."""
        return {"on_render_path": on_path[name] > 0,
                "render_launches": on_path[name],
                "media_player_launches": player_launches[name],
                "net_launches": net_launches[name]}

    kernels = [
        {"name": "lpc", "route": "cuda",
         "source": "ohpipeline_tpu_torch/csrc/lpc.cu",
         "replaces": "ohpipeline_tpu/ops/lpc.py:131",
         "launches": counts["lpc"], "max_abs_err": lpc_err,
         "ms": lpc_ms, "plain_ms": lpc_plain_ms, **bounds(lpc_bound),
         **flag("lpc")},
        {"name": "rice", "route": "cuda",
         "source": "ohpipeline_tpu_torch/csrc/rice.cu",
         "replaces": "ohpipeline_tpu/codecs/flac/rice_jax.py:41",
         "launches": counts["rice"], "max_abs_err": rice_err,
         "ms": rice_ms, "plain_ms": rice_plain_ms, **bounds(rice_bound),
         **flag("rice")},
        {"name": "tns", "route": "cuda",
         "source": "ohpipeline_tpu_torch/csrc/tns.cu",
         "replaces": "ohpipeline_tpu/codecs/aac/synthesis.py:287",
         "launches": tns_launches, "max_abs_err": tns_err,
         "ms": tns_ms, "plain_ms": tns_plain_ms, **bounds(tns_bound),
         **flag("tns")},
        {"name": "sbr_env", "route": "cuda",
         "source": "ohpipeline_tpu_torch/csrc/sbr_env.cu",
         "replaces": "ohpipeline_tpu/codecs/aac/sbr_jax.py:489",
         "launches": he_launches["sbr_env"], "max_abs_err": sbr_err,
         "ms": sbr_ms, "plain_ms": sbr_plain_ms, **bounds(sbr_bound),
         **flag("sbr_env")},
        {"name": "celt_comb", "route": "cuda",
         "source": "ohpipeline_tpu_torch/csrc/celt_comb.cu",
         "replaces": "ohpipeline_tpu/codecs/opus/celt_jax.py:156",
         "launches": celt_launches, "max_abs_err": comb_err,
         "ms": comb_ms, "plain_ms": comb_plain_ms, **bounds(comb_bound),
         **flag("celt_comb")},
        {"name": "mp3_window", "route": "cuda",
         "source": "ohpipeline_tpu_torch/csrc/mp3_window.cu",
         "replaces": "ohpipeline_tpu/codecs/mp3/synthesis.py:346",
         "launches": win_launches, "max_abs_err": win_err,
         "ms": win_ms, "plain_ms": win_plain_ms,
         **bounds(win_bound, win_lib_ms), **flag("mp3_window")},
        {"name": "ps_mix", "route": "cuda",
         "source": "ohpipeline_tpu_torch/csrc/ps_mix.cu",
         "replaces": "ohpipeline_tpu/codecs/aac/sbr_jax.py:1149",
         "launches": ps_launches["ps_mix"], "max_abs_err": psm_err,
         "ms": psm_ms, "plain_ms": psm_plain_ms, **bounds(psm_bound),
         **flag("ps_mix")},
    ]
    print(f"phases 0-21 in {time.perf_counter() - t_start:.1f} s")
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
