"""Where the time of the AAC-LC and HE-AAC v1 serving calls, of the
HE-AAC v2 (parametric stereo) leg and of an AAC-LC play goes, on the card.

    python -m ohpipeline_tpu_torch.tools.profile_aac [--out DIR]

from the repository root.  On ``chip_smoke.py``'s content (AAC-LC: phase
7's 48 streams of ``tests/assets/dryrun.aac``, 64 frames a group; HE-AAC
v1: phase 9's 16 streams of ``dryrun_he.aac``, 48 frames a group; the PS
leg: phase 16's 16 ``ps_content`` streams through one
``SbrPsDeviceRunner`` each in spec mode, 96 frames a group; the play:
``dryrun.aac`` through the render path), after one warm-up call of each:

1. AAC-LC: a recorded call (``tools.recorded``: one warm call inside
   ``tracing.recording()``; each span's count, total and self seconds:
   ``serve.parse``, ``serve.launch``, ``serve.collect``,
   ``serve.assemble``; the counters).  HE-AAC v1 and the PS leg: a staged
   call, the serving loop with ``torch.cuda.synchronize()`` after each
   stage, each stage's seconds summed over the groups.  HE-AAC v1: the
   per-group parse (the native unpacker and the side rows), the SBR
   payloads' parse and dequantisation (``sbr_chain.sbr_frames``), the cond
   build (``SbrDeviceRunner._build_stacked_cond``), upload, the group pass
   (``synthesis.decode_planes``, the SBR group
   ``sbr.device_decode_group`` and the rounding), copy-back.  The PS leg
   (its content is parsed before the call): the cond build and the mixing
   matrices (``build_frame_cond``, ``build_ps_H_slots``), upload, the group
   pass (``core_imdct_device``, ``device_decode_group_ps``), copy-back;
2. three warm unstaged calls of each, wall seconds;
3. one warm call of each under ``torch.profiler`` (``tools.trace_call``):
   device time by kernel name, the union of the device's busy intervals,
   and the idle share, 1 - busy / wall; each trace, with the spans of the
   call, goes to ``DIR/profile_aac.<leg>.trace.json`` (DIR defaults to the
   current directory).

The play: one ``PipelineManager`` and ``AnimatorBatch`` made before the
profiler starts, as a renderer keeps them, play the asset once to warm up,
once recorded (the plug-in's ``codec.init``, ``codec.parse``,
``codec.prep`` and ``codec.device`` and the pump's ``pump.push`` on the
pipeline's ``DecodePump`` thread, ``render.pull`` and ``render.gain`` on
the caller; the codec's groups and bytes up and back) and once traced and
recorded: ``DIR/profile_aac.play.trace.json`` places the pump thread's
spans, which the profiler does not see, on its clock.

Prints each part and then one JSON line with all the numbers, after the
card's name and power limit.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .. import bench_secondary
from ..codecs.aac import sbr as sbrd
from ..codecs.aac import sbr_chain, serving
from ..codecs.aac import synthesis as syn
from . import recorded, smoke
from .profile_mp3_vorbis import Clock, profile, traced


def staged_he(streams: list, G: int, dev) -> dict:
    """decode_he_streams_device's loop, stage by stage (one block)."""
    from .._host import aac_bitstream, sbr_native
    from .._host import aac_sbr as SBR

    nch, ri = serving._header(streams)
    rate = aac_bitstream.parse_adts_header(streams[0]).sample_rate
    consts = syn.device_constants(ri, device=dev)
    sbr_native()
    decs = [SBR.SbrDecoder(rate) for _ in streams]
    runner = None
    groups = 0
    clock = Clock("parse", "sbr_parse_dequant", "cond_build", "upload",
                  "group_pass", "copy_back")
    gen = serving.iter_groups(streams, G, sbr=True)
    try:
        for planes, counts in gen:
            clock("parse")
            per_ch = [([], [], []) for _ in range(len(streams) * nch)]
            for (s, _n), payloads in zip(counts, planes["sbr"]):
                sbr_chain.sbr_frames(decs[s], s, payloads, nch, None,
                                     per_ch[s * nch:(s + 1) * nch])
            clock("sbr_parse_dequant")
            if runner is None:
                runner = sbrd.SbrDeviceRunner(decs[0], len(per_ch),
                                              device=dev)
            F = planes["q4"].shape[0]
            stacked = runner._build_stacked_cond(len(per_ch), F, per_ch)
            clock("cond_build")
            t = serving.to_device(planes, dev)
            cond = sbrd.cond_to_device(stacked, dev)
            clock("upload")
            pcm, runner._core_ov = syn.decode_planes(t, runner._core_ov,
                                                     consts)
            out, runner._stacked = sbrd.device_decode_group(
                runner.static, pcm.transpose(0, 1), cond,
                runner._stacked)
            pcm16 = sbrd._pcm16(out)
            clock("group_pass")
            pcm16.cpu().numpy()
            clock("copy_back")
            groups += 1
    finally:
        gen.close()
    return {**clock.t, "groups": groups}


def staged_ps(contents: list, G: int, dev) -> dict:
    """chip_smoke.serve_ps's loop, stage by stage: every stream's group in
    turn (SbrPsDeviceRunner.decode_group_lazy_spec split at its stages)."""
    clock = Clock("cond_build", "upload", "group_pass", "copy_back")
    runners = [sbrd.SbrPsDeviceRunner(c["dec"], device=dev)
               for c in contents]
    groups = 0
    for g0 in range(0, len(contents[0]["datas"]), G):
        sl = slice(g0, g0 + G)
        for r, c in zip(runners, contents):
            clock.t0 = time.perf_counter()
            cond = sbrd.build_frame_cond(r.dec, r.state_host, r.static,
                                         c["datas"][sl], c["Es"][sl],
                                         c["Qs"][sl], r.first)
            r.first = False
            H = sbrd.build_ps_H_slots(r.pdec_host, c["ps"][sl], sbrd.NOUT)
            clock("cond_build")
            cd = sbrd.cond_to_device({k: v[None] for k, v in
                                      vars(cond).items()}, dev)
            spec = torch.from_numpy(np.asarray(c["specs"][sl],
                                               np.float32)[None]).to(dev)
            op = torch.from_numpy(np.asarray(c["ops"][sl],
                                             np.int64)[None]).to(dev)
            Ht = torch.from_numpy(H[None]).to(dev)
            if r._core_ov is None:
                r._core_ov = torch.zeros((1, 1024), device=dev)
            clock("upload")
            pcm, r._core_ov = sbrd.core_imdct_device(spec, op, r._core_ov)
            out, r.state_dev, r.ps_state, r.syn_state_r = \
                sbrd.device_decode_group_ps(r.static, r.ps_static, pcm, cd,
                                            r.state_dev, r.ps_state,
                                            r.syn_state_r, Ht)
            pcm16 = sbrd._pcm16(out[0])
            clock("group_pass")
            pcm16.cpu().numpy()
            clock("copy_back")
            groups += 1
    return {**clock.t, "groups": groups}


def play(path: str, dev, chrome: str) -> dict:
    """Plays ``path`` through the render path on ``dev``: recorded once,
    then traced (profiler and recording) into ``chrome``."""
    from .. import pipeline

    cs = smoke()
    mgr = pipeline.PipelineManager(
        cs.render_params(pipeline.PipelineInitParams()), device=dev)
    try:
        sink = cs.Sink()
        anim = pipeline.AnimatorBatch(mgr.pipeline.predriver, sink,
                                      device=dev)

        def run():
            mgr.play_uri("file://" + path)
            anim.run()

        run()                                               # warm-up
        rec = recorded(run)
        print("play recorded:", rec)
        trace = traced(run, chrome)
        print("play trace:", trace)
    finally:
        mgr.quit()
    return {"recorded": rec, "trace": trace}


def main() -> None:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "ohpipeline_tpu_torch.tools.profile_aac")
    ap.add_argument("--out", default=".", help="directory of the traces")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_aac: no CUDA device")
    dev = torch.device("cuda")
    card = bench_secondary.card_line(dev)
    cs = smoke()
    lc, he = cs.aac_streams(), cs.he_streams()
    t0 = time.perf_counter()
    ps = [cs.ps_content(s, cs.PS_FRAMES) for s in range(cs.PS_STREAMS)]
    print(f"PS content built in {time.perf_counter() - t0:.1f} s")
    G_lc, G_he, G_ps = (cs.AAC_FRAMES_PER_GROUP, cs.HE_FRAMES_PER_GROUP,
                        cs.PS_GROUP)

    def out(leg: str) -> str:
        return os.path.join(args.out, f"profile_aac.{leg}.trace.json")

    def call_lc():
        return serving.decode_aac_streams_device(lc, G_lc, device=dev)

    res = {
        "aac_lc": profile(
            "aac_lc", call_lc, lambda: recorded(call_lc),
            bench_secondary.per_rate(44100), out("aac_lc")),
        "he_aac": profile(
            "he_aac", lambda: serving.decode_he_streams_device(
                he, G_he, device=dev),
            lambda: staged_he(he, G_he, dev),
            bench_secondary.per_rate(bench_secondary.he_output_rate(he)),
            out("he_aac")),
        "ps": profile(
            "ps", lambda: cs.serve_ps(ps, "cuda")[0],
            lambda: staged_ps(ps, G_ps, dev),
            bench_secondary.per_rate(44100), out("ps")),
        "play": play(os.path.abspath(cs.AAC_ASSET), dev, out("play")),
    }
    print(card)
    print(json.dumps({"card": card, **res}))


if __name__ == "__main__":
    main()
