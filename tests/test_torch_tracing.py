"""The port's spans and counters (ohpipeline_tpu_torch.tracing) on the CPU:
off outside a recording, the serving loop's and the render path's spans
with their parents and request ids, the byte counters against the tensors
handed over, the profiler's twins, and the spans of a thread the profiler
does not see placed on its clock by ``chrome_trace``."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from ohpipeline_tpu_torch import _host, tracing
from ohpipeline_tpu_torch import pipeline as tp
from ohpipeline_tpu_torch.codecs import aac, flac
from ohpipeline_tpu_torch.codecs.aac import serving as aac_serving
from ohpipeline_tpu_torch.codecs.aac import synthesis as aac_syn
from ohpipeline_tpu_torch.codecs.flac import serving as flac_serving

ASSETS = chip_smoke.HERE + "/tests/assets"
ADTS = open(ASSETS + "/dryrun.aac", "rb").read()
RATE = 44100
LIMIT_S = 120.0


def _tone(seed: int, seconds: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(RATE * seconds)) / RATE
    f = 200 + 1500 * rng.random()
    x = np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal(t.size)
    return np.stack([np.rint(x * 20000),
                     np.rint(np.roll(x, 17) * 15000)]).astype(np.int32)


def _adts_cut(frames: int) -> bytes:
    pos = 0
    for _ in range(frames):
        pos += _host.aac_bitstream.parse_adts_header(ADTS, pos).frame_bytes
    return ADTS[:pos]


#: codec -> (serving call, its streams, frames a group)
SERVING = {
    "flac": (flac_serving.decode_flac_streams_device,
             lambda: [_host.encode_flac(_tone(s, secs), RATE, 16,
                                        blocksize=1024)
                      for s, secs in ((1, 0.5), (2, 0.3), (3, 0.4))], 8),
    "aac": (aac_serving.decode_aac_streams_device,
            lambda: [_adts_cut(30), _adts_cut(13), ADTS], 8),
}


def _serve(codec: str):
    call, streams, group = SERVING[codec]
    return call(streams(), group, device="cpu")


def watchdog(fn, name: str, timeout: float = LIMIT_S):
    """fn() on a thread named ``name``, joined with a time limit."""
    out = {}

    def target():
        try:
            out["value"] = fn()
        except BaseException as exc:                   # noqa: BLE001
            out["error"] = exc

    t = threading.Thread(target=target, daemon=True, name=name)
    t.start()
    t.join(timeout)
    if t.is_alive():
        pytest.fail(f"the run did not end within {timeout} s")
    if "error" in out:
        raise out["error"]
    return out.get("value")


def _play(path: str) -> chip_smoke.Sink:
    """Plays ``path`` to its halt through the port's PipelineManager on the
    CPU, its AnimatorBatch on a thread named "Render"."""
    mgr = tp.PipelineManager(chip_smoke.render_params(
        tp.PipelineInitParams()), device="cpu")
    sink = chip_smoke.Sink()
    try:
        anim = tp.AnimatorBatch(mgr.pipeline.predriver, sink, device="cpu")
        mgr.play_uri("file://" + path)
        watchdog(anim.run, "Render")
    finally:
        mgr.quit()
    return sink


@pytest.fixture
def track(tmp_path, request):
    """A file to play: a FLAC tone or the ADTS asset."""
    if request.param == "flac":
        path = tmp_path / "t.flac"
        path.write_bytes(_host.encode_flac(_tone(7, 1.5), RATE, 16))
        return str(path)
    return os.path.abspath(ASSETS + "/dryrun.aac")


@pytest.mark.parametrize("codec", sorted(SERVING))
def test_off_records_nothing_and_changes_no_output(codec):
    assert tracing.span("serve.parse", block=0) is tracing._OFF
    off = _serve(codec)
    with tracing.recording() as rec:
        on = _serve(codec)
    with tracing.recording() as after:
        pass
    assert after.spans == [] and after.counters == {}
    assert rec.spans and len(on) == len(off)
    for a, b in zip(on, off):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("codec", sorted(SERVING))
def test_serving_spans_nest_under_their_call(codec):
    _serve(codec)
    with tracing.recording() as rec:
        _serve(codec)
        _serve(codec)
    by_id = {s["id"]: s for s in rec.spans}
    calls = [s for s in rec.spans if s["name"] == "serve.call"]
    assert len(calls) == 2 and all(c["parent"] is None for c in calls)
    assert calls[0]["request"] != calls[1]["request"]
    for call in calls:
        assert call["attrs"] == {"codec": {"flac": "flac",
                                           "aac": "aac_lc"}[codec],
                                 "streams": 3, "blocks": 1}
        inside = [s for s in rec.spans if s is not call
                  and call["start_ns"] <= s["start_ns"] <= call["end_ns"]]
        assert {s["name"] for s in inside} == {
            "serve.parse", "serve.launch", "serve.collect", "serve.assemble"}
        for s in inside:
            assert s["request"] == call["request"]
            assert s["end_ns"] <= call["end_ns"]
            top = s
            while top["parent"] is not None:
                top = by_id[top["parent"]]
            assert top is call
        first_parse = min((s for s in inside if s["name"] == "serve.parse"),
                          key=lambda s: s["start_ns"])
        assert first_parse["parent"] == call["id"]
        assert first_parse["attrs"] == {"block": 0}
        children = [s for s in inside if s["parent"] == call["id"]]
        covered = sum(s["end_ns"] - s["start_ns"] for s in children)
        assert covered >= 0.95 * (call["end_ns"] - call["start_ns"])
    def total_ns(name):
        return sum(s["end_ns"] - s["start_ns"] for s in rec.spans
                   if s["name"] == name)

    totals = tracing.totals(rec.spans)
    # each stream parses once: no survey span inside the parse
    assert totals["serve.parse"]["self_s"] == pytest.approx(
        total_ns("serve.parse") / 1e9)
    assert not any(s["name"] == "serve.survey" for s in rec.spans)
    groups = sum(s["name"] == "serve.launch" for s in rec.spans)
    assert rec.counters["groups.serve"] == groups > 2
    assert rec.wall_s * 1e9 >= sum(c["end_ns"] - c["start_ns"]
                                   for c in calls)


@pytest.mark.parametrize("track", ["flac", "aac"], indirect=True)
def test_a_play_records_the_plugin_on_the_pump_and_the_pull_on_the_caller(
        track):
    with tracing.recording() as rec:
        sink = _play(track)
    assert sink.samples > 0
    names = {}
    for s in rec.spans:
        names.setdefault(s["name"], set()).add(s["thread"])
    for name in ("codec.init", "codec.parse", "codec.prep", "codec.device",
                 "pump.push"):
        assert names[name] == {"DecodePump"}, name
    assert names["render.pull"] == {"Render"}
    streams = {s["request"] for s in rec.spans
               if s["name"].startswith("codec.")}
    assert len(streams) == 1 and streams.pop().startswith("stream.")
    pulls = [s for s in rec.spans if s["name"] == "render.pull"]
    assert pulls[-1]["request"] == next(
        s["request"] for s in rec.spans if s["name"] == "codec.init")
    assert rec.counters["groups.codec"] == sum(
        s["name"] == "codec.device" for s in rec.spans)


def _serve_counts(codec: str) -> None:
    _call, streams, group = SERVING[codec]
    if codec == "flac":
        want = sum(tracing.nbytes(*flac.to_device(planes, "cpu").values())
                   for planes, _ in flac_serving.iter_groups(streams(),
                                                             group))
    else:
        want = sum(tracing.nbytes(*(v for v in aac_serving.to_device(
            planes, "cpu").values() if isinstance(v, torch.Tensor)))
            for planes, _ in aac_serving.iter_groups(streams(), group))
    with tracing.recording() as rec:
        out = _serve(codec)
    assert rec.counters["h2d_bytes.serve.upload"] == want
    assert rec.counters["d2h_bytes.serve.copy_back"] >= sum(
        o.nbytes for o in out)


def _codec_flac() -> None:
    data = _host.encode_flac(_tone(4, 0.2), RATE, 16, blocksize=1024)
    meta = _host.parse_metadata(data)
    si = meta.streaminfo
    n, _pos, _st, batch = _host.native.flac_parse_group(
        data, meta.header_bytes * 8, sample_rate=si.sample_rate,
        bits_per_sample=si.bits_per_sample, max_blocksize=si.max_blocksize,
        channels=2, max_frames=16)
    with tracing.recording() as rec:
        flac.synthesise_batch(batch, 2, n, device="cpu")
    rows = {k: batch[k][:2 * n] for k in ("data", "coeffs", "shift",
                                          "order", "wasted")}
    rows["assign"] = batch["assign"][:n]
    assert rec.counters == {
        "h2d_bytes.codec.upload": sum(v.size * 4 for v in rows.values()),
        "groups.codec": 1,
        "d2h_bytes.codec.copy_back": rows["data"].size * 4}


def _codec_aac() -> None:
    n, _pos, batch = _host.aac_native().aac_parse_group(
        ADTS, 0, channels=2, max_frames=16)
    state = aac._StreamState(2)
    specs, opidx = aac_syn.prepare_group(batch, n, 2,
                                         state.prev_shape.copy())
    consts = aac_syn.filterbank_constants(device="cpu")
    with tracing.recording() as rec:
        aac.decode_group_arrays(batch, n, 2, state, device="cpu")
    assert rec.counters == {
        "h2d_bytes.codec.upload": specs.nbytes + opidx.nbytes
        + state.overlap.nbytes,
        "h2d_bytes.codec.constants": tracing.nbytes(*consts),
        "groups.codec": 1,
        "d2h_bytes.codec.copy_back": state.overlap.nbytes + specs.nbytes}


@pytest.mark.parametrize("check", [
    lambda: _serve_counts("flac"), lambda: _serve_counts("aac"),
    _codec_flac, _codec_aac], ids=["serve.flac", "serve.aac", "codec.flac",
                                   "codec.aac"])
def test_the_byte_counters_are_the_tensors_handed_over(check):
    check()


def _he_streams() -> list:
    """Two HE-AAC v1 streams: ``dryrun_he.aac`` whole, and from its frame
    10 (an SBR header frame) on."""
    data = open(ASSETS + "/dryrun_he.aac", "rb").read()
    pos = 0
    for _ in range(10):
        pos += _host.aac_bitstream.parse_adts_header(data, pos).frame_bytes
    return [data, data[pos:]]


def test_he_serving_records_the_sbr_parse_and_cond_build():
    """The HE-AAC serving call's SBR chain: ``sbr.parse`` inside each
    group's ``serve.parse``, ``sbr.cond`` on every launch, a frame counted
    for every SBR payload parsed, the cond planes' upload counted; and the
    recording changes no sample."""
    streams = _he_streams()
    off = aac_serving.decode_he_streams_device(streams, 16, device="cpu")
    with tracing.recording() as rec:
        on = aac_serving.decode_he_streams_device(streams, 16, device="cpu")
    for a, b in zip(on, off):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    by_id = {s["id"]: s for s in rec.spans}
    parses = [s for s in rec.spans if s["name"] == "sbr.parse"]
    groups = sum(s["name"] == "serve.launch" for s in rec.spans)
    assert len(parses) == groups == 3
    assert all(by_id[s["parent"]]["name"] == "serve.parse" for s in parses)
    conds = [s for s in rec.spans if s["name"] == "sbr.cond"]
    assert len(conds) == groups
    assert all(by_id[s["parent"]]["name"] == "serve.launch" for s in conds)
    frames = sum(o.shape[1] for o in on) // 2048
    assert frames == 46 + 36
    assert rec.counters["frames.sbr"] == frames
    assert rec.counters["h2d_bytes.sbr.cond"] > 0


def _profiled_serving_loop() -> list:
    """The names of the profiler's events of a two-group serving loop run
    on a profiled thread outside a recording."""
    from ohpipeline_tpu_torch.codecs import _serving

    outs = [[]]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("serve.call"):
            _serving.serve_blocks([(np.ones((2, 3), np.int32)
                                    for _ in range(2))],
                                  lambda i, item: (item,),
                                  outs[0].append)
            _serving.assemble(outs, 2)
    return [e.name for e in prof.events()]


def test_outside_a_recording_a_profiled_thread_sees_the_spans_as_host_ops():
    """The profiler's own timeline names the serving loop's host work, so
    a trace's idle gaps fall inside a span; the spans around work that
    enqueues on the device (the call, launch, collect) open no twin."""
    names = _profiled_serving_loop()
    assert [n for n in names if n.startswith("serve.")] == [
        "serve.parse", "serve.parse", "serve.parse", "serve.assemble"]
    assert tracing.TWINS == {"serve.parse", "serve.assemble", "render.pull",
                             "sbr.cond"}


@pytest.mark.gpu
def test_on_the_card_no_span_is_counted_as_device_work():
    """A FLAC serving call on the card, profiled outside a recording: the
    device's timeline holds its kernels and copies and no span's name."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.autograd import DeviceType

    call, streams, group = SERVING["flac"]
    data = streams()
    call(data, group, device="cuda")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call(data, group, device="cuda")
        torch.cuda.synchronize()
    device = [e.name for e in prof.events()
              if getattr(e, "device_type", None) == DeviceType.CUDA]
    host = {e.name for e in prof.events()}
    assert device and {"serve.parse", "serve.assemble"} <= host
    assert not [n for n in device if n.split(".")[0] in (
        "serve", "codec", "render", "pump")]


def _unseen_worker(seconds: float) -> tuple:
    """A thread, started now (before the profiler), that opens one
    "worker.step" span of ``seconds`` once ``go`` is set, then sets
    ``done``: (go, done)."""
    go, done = threading.Event(), threading.Event()

    def worker():
        go.wait(LIMIT_S)
        with tracing.span("worker.step"):
            time.sleep(seconds)
        done.set()

    threading.Thread(target=worker, daemon=True, name="Worker").start()
    return go, done


def test_a_thread_the_profiler_does_not_see_lands_between_its_twins(
        tmp_path):
    go, done = _unseen_worker(0.003)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.recording() as rec:
            for k in range(3):
                with tracing.span("serve.parse", block=k):
                    time.sleep(0.001)
            go.set()
            assert done.wait(LIMIT_S)
            for k in range(3, 6):
                with tracing.span("serve.parse", block=k):
                    time.sleep(0.001)
    path = tmp_path / "trace.json"
    tracing.chrome_trace(prof, str(path), rec.spans)
    events = json.loads(path.read_text())["traceEvents"]
    twins = sorted(((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("name") == "serve.parse"
                    and e.get("cat") == "user_annotation"))
    assert len(twins) == 6
    before, after = twins[2][1], twins[3][0]
    (start, end), = ((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("name") == "worker.step"
                     and e.get("cat") == "span")
    assert before - 100 <= start and end <= after + 100
    assert end - start >= 3000


def test_a_trace_without_spans_is_the_profilers_and_one_without_twins_raises(
        tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()
    path = tmp_path / "trace.json"
    assert tracing.chrome_trace(prof, str(path), []) == 0.0
    events = json.loads(path.read_text())["traceEvents"]
    assert not [e for e in events if e.get("cat") == "span"]
    go, done = _unseen_worker(0.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.recording() as rec:
            go.set()
            assert done.wait(LIMIT_S)
    with pytest.raises(ValueError, match="no span has a profiler twin"):
        tracing.chrome_trace(prof, str(path), rec.spans)


def test_counters_and_spans_from_many_threads_lose_nothing():
    """More threads than cores, a short switch interval: every increment
    and every span is kept, each under its own thread's parent."""
    threads_n, rounds = 4 * (os.cpu_count() or 2), 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with tracing.recording() as rec:
            def work():
                for _ in range(rounds):
                    with tracing.span("outer", request=tracing.NEW):
                        with tracing.span("inner"):
                            tracing.count("stress.n", 3)

            ts = [threading.Thread(target=work) for _ in range(threads_n)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(LIMIT_S)
            assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(interval)
    assert rec.counters["stress.n"] == 3 * threads_n * rounds
    by_id = {s["id"]: s for s in rec.spans}
    assert len(by_id) == len(rec.spans) == 2 * threads_n * rounds
    for s in rec.spans:
        if s["name"] == "inner":
            parent = by_id[s["parent"]]
            assert parent["name"] == "outer"
            assert (parent["thread"], parent["request"]) == (s["thread"],
                                                            s["request"])
    assert len({s["request"] for s in rec.spans}) == threads_n * rounds


def test_recordings_do_not_nest_and_snapshot_holds_the_launches():
    with tracing.recording():
        with pytest.raises(RuntimeError, match="already open"):
            with tracing.recording():
                pass
    snap = tracing.snapshot()
    assert {f"launches.{k}" for k in tracing._kernels.launches} <= set(snap)


@pytest.mark.parametrize("kind", ["serving", "render"])
def test_trace_cost_shares_are_the_spans_over_the_recordings_wall(kind):
    from ohpipeline_tpu_torch.tools import trace_cost

    with tracing.recording() as rec:
        if kind == "serving":
            _serve("flac")
        else:
            _play(os.path.abspath(ASSETS + "/dryrun.aac"))
    got = trace_cost.shares(rec, kind)

    def pct(names, thread=None):
        return pytest.approx(100 * sum(
            s["end_ns"] - s["start_ns"] for s in rec.spans
            if s["name"] in names and thread in (None, s["thread"]))
            / 1e9 / rec.wall_s)

    if kind == "serving":
        assert "survey_share" not in got
        assert got["calls"] == 1
        assert got["regrows"] == rec.counters.get("regrow.serve", 0)
        assert got["group_parse_share"] == pct({"serve.parse"})
        assert got["group_parse_share"] > 0
        assert got["collect_share"] == pct({"serve.collect",
                                            "serve.assemble"})
        assert got["groups_per_s"] == pytest.approx(
            rec.counters["groups.serve"] / rec.wall_s)
    else:
        assert got["codec_host_share"] == pct({"codec.parse", "codec.prep"},
                                              "DecodePump")
        assert got["render_pull_share"] == pct({"render.pull"})
        assert got["codec_host_share"] > 0 and got["render_pull_share"] > 0
        assert got["h2d_mb_per_group"] == pytest.approx(
            (rec.counters["h2d_bytes.codec.upload"]
             + rec.counters["h2d_bytes.codec.constants"])
            / rec.counters["groups.codec"] / 1e6)
    with tracing.recording() as empty:
        pass
    assert trace_cost.shares(empty, kind)["groups_per_s"] == 0
    assert trace_cost.counter_cost({
        "upload": [torch.zeros(3)], "constants": [],
        "copy_back": [torch.zeros(2)]}) > 0
