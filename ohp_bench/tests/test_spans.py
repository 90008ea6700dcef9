"""Tests of the reading of the port's spans (``ohp_bench/spans.py``) and of
the per-layer metrics that read them, on the CPU.

    python -m pytest ohp_bench/tests/test_spans.py
"""

from __future__ import annotations

import json

import pytest

from ohp_bench import run, spans, trace
from ohp_bench.tests.test_bench import BENCH, ROOT, SEED, _small

MS = 1_000_000                                   # nanoseconds


def _span(id_, name, start, end, parent=None, thread="MainThread"):
    return {"name": name, "id": id_, "parent": parent, "thread": thread,
            "start_ns": start * MS, "end_ns": end * MS, "attrs": {},
            "request": None, "twin": False}


#: A serving call on the main thread (a parse with a launch nested in it,
#: a second parse, a collect, an assembly), a decode thread's parse and
#: prep with no parent, and a parse on a third thread; ms on one clock.
SPANS = [_span(1, "serve.call", 0, 100),
         _span(2, "serve.parse", 10, 40, parent=1),
         _span(3, "serve.launch", 20, 30, parent=2),
         _span(6, "serve.parse", 50, 70, parent=1),
         _span(7, "serve.collect", 75, 85, parent=1),
         _span(8, "serve.assemble", 85, 95, parent=1),
         _span(4, "codec.parse", 0, 50, thread="DecodePump"),
         _span(5, "codec.prep", 60, 80, thread="DecodePump"),
         _span(9, "codec.parse", 0, 40, thread="Filler")]
COUNTERS = {"h2d_bytes.codec.upload": 1_000_000,
            "h2d_bytes.codec.constants": 17_000_000,
            "h2d_bytes.serve.upload": 5_000_000, "groups.codec": 2}
WALL_S = 0.2


def _read(metric: str, window: dict):
    return run.load_module(ROOT / "metrics" / f"{metric}.py").read(window)


def test_self_time_leaves_out_the_children_of_each_span_by_parent_id():
    s = spans.summary(SPANS, COUNTERS, WALL_S)
    tot = s["totals"]
    assert tot["serve.call"] == pytest.approx(
        {"count": 1, "total_s": 0.100, "self_s": 0.030})
    assert tot["serve.parse"] == pytest.approx(
        {"count": 2, "total_s": 0.050, "self_s": 0.040})
    assert tot["serve.launch"] == pytest.approx(
        {"count": 1, "total_s": 0.010, "self_s": 0.010})
    # spans with no parent, on two threads: whole, and summed by name
    assert tot["codec.parse"] == pytest.approx(
        {"count": 2, "total_s": 0.090, "self_s": 0.090})
    assert s["threads"]["DecodePump"]["codec.parse"] == pytest.approx(
        {"count": 1, "total_s": 0.050, "self_s": 0.050})
    assert s["threads"]["Filler"]["codec.parse"]["total_s"] \
        == pytest.approx(0.040)
    assert set(s["threads"]["MainThread"]) == {
        "serve.call", "serve.parse", "serve.launch", "serve.collect",
        "serve.assemble"}
    assert s["counters"] == COUNTERS and s["wall_s"] == WALL_S
    json.dumps(s)                       # plain data, as a window holds


#: The readers' values on the summary of ``SPANS`` and ``COUNTERS``, for
#: the metrics this file was written with; a later metric's hand-built
#: check goes in a test file of its own.
EXPECTED = {"group_parse_share.batch": 100 * 0.040 / WALL_S,
            "collect_share.batch": 100 * 0.020 / WALL_S,
            "codec_host_share.play": 100 * 0.070 / WALL_S,
            "h2d_mb_per_group.play": 18.0 / 2}
SPAN_METRICS = [m["name"] for m in BENCH["per_layer"]
                if m["source"] in ("program_span", "program_counter")]


@pytest.mark.parametrize("metric", sorted(set(SPAN_METRICS) | set(EXPECTED)))
def test_a_span_metric_reads_nothing_without_its_spans(metric):
    """Every span or counter metric of ``BENCHMARK.json``, and every reader
    of this file's hand-built checks, returns None in an untraced window
    and in a recording where nothing it reads ran."""
    window = {"records": [{"t0": 0.0, "t1": 1.0, "audio_s": 2.0}],
              "wall_s": 1.0, "setup_s": 1.0}
    assert _read(metric, window) is None
    window["spans"] = spans.summary([], {}, WALL_S)
    assert _read(metric, window) is None


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_a_span_metric_reads_a_hand_built_summary(metric):
    window = {"records": [{"t0": 0.0, "t1": 1.0, "audio_s": 2.0}],
              "wall_s": 1.0, "setup_s": 1.0,
              "spans": spans.summary(SPANS, COUNTERS, WALL_S)}
    assert _read(metric, window) == pytest.approx(EXPECTED[metric])


def _untraced(run_):
    """``trace.traced`` without the profiler, which needs the card: runs
    ``run_`` and gives a trace with no device work."""
    run_()
    return {"window_s": 1.0, "busy_s": 0.0, "kernel_s": {},
            "host_blocked_s": 0.0, "device_ops": [], "idle_gaps": []}


@pytest.mark.parametrize("name", sorted({w for m in BENCH["per_layer"]
                                         if m["name"] in SPAN_METRICS
                                         for w in m["workloads"]}))
def test_a_recorded_run_on_the_cpu_reads_its_span_metrics(name,
                                                          monkeypatch):
    """A ``--trace 1`` run's recording of the port's spans, on the CPU at
    small sizes, gives every span metric of the cell a reading."""
    monkeypatch.setattr(trace, "traced", _untraced)
    line = run.run_cell(name, SEED, 0.5, True, "cpu", _small(name))
    assert line["correct"], line["checks"]
    for m in BENCH["per_layer"]:
        if m["name"] in SPAN_METRICS and name in m["workloads"]:
            value = line["metrics"][m["name"]]["value"]
            assert value > 0, m["name"]
            if m["unit"] == "%":
                assert value < 100, m["name"]
