"""Tests of the benchmark itself, on the CPU at small sizes (the cells'
``--trace`` and timing paths need the card; ``test_entry_on_the_card``
runs each entry there).

    python -m pytest ohp_bench/tests                      # here
    python -m pytest ohp_bench/tests -m gpu               # on the card
"""

from __future__ import annotations

import ast
import hashlib
import importlib
import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

from ohp_bench import control, run
from ohp_bench.content import aac as content_aac
from ohp_bench.content import flac as content_flac
from ohp_bench.reference import aac as ref_aac
from ohp_bench.reference import flac as ref_flac

ROOT = run.ROOT
REPO = ROOT.parent
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 2 ** 31 + 11
#: Every cell the harness has a file for (``flac_cd.play`` among them,
#: measured but left out of ``BENCHMARK.json``).
CELLS = sorted(p.stem for p in (ROOT / "workloads").glob("*.json"))
#: Each cell's sizes on the CPU, ``small/<cell>.json``: entries of the
#: cell's file, replaced where the tests run it.
SMALL = pathlib.Path(__file__).resolve().parent / "small"


def _small(name: str) -> dict:
    return run.load_json(SMALL / f"{name}.json")


def _entry(name: str) -> str:
    return run.load_json(ROOT / "workloads" / f"{name}.json")["entry"]


#: The cells of ``BENCHMARK.json`` that drive a batched serving call.
SERVING = [w["name"] for w in BENCH["workloads"]
           if _entry(w["name"]) == "serving"]
#: Every cell the harness has a file for that plays through the render path.
PLAYS = [c for c in CELLS if _entry(c) == "play"]

#: sha256 of the port's encoder's bytes at 15c54f8 (ohpipeline_tpu_torch/
#: host/codecs/flac/encoder.py, encode_flac(x, 44100, 16)), on make_track
#: of (seed, seconds) and on a stream of silence with a short DC tail.
ENCODER_DIGESTS = {
    (7, 2.0): "dec2d0f4e1ce296e9c77512ee6da8f35ca4adc82359a64a8ef2645e75a9aca62",
    (8, 1.3): "001b901ec238459d5826e9a98cee73a5b53b71d5df3b5606854fe9a222ac8b98",
    (2 ** 31 + 5, 0.7):
        "5b294a80566bb727085dd387d95a9670158d74586402aadbd6eb5bac0bfe39aa",
    "silence": "d860b033f173217d6bfa2f4ef0e536cf5a2cb4534f646514e60a696645481a57",
}


def _cell(name: str) -> dict:
    return {**run.load_json(ROOT / "workloads" / f"{name}.json"),
            **_small(name)}


def _cfg(cell: dict) -> dict:
    return run.load_json(ROOT / "configs" / f"{cell['config']}.json")


# ---------------------------------------------------------------------------
# the files, by name
# ---------------------------------------------------------------------------

def test_every_file_loads_by_name_and_every_name_is_allowed():
    cfg_names = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"]
        for key in ("content", "reference", "work"):
            assert (ROOT / key / f"{cfg[key]}.py").is_file()
        assert set(c["reduced"]) <= set(cfg["reduced"]) | set(cfg)
        assert all(NAME.match(k) for k in c["reduced"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for w in BENCH["workloads"]:
        cell = run.load_json(ROOT / "workloads" / f"{w['name']}.json")
        assert cell["name"] == w["name"] and cell["config"] == w["config"]
        assert cell["config"] in cfg_names
        assert cell["chips"] == w["chips"] in (1, 4)
        assert (ROOT / "entries" / f"{cell['entry']}.py").is_file()
        assert NAME.match(w["traffic"]) and len(w["why"]) <= 200
        reported = [m["name"] for m in metrics
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in reported and len(reported) >= 3
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "metrics" / f"{m['name']}.py").is_file()
        assert hasattr(run.load_module(ROOT / "metrics"
                                       / f"{m['name']}.py"), "read")
        assert set(m.get("workloads", [])) <= {w["name"]
                                               for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert all(NAME.match(n) for n in cfg_names | set(CELLS))
    assert {w["name"] for w in BENCH["workloads"]} <= set(CELLS)
    assert {p.stem for p in SMALL.glob("*.json")} <= set(CELLS)
    # four chips only where the contract allows: one such cell, or a
    # quarter of the cells rounded down, whichever is more
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_has_small_sizes_of_its_own_keys(name):
    """A cell is added with new files only: its file under ``workloads/``
    and its CPU sizes under ``tests/small/``, each an entry of the cell."""
    small = _small(name)
    assert small and set(small) <= set(
        run.load_json(ROOT / "workloads" / f"{name}.json"))


# ---------------------------------------------------------------------------
# content
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SERVING)
def test_content_is_the_same_for_a_seed_and_differs_for_another(name):
    cell = _cell(name)
    cfg = _cfg(cell)
    maker = run.load_module(ROOT / "content" / f"{cfg['content']}.py")
    a, b = maker.make(cfg, cell, SEED), maker.make(cfg, cell, SEED)
    c = maker.make(cfg, cell, SEED + 1)
    assert a["streams"] == b["streams"]
    assert a["streams"] != c["streams"]
    assert len(a["streams"]) == cell["streams"]


@pytest.mark.parametrize("key", list(ENCODER_DIGESTS))
def test_frozen_encoder_writes_the_bytes_of_the_port_encoder(key):
    if key == "silence":
        x = np.zeros((2, 5000), np.int32)
        x[1, 4000:] = 7
    else:
        x = content_flac.make_track(key[1], 44100, key[0])
    data = content_flac.encode_flac(x, 44100, 16)
    assert hashlib.sha256(data).hexdigest() == ENCODER_DIGESTS[key]


def test_flac_reference_is_the_seed_pcm_and_the_port_decodes_it():
    from ohpipeline_tpu_torch.codecs.flac import serving

    cell = _cell("flac_cd.batch")
    content = content_flac.make(_cfg(cell), cell, SEED)
    seeds = np.random.default_rng(SEED).integers(0, 2 ** 63, cell["streams"])
    for pcm, s in zip(content["pcm"], seeds):
        assert np.array_equal(
            pcm, content_flac.make_track(cell["stream_seconds"], 44100,
                                         int(s)))
    out = serving.decode_flac_streams_device(content["streams"], 32,
                                             device="cpu")
    assert ref_flac.compare(content, list(enumerate(out)), "serving",
                            cell) == {"pcm_mismatch": 0}


def test_encoder_counts_every_predicted_sample():
    x = content_flac.make_track(1.0, 44100, 3)
    _, st = content_flac.encode_flac(x, 44100, 16, stats=True)
    assert 0 < st["pred_samples"] <= x.size
    assert 0 < st["pred_taps"] <= 32 * st["pred_samples"]


@pytest.mark.parametrize("path", ["serving", "render"])
def test_aac_reference_agrees_with_the_port_on_the_cpu(path):
    """The reference against the port's CPU path, both of the port's PNS
    row numberings, within the cell's limit (the float32 synthesis of the
    port reads ~0.503 LSB from the float64 reference)."""
    from ohpipeline_tpu_torch.codecs import aac
    from ohpipeline_tpu_torch.codecs.aac import serving
    from ohpipeline_tpu_torch.host.codecs.base import (BufferReader,
                                                       EndOfStream)

    cell = _cell("aac_lc_radio.batch" if path == "serving"
                 else "aac_lc_radio.play")
    frames = content_aac.asset_frames()
    # frame 0 on: the asset's PNS frames within the first groups
    streams = [content_aac.tiled_stream(frames, s, 3.0) for s in (0, 40)]
    content = {"streams": streams}
    if path == "serving":
        out = serving.decode_aac_streams_device(streams, 64, device="cpu")
    else:
        out = []
        for s in streams:
            reader = BufferReader(s)
            codec = aac.CodecAacAdts(device="cpu")
            codec.stream_initialise(reader)
            parts = []
            while True:
                try:
                    parts.append(codec.process(reader).resolve())
                except EndOfStream:
                    break
            out.append(np.concatenate(parts, axis=1))
    gap = ref_aac.compare(content, list(enumerate(out)), path,
                          cell)["pcm_gap_lsb"]
    assert gap <= _cfg(cell)["limits"]["pcm_gap_lsb"]
    assert gap < 0.6


def test_aac_reference_parses_every_frame_of_the_asset():
    for f in content_aac.asset_frames():
        fr = ref_aac.parse_frame(f)
        assert len(fr.channels) == 2


# ---------------------------------------------------------------------------
# imports
# ---------------------------------------------------------------------------

def _imports(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(node.args[0].value)
    return {n.split(".")[0] for n in names if n}


def test_no_module_imports_jax_and_the_reference_nothing_of_the_port():
    for path in ROOT.rglob("*.py"):
        tops = _imports(path)
        assert not tops & {"jax", "jaxlib", "flax", "ohpipeline_tpu"}, path
        if path.parent.name in ("reference", "content"):
            assert "ohpipeline_tpu_torch" not in tops, path


def test_without_a_card_a_run_exits_non_zero_and_prints_no_result():
    p = subprocess.run([sys.executable, "-m", "ohp_bench.run", "--workload",
                        "flac_cd.batch", "--seed", "1", "--seconds", "1"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_directory_of_only_the_benchmark_exits_non_zero(tmp_path):
    import shutil

    shutil.copytree(ROOT, tmp_path / "ohp_bench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "-m", "ohp_bench.run", "--workload",
                        "flac_cd.batch", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


# ---------------------------------------------------------------------------
# a run on the CPU, its control, and the faults it must catch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_a_run_on_the_cpu_is_correct(name):
    line = run.run_cell(name, SEED, 0.5, False, "cpu", _small(name))
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert list(line)[-1] == "checks"
    assert "setup_s" in line["metrics"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_comparison(name):
    out = control.control(name, SEED, _small(name))
    assert all(c["failed"] for c in out["checks"].values()), out


#: How far a fault moves the one sample it alters, in LSB: well past the
#: AAC limit, as a wrong answer is.
ALTER = 64


def _alter_one_sample(fn):
    def broken(*a, **k):
        out = fn(*a, **k)
        out[-1] = out[-1].copy()
        out[-1][0, out[-1].shape[1] // 2] += ALTER
        return out
    return broken


def _drop_half(fn):
    def broken(*a, **k):
        out = fn(*a, **k)
        return out[:(len(out) + 1) // 2] + [np.zeros_like(o)
                                            for o in out[(len(out) + 1) // 2:]]
    return broken


def _serving_call(name):
    """The module and the function name of the serving call that cell
    ``name``'s configuration names."""
    module, fn = _cfg(_cell(name))["serving_call"].split(":")
    return importlib.import_module(module), fn


@pytest.mark.parametrize("fault", ["altered", "half_left_out"])
@pytest.mark.parametrize("name", SERVING)
def test_a_broken_serving_call_comes_out_not_correct(name, fault,
                                                     monkeypatch):
    mod, fn = _serving_call(name)
    wrap = _alter_one_sample if fault == "altered" else _drop_half
    monkeypatch.setattr(mod, fn, wrap(getattr(mod, fn)))
    line = run.run_cell(name, SEED, 0.5, False, "cpu", _small(name))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", ["aac_lc_radio.batch", "aac_lc_radio.play"])
def test_a_state_left_unchanged_comes_out_not_correct(name, monkeypatch):
    """The overlap carried from frame to frame, never advanced."""
    from ohpipeline_tpu_torch.codecs.aac import serving, synthesis

    def stale_planes(t, overlap, consts, _f=synthesis.decode_planes):
        pcm, _ = _f(t, overlap, consts)
        return pcm, overlap

    def stale_fast(spec_t, opidx_t, overlap, *consts,
                   _f=synthesis.filterbank_fast):
        pcm, _ = _f(spec_t, opidx_t, overlap, *consts)
        return pcm, overlap

    monkeypatch.setattr(serving, "decode_planes", stale_planes)
    monkeypatch.setattr(synthesis, "filterbank_fast", stale_fast)
    line = run.run_cell(name, SEED, 0.5, False, "cpu", _small(name))
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("name", PLAYS)
def test_a_broken_plug_in_comes_out_not_correct(name, monkeypatch):
    """A sample altered where the codec plug-in produces it."""
    from ohpipeline_tpu_torch.host.codecs.base import DecodedBatch

    real = DecodedBatch.resolve

    def resolve(self):
        out = real(self)
        if out.shape[1]:
            out = out.copy()
            out[0, out.shape[1] // 2] += ALTER
        return out

    monkeypatch.setattr(DecodedBatch, "resolve", resolve)
    line = run.run_cell(name, SEED, 0.5, False, "cpu", _small(name))
    assert not line["correct"], line["checks"]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_entry_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    line = run.run_cell(name, SEED, 1.0, True, "cuda", _small(name))
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0
    # every metric that reads the port's spans or counters finds them
    assert {m["name"] for m in run.cell_metrics(BENCH, name, True)
            if m["source"] in ("program_span", "program_counter")} \
        <= set(line["metrics"])
