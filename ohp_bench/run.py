"""Run one cell of the benchmark of ``ohpipeline_tpu_torch`` on the card.

    python3 -m ohp_bench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the repository root.  Everything is found by name: the cell is
``workloads/<cell>.json``; it names its configuration
(``configs/<config>.json``) and its entry (``entries/<entry>.py``); the
configuration names its content maker (``content/<content>.py``), its
plain reference (``reference/<reference>.py``) and its kernels' work counts
(``work/<work>.py``); each metric that ``BENCHMARK.json`` gives the cell is
read by ``metrics/<metric>.py``.

A run makes its content from ``--seed``, warms up at the cell's own shapes
(set-up, ``setup_s``: from the start of this module to the first timed
request), measures for ``--seconds``, and with ``--trace 1`` then traces
the cell's ``traced_requests`` further requests under torch.profiler.  It
then compares what the timed path produced with the reference, prints each
number compared beside its limit on standard error, and prints one JSON
line last on standard output.  With ``--trace 0`` the line's metrics are the
cell's end-to-end metrics, with ``--trace 1`` its per-layer ones.

It exits non-zero and prints no result line when torch sees no CUDA device
or fewer than the cell asks for, and when, after the window, the process
has loaded ``jax``, ``jaxlib``, ``flax`` or the JAX package.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent
#: Top-level modules the process must not hold once the window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "ohpipeline_tpu")


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path):
    """The module in ``path``, a file of this package.  A file whose name
    is no identifier (a metric's name holds dots) is loaded from its path,
    in its directory's package, so that its relative imports work."""
    rel = path.relative_to(ROOT).with_suffix("")
    package = ".".join(("ohp_bench",) + rel.parts[:-1])
    if rel.name.isidentifier():
        return importlib.import_module(f"{package}.{rel.name}")
    spec = importlib.util.spec_from_file_location(
        f"{package}.{rel.name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    mod.__package__ = package
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metrics of ``BENCHMARK.json`` that ``cell`` reports: its
    end-to-end ones, or with ``trace`` its per-layer ones."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str, cell_overrides: dict | None = None) -> dict:
    """Set-up, window, optional trace and check of cell ``name`` on
    ``device``.  Returns the result line (without the device's name and
    count, which :func:`main` adds).  ``cell_overrides`` replaces entries of
    the cell's file (the tests run cells at small sizes on the CPU)."""
    import torch

    bench = load_json(ROOT.parent / "BENCHMARK.json")
    cell = {**load_json(ROOT / "workloads" / f"{name}.json"),
            **(cell_overrides or {})}
    cfg = load_json(ROOT / "configs" / f"{cell['config']}.json")
    content_mod = load_module(ROOT / "content" / f"{cfg['content']}.py")
    reference = load_module(ROOT / "reference" / f"{cfg['reference']}.py")
    work = load_module(ROOT / "work" / f"{cfg['work']}.py")
    entry = load_module(ROOT / "entries" / f"{cell['entry']}.py")

    t_import = time.perf_counter() - T0
    content = content_mod.make(cfg, cell, seed)
    t_content = time.perf_counter() - T0
    session = entry.Session(cfg, cell, seed, device, content)
    setup_s = time.perf_counter() - T0
    print(f"setup: imports {t_import:.3f} s, content "
          f"{t_content - t_import:.3f} s, warm-up {setup_s - t_content:.3f} s",
          file=sys.stderr)
    window = session.window(seconds)
    window["setup_s"] = setup_s
    took = sorted(r["t1"] - r["t0"] for r in window["records"])
    print(f"window: {len(took)} requests in {window['wall_s']:.3f} s, each "
          f"{took[0]:.4f} / {took[len(took) // 2]:.4f} / {took[-1]:.4f} s "
          f"(least / median / most)", file=sys.stderr)
    if trace:
        from . import spans
        from . import trace as tr
        n = int(cell["traced_requests"])
        # the port's spans, recorded over the same requests as the trace;
        # those with a profiler twin still name the trace's idle gaps.
        # They are reduced once the profiled stretch has ended.
        recs = []
        window["trace"] = tr.traced(lambda: recs.append(
            spans.recorded(lambda: session.traced_requests(n))))
        window["spans"] = spans.summary(recs[0].spans, recs[0].counters,
                                        recs[0].wall_s)
        window["work"] = {k: {q: v * n for q, v in w.items()} for k, w in
                          work.per_request(content, cell).items()}
    dev = {"platform": "gpu" if device != "cpu" else "cpu"}
    if device != "cpu":
        dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
    if trace:
        dev.update(busy_s=window["trace"]["busy_s"],
                   window_s=window["trace"]["window_s"])
    outputs = session.outputs()
    session.close()
    del session
    checks = reference.compare(content, outputs, entry.Session.kind, cell)
    limits = cfg["limits"]
    correct = all(checks[k] <= limits[k] for k in limits)
    metrics = {}
    for m in cell_metrics(bench, name, trace):
        reader = load_module(ROOT / "metrics" / f"{m['name']}.py")
        value = reader.read(window)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": bool(correct), "attempted": len(window["records"]),
            "failed": 0, "metrics": metrics, "device": dev}
    if trace:
        line["breakdown"] = {k: window["trace"][k]
                             for k in ("device_ops", "idle_gaps")}
    line["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                      for k in limits}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m ohp_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    cell = load_json(ROOT / "workloads" / f"{args.workload}.json")
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"ohp_bench: cell {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    line = run_cell(args.workload, args.seed, args.seconds,
                    bool(args.trace), "cuda")
    line["device"].update(kind=torch.cuda.get_device_name(0),
                          count=int(cell["chips"]))
    line["device"] = {k: line["device"][k] for k in
                      ("platform", "kind", "count", "memory_peak_bytes",
                       *(("busy_s", "window_s") if args.trace else ()))}
    bad = forbidden_modules()
    if bad:
        print(f"ohp_bench: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
