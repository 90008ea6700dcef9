"""What the port's tracing costs, and the shares of the wall its spans give,
in the benchmark's cells on the card.

    python -m ohpipeline_tpu_torch.tools.trace_cost [--cells CELL...] \\
        [--windows P] [--seconds W] [--seed N] [--out PATH]

from the repository root (it builds each cell as ``ohp_bench.run`` does:
the cell's content from ``--seed``, its session, warmed up).  It measures:

1. the cost of one span site, on the CPU: an empty call, a span outside a
   recording (with and without an attribute) and one inside a recording;
   and of one group's counters (``count`` and ``nbytes``, as the group's
   sites call them): a serving group's upload, group and copy back, on the
   tensors of the cell's first group; a plug-in group's upload, constants,
   group and copy back, on the filterbank constants and three tensors in
   place of the group's spectra, indices and overlap;
2. in each cell, ``P`` windows of ``W`` seconds with recording off and
   ``P`` with it on, in turns (off on on off ...), each window's rate
   (``decode_x`` or ``play_x``, as the benchmark's readers compute it)
   and, with recording on, the spans' shares of the recording's wall:
   the batch cells' per-group parse (``serve.parse`` self time),
   ``serve.collect`` + ``serve.assemble``, ``serve.launch`` and
   ``serve.call``, with the calls and the lists regrown
   (``regrow.serve``) in the window; the play cell's ``codec.parse`` +
   ``codec.prep`` and ``codec.device`` on ``DecodePump``, ``pump.push``,
   ``render.pull``, ``render.gain``, and the bytes up a plug-in group;
   spans and groups a second;
3. per cell, the medians off and on, their ratio, and the cost of tracing
   counted bottom up: spans a second times a span's cost (on, and off),
   groups a second times a group's counters.

Prints one JSON line for each, after the card's name and power limit, and
appends them to ``--out`` too.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

from .. import tracing

CELLS = ("flac_cd.batch", "aac_lc_radio.batch", "aac_lc_radio.play")


def _ns_per(fn, n: int = 200_000) -> float:
    """Nanoseconds per fn() call, the least of five runs of ``n``."""
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        best = min(best, (time.perf_counter_ns() - t0) / n)
    return best


def span_costs() -> dict:
    """ns per span site: empty call, off, off with an attribute, on, on with
    an attribute (a recording's spans dropped every run)."""
    span = tracing.span

    def bare():
        pass

    def off():
        with span("serve.launch"):
            pass

    def off_attr():
        with span("serve.parse", block=3):
            pass

    out = {"bare": _ns_per(bare), "off": _ns_per(off),
           "off_attr": _ns_per(off_attr)}
    for key, fn in (("on", off), ("on_attr", off_attr)):
        best = float("inf")
        for _ in range(5):
            with tracing.recording():
                t0 = time.perf_counter_ns()
                for _ in range(20_000):
                    fn()
                best = min(best, (time.perf_counter_ns() - t0) / 20_000)
        out[key] = best
    return out


def _first_group(cfg: dict, cell: dict, content: dict, device) -> dict:
    """The tensors one group's counters read, from the cell's content:
    {"upload": [...], "constants": [...], "copy_back": [...]}."""
    if cell["entry"] == "serving":
        streams, G = content["streams"], int(cell["frames_per_group"])
        if "flac" in cfg["serving_call"]:
            from ..codecs import flac
            from ..codecs.flac import serving
            planes, _ = next(serving.iter_groups(streams, G))
            up = list(flac.to_device(planes, device).values())
        else:
            from ..codecs.aac import serving
            planes, _ = next(serving.iter_groups(streams, G))
            up = [v for v in serving.to_device(planes, device).values()
                  if isinstance(v, torch.Tensor)]
        return {"upload": up, "constants": [], "copy_back": up[:1]}
    from ..codecs.aac import synthesis
    consts = list(synthesis.filterbank_constants(device=device))
    up = [torch.zeros(32, 2, 1024, device=device),
          torch.zeros(32, 2, dtype=torch.int32, device=device),
          torch.zeros(2, 1024, device=device)]
    return {"upload": up, "constants": consts, "copy_back": up[:1]}


def counter_cost(group: dict) -> float:
    """ns for one group's counters, called as its sites call them."""
    count, nbytes = tracing.count, tracing.nbytes
    up, consts, back = group["upload"], group["constants"], group["copy_back"]

    def serve():
        count("trace_cost.h2d", nbytes(*up))
        count("trace_cost.groups")
        count("trace_cost.d2h", back[0].nbytes)

    def codec():
        count("trace_cost.h2d", nbytes(*up))
        count("trace_cost.constants", nbytes(*consts))
        count("trace_cost.groups")
        count("trace_cost.d2h", back[0].nbytes + up[-1].nbytes)

    return _ns_per(codec if consts else serve, 50_000)


def _by_name(spans: list, name: str, thread: str | None = None) -> list:
    return [s for s in spans if s["name"] == name
            and (thread is None or s["thread"] == thread)]


def shares(rec, kind: str) -> dict:
    """The spans' shares of ``rec``'s wall, in %, and rates a second."""
    wall = rec.wall_s
    tot = tracing.totals(rec.spans)

    def pct(*names, key="total_s"):
        return 100 * sum(tot.get(n, {}).get(key, 0.0) for n in names) / wall

    def on(names, thread):
        return 100 * sum(s["end_ns"] - s["start_ns"] for n in names
                         for s in _by_name(rec.spans, n, thread)) / 1e9 / wall

    out = {"spans_per_s": len(rec.spans) / wall}
    if kind == "serving":
        groups = rec.counters.get("groups.serve", 0)
        out.update(group_parse_share=pct("serve.parse", key="self_s"),
                   collect_share=pct("serve.collect", "serve.assemble"),
                   launch_share=pct("serve.launch"),
                   call_share=pct("serve.call"),
                   calls=tot.get("serve.call", {}).get("count", 0),
                   regrows=rec.counters.get("regrow.serve", 0))
    else:
        groups = rec.counters.get("groups.codec", 0)
        up = sum(v for k, v in rec.counters.items()
                 if k.startswith("h2d_bytes.codec."))
        out.update(
            codec_host_share=on(("codec.parse", "codec.prep"), "DecodePump"),
            codec_device_share=on(("codec.device",), "DecodePump"),
            pump_push_share=on(("pump.push",), "DecodePump"),
            render_pull_share=pct("render.pull"),
            render_gain_share=pct("render.gain"),
            h2d_mb_per_group=up / groups / 1e6 if groups else None)
    out["groups_per_s"] = groups / wall
    return out


def rate(window: dict) -> float:
    """``decode_x`` / ``play_x`` of a window, as the benchmark reads it."""
    return sum(r["audio_s"] for r in window["records"]) / window["wall_s"]


def run_cell(name: str, seed: int, windows: int, seconds: float,
             costs: dict, emit) -> None:
    from ohp_bench import run as bench

    cell = bench.load_json(bench.ROOT / "workloads" / f"{name}.json")
    cfg = bench.load_json(bench.ROOT / "configs" / f"{cell['config']}.json")
    content = bench.load_module(
        bench.ROOT / "content" / f"{cfg['content']}.py").make(cfg, cell, seed)
    entry = bench.load_module(bench.ROOT / "entries" / f"{cell['entry']}.py")
    session = entry.Session(cfg, cell, seed, "cuda", content)
    group_ns = counter_cost(_first_group(cfg, cell, content, "cuda"))
    emit({"cell": name, "counters_ns_per_group": group_ns})
    xs = {False: [], True: []}
    rows = []
    try:
        for k in range(2 * windows):
            recorded = k % 4 in (1, 2)
            if recorded:
                with tracing.recording() as rec:
                    window = session.window(seconds)
                    torch.cuda.synchronize()
            else:
                window = session.window(seconds)
            line = {"cell": name, "on": recorded, "x": rate(window),
                    "requests": len(window["records"]),
                    "wall_s": window["wall_s"]}
            if recorded:
                line.update(shares(rec, session.kind))
                rows.append(line)
            xs[recorded].append(line["x"])
            emit(line)
    finally:
        session.close()
    spans_s = statistics.median(r["spans_per_s"] for r in rows)
    groups_s = statistics.median(r["groups_per_s"] for r in rows)
    off, on = statistics.median(xs[False]), statistics.median(xs[True])
    emit({"cell": name, "off_median": off, "on_median": on,
          "on_over_off": on / off, "off": xs[False], "on": xs[True],
          "spans_per_s": spans_s, "groups_per_s": groups_s,
          "on_cost_pct_bottom_up": spans_s * costs["on"] / 1e7,
          "off_cost_pct_bottom_up": spans_s * costs["off_attr"] / 1e7,
          "counters_pct_bottom_up": groups_s * group_ns / 1e7})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m ohpipeline_tpu_torch.tools.trace_cost")
    ap.add_argument("--cells", nargs="+", default=list(CELLS))
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--seed", type=int, default=2718281828)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("trace_cost needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]

    def emit(line: dict) -> None:
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")

    costs = span_costs()
    emit({"card": card, "site_cost_ns": costs, "windows": args.windows,
          "seconds": args.seconds, "seed": args.seed})
    for name in args.cells:
        run_cell(name, args.seed, args.windows, args.seconds, costs, emit)


if __name__ == "__main__":
    main()
