"""The control of a cell's comparison: the reference put in the program's
place at the precision below the one its configuration states, compared as
a run compares the program's output.  It has to come out as not correct.

    python3 -m ohp_bench.control --workload <cell> --seeds <n> [<n> ...]

prints one JSON line a seed with each number compared, its limit, and
whether the control failed it.  It covers every stream of the cell's
content, the size a run checks.  On the card the AAC control's products run
in TF32 (``reference/aac.tf32_matmul``)."""

from __future__ import annotations

import argparse
import json
import sys

from . import run


def control(name: str, seed: int, cell_overrides: dict | None = None) -> dict:
    """The control's readings for cell ``name`` on the content of
    ``seed``."""
    cell = {**run.load_json(run.ROOT / "workloads" / f"{name}.json"),
            **(cell_overrides or {})}
    cfg = run.load_json(run.ROOT / "configs" / f"{cell['config']}.json")
    content = run.load_module(run.ROOT / "content"
                              / f"{cfg['content']}.py").make(cfg, cell, seed)
    reference = run.load_module(run.ROOT / "reference"
                                / f"{cfg['reference']}.py")
    kind = run.load_module(run.ROOT / "entries"
                           / f"{cell['entry']}.py").Session.kind
    every = [(i, None) for i in range(len(content["streams"]))]
    outputs = reference.lower_precision(content, every, kind, cell)
    checks = reference.compare(content, outputs, kind, cell)
    limits = cfg["limits"]
    return {"cell": name, "seed": seed,
            "checks": {k: {"value": checks[k], "limit": limits[k],
                           "failed": checks[k] > limits[k]} for k in limits}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m ohp_bench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(control(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
