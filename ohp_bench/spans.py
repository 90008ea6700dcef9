"""Reading the port's spans: the traced requests recorded with
``ohpipeline_tpu_torch.tracing.recording()``, reduced to what the per-layer
metrics read.

The self-time arithmetic is ``ohpipeline_tpu_torch/tracing.py``'s
``totals`` at commit bb64d92, as ``ohpipeline_tpu_torch/tools/
trace_cost.py``'s ``shares`` reads it there (a span's self time is its
duration less its children's, a child being a span whose ``parent`` is its
id), copied so that the yardstick does not move with the port.  The copy
freezes the reduction alone: the recorder, the span names and where the
port opens its spans stay the port's, and a change to those is a change of
the program that these metrics are meant to show; a change to what the
port's ``totals`` sums is not."""

from __future__ import annotations


def recorded(run):
    """``run()`` with every thread's spans recorded; the recording
    (``spans``, ``counters``, ``wall_s``), for :func:`summary` to reduce
    once the profiled stretch has ended."""
    from ohpipeline_tpu_torch import tracing

    with tracing.recording() as rec:
        run()
    return rec


def _totals(spans: list) -> dict:
    """{name: {"count", "total_s", "self_s"}} over ``spans``."""
    child_ns: dict = {}
    for s in spans:
        if s["parent"] is not None:
            child_ns[s["parent"]] = child_ns.get(s["parent"], 0) \
                + s["end_ns"] - s["start_ns"]
    out: dict = {}
    for s in spans:
        t = out.setdefault(s["name"], {"count": 0, "total_s": 0.0,
                                       "self_s": 0.0})
        dur = s["end_ns"] - s["start_ns"]
        t["count"] += 1
        t["total_s"] += dur / 1e9
        t["self_s"] += (dur - child_ns.get(s["id"], 0)) / 1e9
    return out


def summary(spans: list, counters: dict, wall_s: float) -> dict:
    """What ``window["spans"]`` holds: ``wall_s`` (the recording's wall),
    ``counters`` (their increments over the recording), ``totals`` (each
    span name's count, summed total and self time, over every thread) and
    ``threads`` (the same, by the name of the thread the spans ran on).
    ``spans`` are a recording's (dicts with ``name``, ``start_ns``,
    ``end_ns``, ``thread``, ``id`` and ``parent``)."""
    by_thread: dict = {}
    for s in spans:
        by_thread.setdefault(s["thread"], []).append(s)
    return {"wall_s": wall_s, "counters": dict(counters),
            "totals": _totals(spans),
            "threads": {t: _totals(ss) for t, ss in by_thread.items()}}


def share(window: dict, names, key: str = "total_s",
          thread: str | None = None):
    """Percent of the recording's wall that the spans ``names`` took
    (summed ``key``: ``total_s`` or ``self_s``), over every thread or on
    ``thread`` alone; None without a recording or where none of them
    ran."""
    s = window.get("spans")
    if not s or s["wall_s"] <= 0:
        return None
    tot = s["totals"] if thread is None else s["threads"].get(thread, {})
    if not any(n in tot for n in names):
        return None
    return 100.0 * sum(tot[n][key] for n in names if n in tot) / s["wall_s"]
