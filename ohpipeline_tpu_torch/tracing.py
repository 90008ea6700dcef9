"""Spans and counters at the port's layer boundaries.

A span marks one stretch of work at a layer boundary (the serving loop's
parse, launch and collect; a codec plug-in's parse, host prep and device
pass; the render path's pull and gain pass)::

    with tracing.span("serve.parse", block=i):
        item = next(gen)

Spans are recorded only inside :func:`recording`, for every thread of the
process at once; the spans and the counters' increments of the recording
are handed out when it ends, with its own wall time::

    with tracing.recording() as rec:
        decode_flac_streams_device(streams, device="cuda")
    rec.spans, rec.counters, rec.wall_s

Outside a recording a span is one shared object that does nothing, after
a check of a module global and of its name.  A span named in :data:`TWINS`
(host work that enqueues nothing on the device) also opens a
``record_function`` of its name wherever torch.profiler traces the calling
thread, recorded or not, so the profiler's own timeline names the host work
of the port (its idle gaps then fall inside a span).  No other span has a
twin: a ``record_function`` around work that enqueues on the device puts a
user annotation on the device's timeline too, which a trace would count as
device work.  The profiler sees only the threads that started after it: a
span of an older thread (the pipeline's ``DecodePump``) is placed on the
profiler's clock by :func:`chrome_trace`, through the spans that have a
profiler twin.

A recorded span keeps its name, its attributes, its start and end on
``time.perf_counter_ns()``, its thread's name, its parent (the innermost
open recorded span of its thread) and a request id: ``request=NEW`` starts
one (each serving call), a span with a parent takes its parent's, and a
span without one takes the id its thread was given by :func:`bind` (the
pipeline binds each stream's id on the threads that decode and render it).

Counters are always on, as ``_kernels.launches`` is: :func:`count` adds to
one, :func:`snapshot` reads them all with the kernel launches under
``launches.<kernel>``.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import statistics
import threading
import time

from torch.autograd import _profiler_enabled
from torch.autograd.profiler import record_function

from . import _kernels

#: ``span(..., request=NEW)`` starts a new request id ("call.<n>").
NEW = object()
#: The spans that open a profiler twin: host work with no device work
#: inside (a group's parse, the assembly, the animator's pull, the HE-AAC
#: SBR cond build).
TWINS = frozenset({"serve.parse", "serve.assemble", "render.pull",
                   "sbr.cond"})

_recording: "Recording | None" = None
_local = threading.local()
_lock = threading.Lock()
_counters: dict = {}
_span_ids = itertools.count(1)
_call_ids = itertools.count(1)


class _Off:
    """The span outside a recording, where it opens no profiler twin."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class Recording:
    """What :func:`recording` hands out when it ends: ``spans`` (dicts, by
    start), ``counters`` (the increments over the recording, zeros left
    out) and ``wall_s``."""

    def __init__(self):
        self.spans: list = []
        self.counters: dict = {}
        self.wall_s = 0.0
        self._closed: list = []


class _Span:
    __slots__ = ("_rec", "name", "attrs", "request", "id", "parent",
                 "thread", "start_ns", "end_ns", "_twin")

    def __init__(self, rec: Recording, name: str, request, attrs: dict):
        self._rec, self.name, self.request, self.attrs = (rec, name, request,
                                                          attrs)

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        self.parent = parent.id if parent is not None else None
        if self.request is NEW:
            self.request = f"call.{next(_call_ids)}"
        elif self.request is None:
            self.request = (parent.request if parent is not None
                            else getattr(_local, "request", None))
        self.id = next(_span_ids)
        self.thread = threading.current_thread().name
        self._twin = record_function(self.name) \
            if self.name in TWINS and _profiler_enabled() else None
        if self._twin is not None:
            self._twin.__enter__()
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.perf_counter_ns()
        _stack().pop()
        if self._twin is not None:
            self._twin.__exit__(*exc)
        self._rec._closed.append(self)
        return False

    def as_dict(self) -> dict:
        return {"name": self.name, "attrs": self.attrs,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "thread": self.thread, "id": self.id, "parent": self.parent,
                "request": self.request, "twin": self._twin is not None}


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, request=None, **attrs):
    """A context manager marking one stretch of work named ``name``;
    ``request=NEW`` gives it (and its children) a new request id."""
    rec = _recording
    if rec is None:
        if name not in TWINS or not _profiler_enabled():
            return _OFF
        return record_function(name)
    return _Span(rec, name, request, attrs)


def bind(request) -> None:
    """Give the spans the calling thread opens without a parent the request
    id ``request`` (a stream's, on the threads that decode and render it)."""
    _local.request = request


@contextlib.contextmanager
def recording():
    """Record every thread's spans while the block runs; the yielded
    :class:`Recording` is filled when it ends.  Recordings do not nest."""
    global _recording
    rec = Recording()
    with _lock:
        if _recording is not None:
            raise RuntimeError("tracing.recording() is already open")
        _recording = rec
    before = snapshot()
    t0 = time.perf_counter_ns()
    try:
        yield rec
    finally:
        _recording = None
        rec.wall_s = (time.perf_counter_ns() - t0) / 1e9
        after = snapshot()
        rec.counters = {k: v - before.get(k, 0) for k, v in after.items()
                        if v != before.get(k, 0)}
        rec.spans = sorted((s.as_dict() for s in list(rec._closed)),
                           key=lambda s: s["start_ns"])
        rec._closed = []


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def nbytes(*tensors) -> int:
    """The bytes of ``tensors`` (torch tensors or numpy arrays)."""
    return sum(t.nbytes for t in tensors)


def snapshot() -> dict:
    """Every counter, and each kernel's launches as ``launches.<kernel>``."""
    with _lock:
        out = dict(_counters)
    out.update((f"launches.{k}", v) for k, v in _kernels.launches.items())
    return out


def totals(spans: list) -> dict:
    """{name: {"count", "total_s", "self_s"}} over ``spans`` (dicts of a
    recording); a span's self time is its duration less its children's."""
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


def chrome_trace(prof, path: str, spans: list) -> float:
    """Write ``prof``'s trace (a finished ``torch.profiler.profile``) to
    ``path`` in the Chrome trace format, with every span of ``spans`` (a
    recording's, every thread's) added as one track a thread.

    The spans are shifted onto the profiler's clock by the spans that have
    a profiler twin, paired with their twins by name in order (a name with
    as many twins as spans): the shift is the median, over the pairs, of
    the offset between a span's midpoint and its twin's.  Returns the shift
    in microseconds; raises ``ValueError`` when there are spans and none
    has a twin."""
    tmp = f"{path}.profiler"
    prof.export_chrome_trace(tmp)
    try:
        with open(tmp) as f:
            doc = json.load(f)
    finally:
        os.remove(tmp)
    events = doc["traceEvents"]
    marks: dict = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            marks.setdefault(e["name"], []).append(e)
    twins: dict = {}
    for s in spans:
        if s["twin"]:
            twins.setdefault(s["name"], []).append(s)
    pairs = []
    for name, ss in twins.items():
        es = sorted(marks.get(name, []), key=lambda e: e["ts"])
        if len(es) == len(ss):
            pairs += zip(sorted(ss, key=lambda s: s["start_ns"]), es)
    if spans and not pairs:
        raise ValueError("no span has a profiler twin to align the spans by")
    shift = _shift(pairs) if pairs else 0.0
    pid = os.getpid()
    tids: dict = {}
    for s in spans:
        if s["thread"] not in tids:
            tids[s["thread"]] = tid = 1_000_000 + len(tids)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid,
                           "args": {"name": f"spans: {s['thread']}"}})
        events.append({"ph": "X", "cat": "span", "name": s["name"],
                       "pid": pid, "tid": tids[s["thread"]],
                       "ts": s["start_ns"] / 1e3 + shift,
                       "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                       "args": {**s["attrs"], "request": s["request"],
                                "id": s["id"], "parent": s["parent"]}})
    with open(path, "w") as f:
        json.dump(doc, f)
    return shift


def _shift(pairs: list) -> float:
    """The offset, in microseconds, from ``perf_counter_ns`` to the
    profiler's clock that (span, twin) ``pairs`` give (see
    :func:`chrome_trace`)."""
    return statistics.median(
        e["ts"] + e["dur"] / 2 - (s["start_ns"] + s["end_ns"]) / 2e3
        for s, e in pairs)
