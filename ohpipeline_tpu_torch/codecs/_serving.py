"""The serving calls' placement, loop over blocks of streams and assembly,
shared by the FLAC, AAC and MP3 ``decode_*_streams_device`` calls, with
the serving loop's spans (``serve.parse``, ``serve.launch``,
``serve.collect``, ``serve.assemble``).

It imports no codec and no mesh code: a mesh is read only through its
``rows()`` and ``shape["dp"]`` (``parallel.Mesh``), so the codecs stay
below the multi-device layer.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _kernels
from ..tracing import span


def blocks(n: int, parts: int) -> list:
    """``n`` split into ``parts`` contiguous slices, the first ``n % parts``
    one longer (``np.array_split``'s layout)."""
    edges = np.cumsum([0] + [n // parts + (i < n % parts)
                             for i in range(parts)])
    return [slice(int(a), int(b)) for a, b in zip(edges[:-1], edges[1:])]


def stream_blocks(n_streams: int, mesh=None, device="cuda") -> list:
    """The shards of a serving call over ``n_streams`` streams:
    ``[(device, slice of the streams)]``.  ``mesh=None`` is one shard of
    every stream on ``device``; a mesh gives each dp row a contiguous block
    on its first device, and drops a row left with no stream.  The mesh
    places the work, so with a mesh ``device`` must stay at its default
    ("cuda"); naming another raises ``ValueError``."""
    if mesh is None:
        return [(_kernels.checked_device(device), slice(0, n_streams))]
    if torch.device(device) != torch.device("cuda"):
        raise ValueError(f"device={device!r} and mesh= both given: the mesh "
                         f"places the work, leave device at its default")
    return [(d, sl) for d, sl in zip(mesh.rows(),
                                     blocks(n_streams, mesh.shape["dp"]))
            if sl.stop > sl.start]


_END = object()


def serve_blocks(gens: list, launch, collect) -> None:
    """The serving calls' loop over their stream blocks.  Round after round,
    every generator ``gens[i]`` that still yields gives its block's next
    group (all of them parsed first), ``launch(i, item)`` queues it on the
    block's device and returns what ``collect`` takes, and the previous
    round's groups are collected (copied back) only then: each device keeps
    one group in flight while the host parses the next.  Closes ``gens``."""
    live, pending = list(range(len(gens))), []

    def parsed(i):
        with span("serve.parse", block=i):
            return next(gens[i], _END)

    def launched(i, item):
        with span("serve.launch"):
            return launch(i, item)

    def collect_all(pending):
        for p in pending:
            with span("serve.collect"):
                collect(*p)

    try:
        while items := [(i, item) for i in live
                        if (item := parsed(i)) is not _END]:
            live = [i for i, _ in items]
            now = [launched(i, item) for i, item in items]
            collect_all(pending)
            pending = now
        collect_all(pending)
    finally:
        for g in gens:
            g.close()


def assemble(outs: list, nch: int) -> list:
    """Each stream's collected pieces joined: [(nch, nsamples) int32]."""
    with span("serve.assemble"):
        return [np.concatenate(o, axis=1) if o
                else np.zeros((nch, 0), np.int32) for o in outs]
