"""Multiroom distribution through the pipeline over a device mesh.

Port of ``IciBranch`` of ``ohpipeline_tpu.pipeline.branch``; the tee it
hangs off, :class:`Brancher`, is the host copy's
(``host/pipeline/branch.py``), re-exported here.
"""

from __future__ import annotations

import numpy as np

from .. import parallel
from ..host.core import events as ev
from ..host.pipeline.branch import Brancher
from ..host.pipeline.elements import Pushable


class IciBranch(Pushable):
    """The Songcast sender's semantics (``SongcastBranch``; reference
    Av/Songcast/OhmSender) carried by the mesh fan-out instead of UDP
    multicast: attach it to a :class:`Brancher` like ``SongcastBranch``, and
    the master mix reaches every device ("room") of ``mesh`` through
    ``parallel.room_fanout``.

    Branch PCM accumulates into tiles of TILE samples: a new stream's format
    (``decoded_stream``) drops any partial tile of the previous track, whose
    channel count may differ, and a halt zero-pads the partial tile and
    sends it.  :meth:`rooms` gives every device's copy of the last tile,
    :attr:`peak` its peak meter, :attr:`tiles_sent` the tiles sent."""

    TILE = 1024

    def __init__(self, mesh: parallel.Mesh):
        self._mesh = mesh
        self._pending = None
        self._last = None
        self._peak = 0.0
        self.tiles_sent = 0

    def push(self, e: ev.Event) -> None:
        if e.kind == "decoded_stream":
            self._pending = None
        elif isinstance(e, ev.AudioPcmEvent):
            samples = np.asarray(e.samples, np.float32)
            if self._pending is not None:
                samples = np.concatenate([self._pending, samples], axis=1)
            pos = 0
            while samples.shape[1] - pos >= self.TILE:
                self._send(samples[:, pos:pos + self.TILE])
                pos += self.TILE
            self._pending = samples[:, pos:] if pos < samples.shape[1] \
                else None
        elif e.kind == "halt" and self._pending is not None:
            tile = np.zeros((self._pending.shape[0], self.TILE),
                            np.float32)
            tile[:, :self._pending.shape[1]] = self._pending
            self._pending = None
            self._send(tile)

    def _send(self, tile: np.ndarray) -> None:
        full, peak = parallel.room_fanout(self._mesh, tile)
        self._last = full
        self._peak = float(peak)
        self.tiles_sent += 1

    def rooms(self) -> list:
        """Every mesh device's copy of the last tile sent, as numpy (each
        room must hold the identical full master mix)."""
        if self._last is None:
            return []
        return [t.cpu().numpy() for _, _, t in self._last.shards]

    @property
    def peak(self) -> float:
        return self._peak


__all__ = ["Brancher", "IciBranch"]
