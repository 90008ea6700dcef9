"""The serving entry: one client calling a batched serving call of the port
back to back (a closed loop), every call over the same streams.

The configuration names the call (``serving_call``, "module:function" of
the port) and the cell its batch (``streams``, ``stream_seconds``,
``frames_per_group``).  A request is one call: every stream's PCM on the
host."""

from __future__ import annotations

import importlib
import time

import numpy as np


class Session:
    """Content made, the call bound and warmed up: what set-up leaves for
    the window."""

    kind = "serving"

    def __init__(self, cfg: dict, cell: dict, seed: int, device: str,
                 content: dict):
        module, name = cfg["serving_call"].split(":")
        fn = getattr(importlib.import_module(module), name)
        self.rate = cfg["sample_rate"]
        streams, group = content["streams"], int(cell["frames_per_group"])
        self._call = lambda: fn(streams, group, device=device)
        # calls kept for the check: every check_every-th from a seeded
        # offset on, and the last
        self._every = int(cell["check_every"])
        self._offset = int(np.random.default_rng(seed).integers(self._every))
        self.kept: dict = {}
        self.request()                          # warm: the cell's shapes

    def request(self) -> list:
        """One call: every stream's PCM, on the host."""
        return self._call()

    def window(self, seconds: float) -> dict:
        """Calls back to back until ``seconds`` have passed; the window
        ends with the call in flight then."""
        records, last = [], None
        t_start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            out = self.request()
            t1 = time.perf_counter()
            k = len(records)
            records.append({"t0": t0 - t_start, "t1": t1 - t_start,
                            "audio_s": sum(o.shape[1] for o in out)
                            / self.rate})
            if k % self._every == self._offset:
                self.kept[k] = out
            last = (k, out)
            if t1 - t_start >= seconds:
                break
        self.kept[last[0]] = last[1]
        return {"records": records, "wall_s": records[-1]["t1"]}

    def traced_requests(self, n: int) -> None:
        for _ in range(n):
            self.request()

    def outputs(self) -> list:
        """(stream index, PCM) of every stream of every kept call."""
        return [(i, pcm) for out in self.kept.values()
                for i, pcm in enumerate(out)]

    def close(self) -> None:
        pass
