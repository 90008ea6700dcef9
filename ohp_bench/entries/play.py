"""The play entry: one renderer playing tracks to their end, back to back
(a closed loop), through the port's render path.

One ``pipeline.PipelineManager`` and one ``AnimatorBatch`` into the
benchmark's sink last for the whole run, as a renderer keeps them; each
play is a ``play_uri`` of a ``file://`` URI.  The tracks are the cell's
``streams`` content files, written under a temporary directory
(``TMPDIR``) at set-up, and played in an order drawn from the seed,
cycling.  Until the first PCM of a play reaches the sink the animator is
pulled one event at a time, so that PCM is rendered as soon as the
pipeline yields it; after it the animator batches as it does.  A request
is one play; its start time is from ``play_uri`` to that first PCM.

The pipeline runs with the parameters of the port's end-to-end tests (no
gorge; the starvation ramper pulled inline), so a play is the same event
for event each time."""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np


class _Puller:
    """The pipeline's render end, noting when it hands out a halt."""

    def __init__(self, pipeline):
        self.pipeline = pipeline
        self.halted = False

    def pull(self):
        e = self.pipeline.pull()
        if e.kind == "halt":
            self.halted = True
        return e


class _Sink:
    """Keeps a play's rendered chunks and the time the first came."""

    def __init__(self):
        self.first, self.chunks = None, []

    def reset(self) -> None:
        self.first, self.chunks = None, []

    def __call__(self, samples, info) -> None:
        if self.first is None:
            self.first = time.perf_counter()
        self.chunks.append(samples)


class Session:
    kind = "render"

    def __init__(self, cfg: dict, cell: dict, seed: int, device: str,
                 content: dict):
        from ohpipeline_tpu_torch import pipeline

        self.rate = cfg["sample_rate"]
        self._dir = tempfile.mkdtemp(prefix="ohp_bench_")
        self._uris = []
        for i, data in enumerate(content["streams"]):
            path = os.path.join(self._dir, f"{i}{content['suffix']}")
            with open(path, "wb") as f:
                f.write(data)
            self._uris.append("file://" + path)
        rng = np.random.default_rng(seed)
        self._order = rng.permutation(len(self._uris))
        self._every = int(cell["check_every"])
        self._offset = int(rng.integers(self._every))
        params = pipeline.PipelineInitParams()
        params.gorge_jiffies = 0
        params.threaded_starvation_ramper = False
        self._mgr = pipeline.PipelineManager(params, device=device)
        self._puller = _Puller(self._mgr.pipeline.predriver)
        self._sink = _Sink()
        self._anim = pipeline.AnimatorBatch(self._puller, self._sink,
                                            device=device)
        self.kept: dict = {}
        self._plays = 0
        for i in range(len(self._uris)):                 # warm: every track
            self._play(i)

    def _play(self, i: int) -> tuple:
        """Plays track ``i`` to its halt: (start seconds or None, the PCM
        the sink got)."""
        self._puller.halted = False
        self._sink.reset()
        t0 = time.perf_counter()
        self._mgr.play_uri(self._uris[i])
        while self._sink.first is None and not self._puller.halted:
            self._anim.run(max_events=1)
        if not self._puller.halted:
            self._anim.run()
        start = None if self._sink.first is None else self._sink.first - t0
        pcm = (np.concatenate(self._sink.chunks, axis=1)
               if self._sink.chunks else np.zeros((2, 0), np.int32))
        return start, pcm

    def request(self) -> tuple:
        """The next play in the seeded order: (track, start, PCM)."""
        i = int(self._order[self._plays % len(self._order)])
        self._plays += 1
        return (i, *self._play(i))

    def window(self, seconds: float) -> dict:
        """Plays back to back until ``seconds`` have passed; the window
        ends with the play in flight then."""
        records, last = [], None
        t_start = time.perf_counter()
        while True:
            k = len(records)
            t0 = time.perf_counter()
            i, start, pcm = self.request()
            t1 = time.perf_counter()
            records.append({"t0": t0 - t_start, "t1": t1 - t_start,
                            "start_s": start,
                            "audio_s": pcm.shape[1] / self.rate})
            if k % self._every == self._offset:
                self.kept[k] = (i, pcm)
            last = (k, (i, pcm))
            if t1 - t_start >= seconds:
                break
        self.kept[last[0]] = last[1]
        return {"records": records, "wall_s": records[-1]["t1"]}

    def traced_requests(self, n: int) -> None:
        for _ in range(n):
            self.request()

    def outputs(self) -> list:
        return list(self.kept.values())

    def close(self) -> None:
        try:
            self._mgr.quit()
        finally:
            shutil.rmtree(self._dir, ignore_errors=True)
