"""Measurement scripts of the port, run on the card from the repository
root (``python -m ohpipeline_tpu_torch.tools.<name>``)."""

from __future__ import annotations

import sys
import time


def smoke():
    """The repository root's ``chip_smoke`` module, whose seeded cases and
    content the scripts share."""
    sys.path.insert(0, ".")
    import chip_smoke

    return chip_smoke


def trace_call(run) -> tuple:
    """run() once under torch.profiler (CPU and CUDA activity), ended by a
    synchronise.  Returns (the profile, its device events, {wall seconds,
    the union of the device's busy intervals in ms, the number of device
    events, the idle share 1 - busy / wall})."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events()
              if getattr(e, "device_type", None) == DeviceType.CUDA]
    busy, end = 0.0, -1.0
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    return prof, events, {"wall_s": wall, "device_busy_ms": busy / 1e3,
                          "device_events": len(events),
                          "idle_share": 1.0 - busy / 1e6 / wall}
