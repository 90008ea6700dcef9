"""Reading a traced window: torch.profiler over a fixed number of requests,
reduced to what the per-layer metrics read.

The idle share is ``ohpipeline_tpu_torch/tools/__init__.trace_call``'s
arithmetic at commit 15c54f8 (1 - the union of the device's busy intervals
over the window), copied so that the yardstick does not move with the
port."""

from __future__ import annotations

#: CUDA runtime calls that block the calling host thread until the device
#: (or a pageable copy) is done.
BLOCKING = ("cudaMemcpy", "cudaMemcpyAsync", "cudaMemcpy2D",
            "cudaMemcpy2DAsync", "cudaStreamSynchronize",
            "cudaDeviceSynchronize", "cudaEventSynchronize")
#: Entries kept in each list of the result line's ``breakdown``.
TOP = 10
_SPAN = "ohp_bench.traced_window"


def _union(intervals: list) -> list:
    """Sorted, merged (start, end) intervals."""
    merged: list = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def traced(run) -> dict:
    """``run()`` under torch.profiler (CPU and CUDA activity), ended by a
    synchronise.  Returns {"window_s", "busy_s", "kernel_s" (device seconds
    by kernel name), "host_blocked_s", "device_ops", "idle_gaps"}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(_SPAN):
            run()
            torch.cuda.synchronize()
    device, host, span = [], [], None
    for e in prof.events():
        if e.name == _SPAN:
            # the profiler also gives the span a device-side twin, which
            # covers the device's work and is no work of its own
            if getattr(e, "device_type", None) != DeviceType.CUDA:
                span = e
        elif getattr(e, "device_type", None) == DeviceType.CUDA:
            device.append(e)
        else:
            host.append(e)
    w0, w1 = span.time_range.start, span.time_range.end
    kernel_s: dict = {}
    for e in device:
        kernel_s[e.name] = kernel_s.get(e.name, 0.0) \
            + (e.time_range.end - e.time_range.start) / 1e6
    busy = _union([(max(e.time_range.start, w0), min(e.time_range.end, w1))
                   for e in device if e.time_range.end > w0
                   and e.time_range.start < w1])
    busy_s = sum(b - a for a, b in busy) / 1e6
    blocked = _union([(e.time_range.start, e.time_range.end) for e in host
                      if e.name in BLOCKING])
    gaps, prev = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_s,
            "kernel_s": kernel_s,
            "host_blocked_s": sum(b - a for a, b in blocked) / 1e6,
            "device_ops": sorted(([n[:120], s] for n, s in kernel_s.items()),
                                 key=lambda x: -x[1])[:TOP],
            "idle_gaps": [[_host_label(host, a, b), (b - a) / 1e6]
                          for a, b in gaps[:TOP]]}


def _host_label(host: list, a: float, b: float) -> str:
    """The innermost host op open across the middle of a device gap."""
    mid = (a + b) / 2
    inner = None
    for e in host:
        if e.time_range.start <= mid <= e.time_range.end and (
                inner is None or e.time_range.end - e.time_range.start
                < inner.time_range.end - inner.time_range.start):
            inner = e
    return "host: " + (inner.name[:100] if inner is not None
                       else "no profiled op (Python or native host code)")


def idle_share(window: dict):
    """Percent of the traced window in which no operation ran on the
    device; None without a trace."""
    t = window.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline(window: dict, kernel: str):
    """A kernel's share of its roofline in percent: the least time the
    card could take for the traced requests' work (bytes over the memory
    bandwidth or operations over the peak, whichever is longer) over the
    device time of the kernels whose name holds ``kernel``.  None when the
    trace ran no such kernel or the content gives it no work."""
    from . import peaks

    t = window.get("trace")
    work = window.get("work", {}).get(kernel)
    if not t or not work:
        return None
    secs = sum(s for n, s in t["kernel_s"].items() if kernel in n)
    if secs <= 0:
        return None
    least = max(work["bytes"] / peaks.HBM_BYTES_PER_S,
                work["ops"] / peaks.VECTOR_OPS_PER_S)
    if least <= 0:
        return None
    return 100.0 * least / secs
