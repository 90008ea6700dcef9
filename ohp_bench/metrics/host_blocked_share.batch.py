"""Percent of the traced window the serving thread spent blocked in CUDA
runtime calls that wait for the card (``trace.BLOCKING``: copies, stream,
device and event synchronisation): uploads, copies back and syncs."""


def read(window: dict):
    t = window.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * t["host_blocked_s"] / t["window_s"]
