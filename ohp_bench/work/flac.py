"""Work of the FLAC kernels, counted from the content (never from the
port's padded rows)."""

from __future__ import annotations


def per_request(content: dict, cell: dict) -> dict:
    """{kernel name: {"bytes", "ops"}} that one serving call's streams need.

    ``lpc_rows`` (``csrc/lpc.cu``): every sample of a subframe with a
    predictor (LPC, or fixed of order 1 or more) is read once as an int32
    residual and written once as an int32 sample; every prediction tap is
    a multiply and an add.  The frozen encoder reports both counts."""
    samples = sum(s["pred_samples"] for s in content["stats"])
    taps = sum(s["pred_taps"] for s in content["stats"])
    return {"lpc_rows": {"bytes": 8.0 * samples, "ops": 2.0 * taps}}
