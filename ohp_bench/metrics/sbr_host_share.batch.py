"""Percent of the traced calls' recorded wall spent in the HE-AAC serving
call's host SBR chain: the summed self time of the port's ``sbr.parse``
(each group's SBR payload parse and dequantisation, inside
``serve.parse``) and ``sbr.cond`` (the SBR cond planes built on the host,
at each launch) spans."""

from ..spans import share


def read(window: dict):
    return share(window, ("sbr.parse", "sbr.cond"), key="self_s")
