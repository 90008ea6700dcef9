"""Percent of the traced calls' recorded wall spent in the per-group host
parse: the summed self time of the port's ``serve.parse`` spans (the native
unpack of each stream block's next group)."""

from ..spans import share


def read(window: dict):
    return share(window, ("serve.parse",), key="self_s")
