"""Percent of the traced calls' recorded wall spent collecting and
assembling: the summed time of the port's ``serve.collect`` (a group's copy
back and per-stream slicing) and ``serve.assemble`` (each stream's pieces
joined) spans."""

from ..spans import share


def read(window: dict):
    return share(window, ("serve.collect", "serve.assemble"))
