"""Percent of the traced plays' recorded wall that the pipeline's decode
thread (``DecodePump``) spent in the codec plug-in's host work: the summed
time of its ``codec.parse`` (the native group parse) and ``codec.prep``
(spectral prep and TNS, or FLAC's row slicing) spans."""

from ..spans import share


def read(window: dict):
    return share(window, ("codec.parse", "codec.prep"), thread="DecodePump")
