"""Vorbis: the batched synthesis serving path (``device``)."""
