"""Opus: the CELT-only serving path (``celt``)."""
