"""Vorbis host files: bit reader, codebooks, headers, floors, residues, the
packet decoder and host synthesis, and the stream builder."""
