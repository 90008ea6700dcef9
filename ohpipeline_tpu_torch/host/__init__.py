"""The port's own copies of the host code it runs: the C++ parsers and the
numpy and pure-Python codec files of the JAX package, in the JAX package's
layout, so each copy sits where a reader looks for its counterpart.

``native/`` holds the ``.cc`` sources (byte copies) and the loader that
builds them into ``ohpipeline_tpu_torch/_build/``; ``codecs/`` and
``containers/`` hold the FLAC, AAC, SBR and PS, CELT, MP3 and Vorbis host
files and their ``.npz`` tables (byte copies); ``core/`` the pipeline
timebase and stream description (byte copies).  ``codecs/base.py``,
``codecs/opus/packet.py`` and ``codecs/aac/sbr_host.py`` are copies in
part.  Nothing here imports JAX
or the JAX package: relative imports resolve inside the port.
"""
