"""The port's own copies of the host code it runs: the C++ parsers and the
numpy and pure-Python codec files of the JAX package, in the JAX package's
layout, so each copy sits where a reader looks for its counterpart.

``native/`` holds the ``.cc`` sources (byte copies) and the loader that
builds them into ``ohpipeline_tpu_torch/_build/``; ``codecs/`` and
``containers/`` hold the FLAC, AAC, SBR and PS, CELT, SILK, MP3, Vorbis
and ALAC host files and their ``.npz`` tables (byte copies), the host
plug-ins (WAV, AIFF, raw PCM, DSD, ALAC, Opus in Ogg and MP4, Vorbis) and
the containers the codec controller sniffs;
``core/`` the pipeline's timebase, stream description, events and ramps;
``protocols/`` the URI protocols and playlist parsers; ``av/`` the Av
layer's host modules (product, sources, volume, config, power, services,
the receiver sources); ``pipeline/`` the element chain,
reservoirs, codec controller and assembly; ``ops/pcm.py`` the numpy byte
packers.  ``codecs/aac/sbr_host.py``, ``codecs/mp3/bitstream.py``,
``codecs/vorbis/synthesis.py``, ``codecs/opus/silk.py``,
``codecs/alac.py``, ``protocols/http.py`` and
``pipeline/{branch,codec_controller,manager}.py`` are changed copies,
``codecs/mp3/prep.py`` and ``ops/pcm.py`` copies in part; each says at its
top what differs.  Nothing here imports JAX or the
JAX package: relative imports resolve inside the port.
"""
