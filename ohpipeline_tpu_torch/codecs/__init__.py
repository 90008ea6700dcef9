"""Codec device paths on tensors, and the pipeline's codec registry.

Unlike ``ohpipeline_tpu.codecs`` this package imports no codec here, so
importing one codec does not import the others; :func:`default_registry`
imports the plug-ins it registers.
"""

from __future__ import annotations

import functools


def default_registry(device="cuda"):
    """The codec registry of a pipeline on ``device``: the JAX package's 13
    plug-ins in its order (its ``codecs/__init__.py``): WAV, AIFF, AIFC, DSF,
    DFF, FLAC, ALAC, AAC in MP4, Opus in MP4, AAC in ADTS, Opus, Vorbis and
    MP3.  ``CodecFlac``, ``CodecAacMp4``, ``CodecAacAdts`` and ``CodecMp3``
    decode on ``device``; the others run on the host, as in the JAX
    package.  A CUDA device with no card raises ``KernelError``."""
    from .. import _kernels
    from ..host.codecs.aiff import CodecAifc, CodecAiff
    from ..host.codecs.alac import CodecAlac
    from ..host.codecs.base import CodecRegistry
    from ..host.codecs.dsd import CodecDsdDff, CodecDsdDsf
    from ..host.codecs.opus import CodecOpus, CodecOpusMp4
    from ..host.codecs.vorbis import CodecVorbis
    from ..host.codecs.wav import CodecWav
    from .aac import CodecAacAdts, CodecAacMp4
    from .flac import CodecFlac
    from .mp3 import CodecMp3

    dev = _kernels.checked_device(device)
    reg = CodecRegistry()
    for factory in (CodecWav, CodecAiff, CodecAifc, CodecDsdDsf, CodecDsdDff,
                    functools.partial(CodecFlac, device=dev), CodecAlac,
                    functools.partial(CodecAacMp4, device=dev), CodecOpusMp4,
                    functools.partial(CodecAacAdts, device=dev), CodecOpus,
                    CodecVorbis, functools.partial(CodecMp3, device=dev)):
        reg.add(factory)
    return reg
