"""Codec device paths on tensors, and the pipeline's codec registry.

Unlike ``ohpipeline_tpu.codecs`` this package imports no codec here, so
importing one codec does not import the others; :func:`default_registry`
imports the plug-ins it registers.
"""

from __future__ import annotations

import functools


def default_registry(device="cuda"):
    """The codec registry of a pipeline on ``device``, in the JAX package's
    order (its ``codecs/__init__.py``): the host plug-ins (WAV, AIFF, AIFC,
    DSF, DFF), then ``CodecFlac`` and ``CodecAacAdts``, both bound to
    ``device``.  The plug-ins the port does not have yet (ALAC, AAC and Opus
    in MP4, Opus, Vorbis, MP3) are absent, so their streams are not
    recognised.  A CUDA device with no card raises ``KernelError``."""
    from .. import _kernels
    from ..host.codecs.aiff import CodecAifc, CodecAiff
    from ..host.codecs.base import CodecRegistry
    from ..host.codecs.dsd import CodecDsdDff, CodecDsdDsf
    from ..host.codecs.wav import CodecWav
    from .aac import CodecAacAdts
    from .flac import CodecFlac

    dev = _kernels.checked_device(device)
    reg = CodecRegistry()
    for factory in (CodecWav, CodecAiff, CodecAifc, CodecDsdDsf, CodecDsdDff,
                    functools.partial(CodecFlac, device=dev),
                    functools.partial(CodecAacAdts, device=dev)):
        reg.add(factory)
    return reg
