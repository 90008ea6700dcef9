"""The render path of the port: the pipeline facade and its animators.

Port of ``ohpipeline_tpu.pipeline``.  :class:`PipelineManager` is the host
pipeline (``host/pipeline/manager.py``: protocols -> encoded reservoir ->
codec controller on a decode pump thread -> decoded reservoir -> render
chain) with the codec registry of its ``device``
(``codecs.default_registry``: the JAX package's 13 plug-ins; FLAC on the
LPC kernel, AAC in ADTS and MP4 on the SBR kernel (and the PS kernel for
HE-AAC v2), MP3 on the window kernel, the others on the host); an animator
(``animator.py``) pulls the render chain and runs the gain pass of
``RenderBatcher`` on its ``device``.

    mgr = PipelineManager(params, device="cuda")
    try:
        mgr.play_uri("file:///path/track.flac")
        AnimatorBatch(mgr.pipeline.predriver, sink, device="cuda").run()
    finally:
        mgr.quit()
"""

from __future__ import annotations

from typing import Optional

from .. import _kernels
from ..codecs import default_registry
from ..host.pipeline import manager as _manager
from ..host.pipeline.manager import (DecodeFaultEvent, Pipeline,
                                     PipelineInitParams, PipelineState,
                                     SupportElements)
from .animator import (AnimatorBasic, AnimatorBatch, AnimatorSongcastSender,
                       RenderBatcher, Silencer)


class PipelineManager(_manager.PipelineManager):
    """The public facade (reference PipelineManager.h:65-303), decoding on
    ``device``: its codec registry is ``codecs.default_registry(device)``.
    A CUDA device with no card raises ``KernelError``; nothing runs on the
    CPU unless ``device`` says so."""

    def __init__(self, params: Optional[PipelineInitParams] = None, *,
                 device="cuda", protocol_manager_factory=None):
        self.device = _kernels.checked_device(device)
        super().__init__(params, default_registry(self.device),
                         protocol_manager_factory)


__all__ = ["AnimatorBasic", "AnimatorBatch", "AnimatorSongcastSender",
           "DecodeFaultEvent",
           "Pipeline", "PipelineInitParams", "PipelineManager",
           "PipelineState", "RenderBatcher", "Silencer", "SupportElements"]
