"""ohpipeline_tpu_torch -- the ohpipeline_tpu audio decode path in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A second package beside the JAX one, which stays the reference; it imports
nothing of it.  It holds the FLAC, AAC-LC, HE-AAC v1 and v2, CELT (Opus),
MP3 and Vorbis serving paths, the flagship decode->render step, the
render path (a pipeline that plays a URI through the codec plug-ins into
an animator), the multi-device layer (a mesh of devices, the serving
calls over it, the multiroom fan-out) and the Av layer (the media player
with its sources and volume chain):

host       its own copies of the JAX package's host code: the C++ parsers
           (built into _build/ at first use), the FLAC metadata parser and
           encoder, AAC tables and ADTS bitstream reader, the SBR decoder
           and cond builder, the CELT entropy layer and Ogg Opus framing,
           the MP3 bitstream, encoder and numpy host prep, the Vorbis
           packet decoder, host synthesis and stream builder; the
           pipeline's events, protocols, containers, host plug-ins (WAV,
           AIFF, raw PCM, DSD), element chain, codec controller and
           assembly; the playlist parsers and the Av layer's product,
           sources, volume chain, config, power, credentials, pins and
           services
_host      the names the port's modules use for those
_kernels   nvcc build, ctypes binding and launch counters of csrc/*.cu
ops        LPC synthesis (kernel + plain version) and PCM DSP
codecs     FLAC rice decode (kernel + plain version), group synthesis and
           the multi-stream serving API; AAC-LC synthesis (TNS kernel +
           plain version, IMDCT, host spectral prep), group hooks and the
           multi-stream serving API; HE-AAC v1 SBR group decode (envelope
           scan kernel + plain version) and its serving API; CELT group
           synthesis (comb post-filter kernel + plain version) and its
           serving API; the MP3 hybrid filterbank (polyphase window kernel
           + plain version), group decode and serving API; the Vorbis
           batched synthesis and its serving API; ``CodecFlac`` and
           ``CodecAacAdts``, the plug-ins of ``default_registry(device)``
pipeline   the render path: ``PipelineManager(device=...)`` and the
           animators, whose ``RenderBatcher`` runs the gain pass on the
           device; ``branch.IciBranch``, the multiroom fan-out of a
           ``Brancher`` over a mesh
av         ``MediaPlayer(device=...)``, the composition root: its Playlist
           and Radio sources play through the pipeline on the device, and
           its volume chain sets the gain the animator applies there
parallel   the decode->render step, the mesh (``make_mesh``, ``Sharded``,
           ``serving_put``, the serving calls' ``mesh=``), the room
           fan-out and per-room render grid, and the sharded pipeline step
entry      entry(device) -> (fn, args) for that step; dryrun_multichip,
           real decodes over a mesh against one device
tracing    spans at the layer boundaries (the serving loop, the codec
           plug-ins, the pump thread and the animators), recorded for
           every thread inside ``recording()`` and named in a profiler's
           timeline; counters of groups and of bytes up and back
tools      measurement scripts run on the card

Every public entry point runs on the card (``device="cuda"``) unless the
caller asks for the CPU.  Tensors on the CPU run the kernels' plain PyTorch
versions; tensors on the card run the kernels, with no fallback.
"""
