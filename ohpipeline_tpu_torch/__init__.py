"""ohpipeline_tpu_torch -- the ohpipeline_tpu audio decode path in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A second package beside the JAX one, which stays the reference.  It holds
the FLAC, AAC-LC and HE-AAC v1 serving paths and the flagship
decode->render step:

_host      the jax-free host helpers it shares with ohpipeline_tpu (native
           parsers, FLAC metadata parser and encoder, AAC tables and ADTS
           bitstream reader, the SBR decoder and cond builder)
_kernels   nvcc build, ctypes binding and launch counters of csrc/*.cu
ops        LPC synthesis (kernel + plain version) and PCM DSP
codecs     FLAC rice decode (kernel + plain version), group synthesis and
           the multi-stream serving API; AAC-LC synthesis (TNS kernel +
           plain version, IMDCT, host spectral prep), group hooks and the
           multi-stream serving API; HE-AAC v1 SBR group decode (envelope
           scan kernel + plain version) and its serving API
parallel   the single-device decode->render step
entry      entry(device) -> (fn, args) for that step

Every public entry point takes an explicit ``device``.  Tensors on the CPU
run the kernels' plain PyTorch versions; tensors on the card run the
kernels, with no fallback.
"""
