"""The pipeline of the port's host code: element chain, reservoirs, codec
controller and assembly (``manager.py``), copies of the JAX package's
``pipeline/`` files.  The animators, where rendered audio meets the device,
are ``ohpipeline_tpu_torch.pipeline``.
"""
