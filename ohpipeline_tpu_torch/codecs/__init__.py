"""Codec device paths on tensors.

Unlike ``ohpipeline_tpu.codecs`` this package imports no codec here, so
importing one codec does not import the others.
"""
