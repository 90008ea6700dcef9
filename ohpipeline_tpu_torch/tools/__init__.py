"""Measurement scripts of the port, run on the card from the repository
root (``python -m ohpipeline_tpu_torch.tools.<name>``)."""
