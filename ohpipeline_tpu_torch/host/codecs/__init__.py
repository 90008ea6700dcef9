"""Host codec files of the port (copies; see ``ohpipeline_tpu_torch.host``)."""
