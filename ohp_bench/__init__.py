"""The benchmark of ``ohpipeline_tpu_torch`` on one NVIDIA H100: see
``README.md`` and ``run.py``."""
