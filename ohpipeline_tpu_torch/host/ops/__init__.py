"""Host PCM byte packing of the port's host code (``pcm.py``)."""
