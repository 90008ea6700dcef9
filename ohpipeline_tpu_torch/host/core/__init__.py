"""The pipeline timebase and stream description of the port's host code
(``jiffies.py`` and ``streaminfo.py``, byte copies of the JAX package's)."""
