"""sbr_env_map's share of its roofline: the work of the traced calls'
content (``work/he_aac.py``) at the card's peaks over the kernel's device
time."""

from ..trace import roofline


def read(window: dict):
    return roofline(window, "sbr_env_map")
