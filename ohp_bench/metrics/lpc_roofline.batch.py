"""lpc_rows's share of its roofline: the work of the traced calls' content
(``work/flac.py``) at the card's peaks over the kernel's device time."""

from ..trace import roofline


def read(window: dict):
    return roofline(window, "lpc_rows")
