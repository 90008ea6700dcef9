"""tns_rows's share of its roofline: the work of the traced calls' content
(``work/aac.py``) at the card's peaks over the kernel's device time."""

from ..trace import roofline


def read(window: dict):
    return roofline(window, "tns_rows")
