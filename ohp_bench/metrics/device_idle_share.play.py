"""Percent of the traced window in which no operation ran on the card:
1 - the union of the device's busy intervals over the window."""

from ..trace import idle_share


def read(window: dict):
    return idle_share(window)
