"""Megabytes (1e6 bytes) the codec plug-in sends to the card a decoded
group over the traced plays: the recording's ``h2d_bytes.codec.*``
counters (the group's upload and the constants it sends with it) over its
``groups.codec`` counter."""

PREFIX = "h2d_bytes.codec."


def read(window: dict):
    s = window.get("spans")
    if not s or not s["counters"].get("groups.codec"):
        return None
    c = s["counters"]
    return sum(v for k, v in c.items() if k.startswith(PREFIX)) \
        / c["groups.codec"] / 1e6
