"""decode_x: decoded audio seconds (output samples per channel over the
output rate, summed over streams) of every serving call in the window,
over the window's wall (first call's start to the end of the call in
flight when the window's time ran out)."""


def read(window: dict):
    if not window["records"] or window["wall_s"] <= 0:
        return None
    return sum(r["audio_s"] for r in window["records"]) / window["wall_s"]
