"""play_x: decoded audio seconds the sink received in every play of the
window, over the window's wall (first play's start to the end of the play
in flight when the window's time ran out)."""


def read(window: dict):
    if not window["records"] or window["wall_s"] <= 0:
        return None
    return sum(r["audio_s"] for r in window["records"]) / window["wall_s"]
