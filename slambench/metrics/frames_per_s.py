"""Frames whose pose ``track()`` returned inside the window, over the
window's seconds (host clock)."""


def read(rec):
    return rec["frames_done"] / rec["window_s"] if rec["window_s"] > 0 else None
