"""Device ms of the keyframe programs (``map_front``, ``map_tail``,
``cull_kfs`` events of ``SLAM.program_events``) in the window, per keyframe
inserted in it."""

NAMES = ("map_front", "map_tail", "cull_kfs")


def read(rec):
    if rec["keyframes"] <= 0 or not rec["program_events"]:
        return None
    return sum(ms for name, ms in rec["program_events"] if name in NAMES) / rec["keyframes"]
