"""Device ms of the loop closer's programs (the three Sim3 stages
``sim3_a``, ``sim3_b``, ``sim3_c``, the correction's ``correct_front`` and
``fuse``, and the essential graph, ``optimize_essential``: events of
``SLAM.program_events``) in the window, per loop closed in it.  None
without a closure or without events."""

NAMES = ("sim3_a", "sim3_b", "sim3_c", "correct_front", "fuse", "optimize_essential")


def read(rec):
    if rec["closures"] <= 0 or not rec["program_events"]:
        return None
    return sum(ms for name, ms in rec["program_events"] if name in NAMES) / rec["closures"]
