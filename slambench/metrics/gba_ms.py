"""Device ms of the background global BA's chunks (``gba_chunk`` events of
``SLAM.program_events``) in the window, per loop closed in it.  None
without a closure or without events."""


def read(rec):
    if rec["closures"] <= 0 or not rec["program_events"]:
        return None
    return sum(ms for name, ms in rec["program_events"] if name == "gba_chunk") / rec["closures"]
