"""The 95th percentile, over every frame of the window whose pose came back
in it, of the ms from handing the frame to ``track()`` until the return of
the call that delivered its pose (host clock).  Read in traced runs, whose
profiler records the card's activity alone."""

import numpy as np


def read(rec):
    lat = rec["latency_ms"]
    return float(np.percentile(np.asarray(lat, np.float64), 95)) if len(lat) else None
