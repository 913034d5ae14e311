"""Seconds from the process's start to the window's: imports, kernels from
the build cache, the stream's render, ``SLAM`` construction and the
warm-up frames (host clock)."""


def read(rec):
    return rec["setup_s"]
