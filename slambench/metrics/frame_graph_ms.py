"""Device ms of one frame-graph call (input copies, the replay, the output
clones), averaged over every call in the window: CUDA events the benchmark
records around ``FrameGraphs.run``."""


def read(rec):
    ms = rec["frame_graph_ms"]
    return sum(ms) / len(ms) if ms else None
