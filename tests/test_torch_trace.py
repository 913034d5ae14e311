"""The system's tracer (``pipeline/trace.py``, switched by
``SLAM.time_programs``) on the CPU, over a synchronous and a pipelined run
of the mapping configuration of ``test_torch_mapping.small_cfg``: every
frame a keyframe at 0.35 m a frame, so the keyframe programs and, in the
pipelined loop, the re-dispatch after each keyframe run.

Each run tracks two frames with tracing off, then four with it on:

* off records nothing: no host span, no ``program_events``, no CUDA event;
* spans nest: each span's parent encloses it and carries its frame id, and
  each ``track()`` call has one ``track`` span, with a frame id of its own;
* the wait spans (``fetch_wait``, ``pinned_wait``, ``read``) lie inside the
  ``track`` span of their call;
* the counters: a re-dispatch for every keyframe the pipelined loop
  inserted (none in the synchronous loop), and every call counted.
"""

import dataclasses
from collections import Counter

import pytest
import torch
from test_torch_mapping import small_cfg, two_torch_threads  # noqa: F401  (autouse)

import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu_torch.io.synthetic import SyntheticStereoDataset
from orb_slam2_ros2_tpu_torch.pipeline import system as tsys
from orb_slam2_ros2_tpu_torch.pipeline.trace import WAITS

OFF_FRAMES, ON_FRAMES = 2, 4
CASES = ("off_records_nothing", "spans_nest", "waits_inside_track", "counters")


@pytest.fixture(scope="module", params=[False, True], ids=["sync", "pipelined"])
def run(request) -> dict:
    """One run a mode: what tracing off and on left."""
    pipelined = request.param
    cfg = small_cfg(tcfg)
    cfg = cfg.replace(tracking=dataclasses.replace(cfg.tracking, pipelined=pipelined))
    ds = SyntheticStereoDataset(cfg.camera, n_frames=OFF_FRAMES + ON_FRAMES, speed=0.35, device="cpu")
    slam = tsys.SLAM(cfg, enable_loop_closing=False, device="cpu")
    events = []
    with pytest.MonkeyPatch.context() as m:
        m.setattr(torch.cuda, "Event", lambda *a, **kw: events.append(a))
        for i in range(OFF_FRAMES):
            slam.track(*ds.frame(i)[:2])
        off = dict(spans=list(slam.tracer.spans), program_events=list(slam.program_events), events=list(events),
                   counts=dict(slam.tracer.counts))
    slam.time_programs = True
    for i in range(OFF_FRAMES, OFF_FRAMES + ON_FRAMES):
        slam.track(*ds.frame(i)[:2])
    return dict(pipelined=pipelined, off=off, spans=slam.tracer.spans, export=slam.trace_export(), n_kf=slam._n_kf)


@pytest.mark.parametrize("case", CASES)
def test_tracer(run, case):
    pipelined = run["pipelined"]
    spans = run["spans"]
    tracks = [s for s in spans if s[0] == "track"]
    if case == "off_records_nothing":
        off = run["off"]
        assert off["spans"] == [] and off["program_events"] == [] and off["events"] == []
        assert off["counts"]["frames"] == OFF_FRAMES          # counters count either way
    elif case == "spans_nest":
        assert len(tracks) == ON_FRAMES
        assert len({s[4] for s in tracks}) == ON_FRAMES and all(s[3] == -1 for s in tracks)
        names = Counter(s[0] for s in spans)
        assert names["upload"] == names["dispatch"] == ON_FRAMES and names["map_front"] >= 1
        for s in spans:
            assert s[1] <= s[2]
            if s[3] >= 0:
                p = spans[s[3]]
                assert p[1] <= s[1] and s[2] <= p[2] and p[4] == s[4]
            else:
                assert s[0] == "track"
    elif case == "waits_inside_track":
        waits = [s for s in spans if s[0] in WAITS]
        assert any(s[0] == "fetch_wait" for s in waits)
        by_frame = {s[4]: s for s in tracks}
        for w in waits:
            t = by_frame[w[4]]
            assert t[1] <= w[1] and w[2] <= t[2]
    else:
        counters = run["export"]["counters"]
        inserted = run["n_kf"] - 1                  # keyframe 0 is the map's first frame
        assert inserted >= 2
        assert counters["frames"] == OFF_FRAMES + ON_FRAMES and counters["keyframes"] == run["n_kf"]
        if pipelined:
            # each keyframe is decided one frame late, its successor in flight
            assert counters["redispatch.keyframe"] == inserted
            assert counters.get("redispatch.weak", 0) == counters.get("ref_fallback", 0) - counters.get("lost", 0)
        else:
            assert not any(k.startswith("redispatch") for k in counters)
        assert counters["map_copy_bytes"] > 0 and run["export"]["device"] == []
