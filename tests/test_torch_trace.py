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


class _FakeEvent:
    """A CUDA event's stand-in on the CPU: records nothing."""

    def __init__(self, *a, **kw):
        pass

    def record(self, *a):
        pass


def _walk_loop(on: bool) -> dict:
    """``test_torch_loop_slice``'s walk of one closure on its revisit world
    (detection, the three Sim3 stages, the correction and every GBA chunk to
    the commit) with tracing ``on`` or off, CUDA events faked; the closure
    finds a GBA in flight (abandoned).  Then a cascade on the same pair
    refused at stage A.  Returns what the tracer kept."""
    from test_torch_loop_slice import KF_CUR, KF_CAND, setup_slams

    _, ts = setup_slams()
    # what SLAM._ensure_loop_closer gives the loop closer it builds
    lc = ts.loop_closer
    lc.tracer, lc.span, lc.graph_span = ts.tracer, ts._loop_stage, ts._keyframe_program
    events = []

    def event(*a, **kw):
        events.append(a)
        return _FakeEvent()

    with pytest.MonkeyPatch.context() as m:
        m.setattr(torch.cuda, "Event", event)
        m.setattr(torch.cuda, "current_device", lambda: 0)
        if on:
            ts.time_programs = True
            ts.tracer.cuda = True             # device spans on the CPU, with the fake events
        ts._dispatch_loop_detect(KF_CUR)
        ts._resolve_pending_loop()
        ts._step_pending_sim3()
        ts._step_pending_sim3()
        ts._pending_gba = object()            # a GBA in flight when the closure lands
        assert ts._step_pending_sim3()
        while ts._pending_gba is not None:
            ts._step_pending_gba()
        lc.cfg = lc.cfg.replace(loop=dataclasses.replace(lc.cfg.loop, min_bow_matches=1 << 20))
        lc.sim3_begin(ts.map, ts.map_cam, KF_CUR, KF_CAND)
        ts._step_pending_sim3()
    return dict(spans=list(ts.tracer.spans), programs=[p[0] for p in ts.program_events], events=events,
                counts=dict(ts.tracer.counts), n_chunks=sum(ts.cfg.loop.global_ba_phase_iters))


@pytest.fixture(scope="module", params=[False, True], ids=["off", "on"])
def loop_walk(request) -> dict:
    return dict(_walk_loop(request.param), on=request.param)


def test_loop_closer_counters_and_events(loop_walk):
    """The loop closer's counters count with tracing on or off (as every
    counter does): one candidate, one closure that abandoned the GBA in
    flight, the GBA's chunks, the refused cascade's stage; its programs,
    the essential graph's ``optimize_essential`` among them, have device
    pairs in ``program_events`` with tracing on and none with it off."""
    c = loop_walk["counts"]
    assert c["loop.candidates"] == 1 and c["loop.closures"] == 1 and c["gba.aborted"] == 1
    assert c["gba.chunks"] == loop_walk["n_chunks"] and c["loop.rejected.sim3_a"] == 1
    assert not any(k.startswith("loop.rejected.sim3_") and k != "loop.rejected.sim3_a" for k in c)
    if not loop_walk["on"]:
        assert loop_walk["spans"] == [] and loop_walk["programs"] == [] and loop_walk["events"] == []
        return
    programs = Counter(loop_walk["programs"])
    for name in ("sim3_a", "sim3_b", "sim3_c", "correct_front", "fuse", "optimize_essential", "correct"):
        assert programs[name] >= 1, name
    assert programs["gba_chunk"] == loop_walk["n_chunks"] and programs["sim3_a"] == 2
    assert Counter(s[0] for s in loop_walk["spans"])["optimize_essential"] == 1
