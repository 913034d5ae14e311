"""The map side of a long run, on the CPU: a second closure while the
first closure's global BA is in flight, and the scale run's auto-grow.

* A correction with a GBA pending discards it and starts anew, as JAX's
  ``SLAM`` does (the reference's stop-and-restart, LoopClosing.cc:87): both
  packages walk the loop slice of ``tests/test_torch_loop_slice.py`` to its
  closure, run one GBA chunk, then verify the same closure again; after it
  each holds a new GBA with no chunk done, snapshotted from the map the
  second correction left, and the two agree (the maps within that file's
  tolerances, the snapshots' integer tables equal, two closures each).
* ``scale_run.main`` at 320×192 with room for 8 keyframes and 4096 points:
  its JSON line holds the JAX script's keys and a grow event, every frame
  tracked.
"""

import json

import numpy as np
import torch
from test_torch_loop_slice import assert_slams_agree, setup_slams
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

from orb_slam2_ros2_tpu_torch import scale_run
from orb_slam2_ros2_tpu_torch.solvers.global_ba import start_global_ba

SCALE_YAML = """\
camera: {fx: 200.0, fy: 200.0, cx: 160.0, cy: 96.0, baseline: 0.5, width: 320, height: 192}
orb: {n_features: 1000, max_keypoints: 1024}
tracking: {min_init_depth_kps: 60, max_local_mappoints: 4096, max_local_keyframes: 16}
bow: {branching: 4, depth: 2}
ba: {pcg_iters: 15}
"""


def _record_closure(slam) -> list:
    """Keep the verified result of ``slam``'s cascade."""
    seen = []
    step = slam.loop_closer.sim3_step

    def spy(*a):
        res = step(*a)
        if res is not None:
            seen.append(res)
        return res

    slam.loop_closer.sim3_step = spy
    return seen


def test_correction_discards_pending_gba_like_jax():
    js, ts = setup_slams()
    verified = {"jax": _record_closure(js), "torch": _record_closure(ts)}
    for s in (js, ts):
        s._dispatch_loop_detect(11)
        s._resolve_pending_loop()
        while s.loop_closer.pending_sim3 is not None:
            s._step_pending_sim3()
        s._step_pending_gba()
    assert ts.loops_closed == js.loops_closed == 1
    assert ts._pending_gba.chunks_done == js._pending_gba.chunks_done == 1
    first = ts._pending_gba

    # the same closure verified again while the GBA is in flight
    for name, s in (("jax", js), ("torch", ts)):
        res = verified[name][0]
        s.loop_closer.sim3_step = lambda *a, res=res: res
        assert s._step_pending_sim3()
    assert ts.loops_closed == js.loops_closed == 2
    assert ts._pending_gba is not first and ts._pending_gba.chunks_done == js._pending_gba.chunks_done == 0
    assert ts._last_closure_fid == js._last_closure_fid == ts.frame_id
    assert_slams_agree(js, ts)
    # snapshotted from the map the second correction left
    fresh = start_global_ba(ts.map, ts.cfg.orb.scale_factor)
    for a, b in zip(ts._pending_gba, fresh):
        if torch.is_tensor(a):
            assert torch.equal(a, b)
    for name in ("pm_cam", "pm_valid", "cm_pt", "cm_valid"):
        np.testing.assert_array_equal(getattr(ts._pending_gba.prob, name).numpy(),
                                      np.asarray(getattr(js._pending_gba.prob, name)), err_msg=name)


def test_scale_run_main_grows(tmp_path, capsys):
    cfg = tmp_path / "small.yaml"
    cfg.write_text(SCALE_YAML)
    out = tmp_path / "scale.json"
    res = scale_run.main(["--frames", "12", "--lap", "800", "--device", "cpu", "--config", str(cfg),
                          "--kf-capacity", "8", "--mp-capacity", "4096", "--out", str(out)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(out.read_text()) == json.loads(json.dumps(res))
    keys = {"frames", "lost", "keyframes_inserted", "keyframes_live", "loops_closed", "grow_events",
            "start_capacity", "final_capacity", "final_map_mb", "pcg_essential_in_system", "fps_curve"}
    assert keys <= set(line)
    assert line["frames"] == 12 and line["lost"] == 0 and line["start_capacity"] == [8, 4096]
    assert line["grow_events"] >= 1 and line["final_capacity"][0] >= 16
    assert line["grow"][0]["frm"] == [8, 4096] and line["grow"][0]["to"][0] == 16
    assert line["final_map_mb"] > 0 and not line["pcg_essential_in_system"]
