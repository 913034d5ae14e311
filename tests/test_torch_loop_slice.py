"""The loop-closing slice as a whole: both packages' ``SLAM`` driven through
their own loop methods from the same state, on the CPU.

The state is the 12-keyframe revisit world of ``test_torch_loop_closing``
(chain keyframes 0-10, keyframe 11 revisiting keyframe 0 with drifted
duplicates), keyframes 0-10 registered in each package's database with the
same vocabulary, ``consistency_th=1`` so that one detection verifies.  The
walk: ``_dispatch_loop_detect(11)`` → ``_resolve_pending_loop`` (stage A on
the minimal sets JAX draws from ``PRNGKey(11)``) → three
``_step_pending_sim3`` (stages B, C, then the closure: ``correct`` and the
GBA snapshot) → every ``_step_pending_gba`` (the last one commits and
re-anchors the tracker).  After each step: the pending stage and its gate
counts, the map (integer tables equal; keyframe poses within 1e-3 m /
5e-3°, points within 5e-3 m), the tracker's ``last`` pose, ``loops_closed``
and ``final_trajectory()`` agree.
"""

import jax
import numpy as np
import torch
from test_torch_epnp import jax_minimal_sets
from test_torch_loop_closing import assert_maps_agree, loop_world, make_cfg, states
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

import orb_slam2_ros2_tpu.config as jcfg
import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu.bow import vocabulary as jvoc
from orb_slam2_ros2_tpu.pipeline import loop_closing as jlc
from orb_slam2_ros2_tpu.pipeline.system import SLAM as JSLAM
from orb_slam2_ros2_tpu.pipeline.system import SlamFrame as JSlamFrame
from orb_slam2_ros2_tpu.pipeline.tracking import TrackState as JTrackState
from orb_slam2_ros2_tpu_torch.bow import vocabulary as tvoc
from orb_slam2_ros2_tpu_torch.pipeline import loop_closing as tlc
from orb_slam2_ros2_tpu_torch.pipeline.system import SLAM as TSLAM
from orb_slam2_ros2_tpu_torch.pipeline.system import SlamFrame as TSlamFrame
from orb_slam2_ros2_tpu_torch.pipeline.tracking import TrackState as TTrackState

KF_CUR, KF_CAND = 11, 0
POINT_M, POSE_M, POSE_DEG = 5e-3, 1e-3, 5e-3


def setup_slams():
    cfg_j = make_cfg(jcfg, K=16, M=2048, consistency_th=1)
    cfg_t = make_cfg(tcfg, K=16, M=2048, consistency_th=1)
    st, _ = loop_world(cfg_j, n_chain=11, P=100)
    sj, stt = states(st)
    descs = st["kf_desc"][st["kf_feat_valid"]]
    js, ts = JSLAM(cfg_j), TSLAM(cfg_t, device="cpu")
    js.loop_closer = jlc.LoopCloser(cfg_j, jvoc.train_vocabulary(descs, branching=8, depth=3, seed=0))
    ts.loop_closer = tlc.LoopCloser(cfg_t, tvoc.train_vocabulary(descs, branching=8, depth=3, seed=0))
    rel = np.eye(4, dtype=np.float32)
    rel[:3, 3] = [0.1, 0.0, 0.2]
    traj_rel = [(k, k, np.eye(4, dtype=np.float32)) for k in range(KF_CUR + 1)] + [(12, KF_CUR, rel)]
    for s, state, frame_cls, ok in ((js, sj, JSlamFrame, JTrackState.OK), (ts, stt, TSlamFrame, TTrackState.OK)):
        s.map = state
        for k in range(KF_CUR):
            s.loop_closer.add_keyframe_to_db(state, k)
        s.ref_kf, s._n_kf, s.frame_id, s.state = KF_CUR, KF_CUR + 1, 13, ok
        s.last = frame_cls(frame=None, Tcw=state.kf_Tcw[KF_CUR], mp_ids=state.kf_mp_idx[KF_CUR])
        s._traj_rel = list(traj_rel)
        s.trajectory = [(f, st["kf_Tcw"][min(f, KF_CUR)]) for f in range(13)]
    # the port's stage A draws the minimal sets JAX draws from PRNGKey(kf_cur)
    ok = np.asarray(jax.jit(jlc.match_mappoint_features)(sj, KF_CUR, KF_CAND)[0])
    sets = torch.from_numpy(jax_minimal_sets(jax.random.PRNGKey(KF_CUR), ok, min_set=3))
    begin = ts.loop_closer.sim3_begin
    ts.loop_closer.sim3_begin = lambda *a, **k: begin(*a, sets=sets, **k)
    return js, ts


def assert_slams_agree(js, ts):
    assert_maps_agree(js.map, ts.map, point_m=POINT_M, pose_m=POSE_M, pose_deg=POSE_DEG)
    assert ts.loops_closed == getattr(js, "loops_closed", 0)
    np.testing.assert_allclose(ts.last.Tcw.numpy(), np.asarray(js.last.Tcw), atol=POSE_M)
    fj, ft = js.final_trajectory(), ts.final_trajectory()
    assert [f for f, _ in ft] == [f for f, _ in fj]
    np.testing.assert_allclose(np.stack([T for _, T in ft]), np.stack([T for _, T in fj]), atol=POSE_M)


def pending_stage(s):
    p = s.loop_closer.pending_sim3
    return None if p is None else p["stage"]


def gates(p):
    return tlc._fetch(p["gates"]).tolist()


def test_slam_with_mapping_no_longer_refuses_loop_closing():
    ts = TSLAM(make_cfg(tcfg), device="cpu")
    assert ts.enable_loop_closing and ts.loops_closed == 0 and ts._pending_gba is None
    only = make_cfg(tcfg)
    only = only.replace(tracking=only.tracking.__class__(only_tracking=True))
    assert not TSLAM(only, device="cpu").enable_loop_closing


def test_loop_walk_matches_jax():
    js, ts = setup_slams()
    assert_slams_agree(js, ts)

    js._dispatch_loop_detect(KF_CUR)
    ts._dispatch_loop_detect(KF_CUR)
    assert len(ts._pending_loops) == len(js._pending_loops) == 1
    np.testing.assert_array_equal(tlc._fetch(ts._pending_loops[0][1]), np.asarray(js._pending_loops[0][1]))
    np.testing.assert_array_equal(ts.loop_closer.db.word_ids.numpy(), np.asarray(js.loop_closer.db.word_ids))

    js._resolve_pending_loop()
    ts._resolve_pending_loop()
    assert pending_stage(ts) == pending_stage(js) == "a"
    assert gates(ts.loop_closer.pending_sim3) == np.asarray(js.loop_closer.pending_sim3["gates"]).tolist()

    last_before = ts.last.Tcw.clone()
    for want in ("b", "c", None):
        closed_j, closed_t = js._step_pending_sim3(), ts._step_pending_sim3()
        assert pending_stage(ts) == pending_stage(js) == want
        if want is not None:
            assert gates(ts.loop_closer.pending_sim3) == np.asarray(js.loop_closer.pending_sim3["gates"]).tolist()
        assert closed_t == closed_j == (want is None)
        assert_slams_agree(js, ts)
    assert ts.loops_closed == 1 and ts._pending_gba is not None
    # the re-anchor moved the tracker (its reference pose was copied first)
    assert (ts.last.Tcw - last_before).abs().max() > 1e-3
    assert ts.map.loop_edges[0].tolist() == [KF_CUR, KF_CAND]
    assert ts._pending_loops == [] and ts.loop_closer.consistent_groups == []
    for name in ("pm_cam", "pm_valid", "cm_pt", "cm_valid"):
        np.testing.assert_array_equal(getattr(ts._pending_gba.prob, name).numpy(),
                                      np.asarray(getattr(js._pending_gba.prob, name)), err_msg=name)

    n_chunks = sum(ts.cfg.loop.global_ba_phase_iters)
    for chunk in range(n_chunks):
        js._step_pending_gba()
        ts._step_pending_gba()
        if chunk < n_chunks - 1:
            assert ts._pending_gba.chunks_done == js._pending_gba.chunks_done == chunk + 1
            np.testing.assert_allclose(ts._pending_gba.Tcw.numpy(), np.asarray(js._pending_gba.Tcw), atol=POSE_M)
    assert ts._pending_gba is None and js._pending_gba is None
    assert_slams_agree(js, ts)

    # nothing is left to drain
    ts.flush()
    assert ts._pending_gba is None and ts.loop_closer.pending_sim3 is None
