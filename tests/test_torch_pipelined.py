"""The port's pipelined tracking loop (``tracking.pipelined=True``) against
the JAX package's, on the CPU, at the configuration of
``tests/test_pipelined.py`` (320×192, 512 keypoints, a keyframe nearly every
frame at 0.55 m/frame) over 12 frames rendered by the JAX package.

* Against the JAX pipelined ``SLAM`` on the same frames: the same TrackState
  after every call, the same calls returning a pose (the first tracked frame
  returns the fill marker), the same keyframe count after every call, every
  trajectory pose and every final-trajectory pose within 1 cm / 0.1° (the
  tolerance of ``tests/test_torch_mapping_slice.py``), equal keyframe counts
  and map points within 3%.
* Against the port's own synchronous loop (the checks of
  ``tests/test_pipelined.py``): every frame in order in ``trajectory``, at
  most two fewer poses returned, ATE ≤ 1.5 × sync + 0.03 m, keyframes within
  ±3; ``final_trajectory`` covers every frame and ``save`` writes the map.
* The places the port departs from the JAX loop: a weak frame's
  recovery re-dispatches its successor with the local map the weak frame was
  dispatched with (what the synchronous loop keeps); its fallback starts
  from the frame the weak one was dispatched from and keeps the motion
  model, as the synchronous loop's does; and a correction re-dispatches the
  in-flight frame against the corrected map, from the frame it was
  dispatched from, moved, with the velocity it measured (JAX moves its pose
  only when it is the same object as the last frame, and restarts the
  motion model from the identity).

The blackout relocalization case is ``tests/test_torch_pipelined_reloc.py``.
"""

import dataclasses as dc

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mapping import jax_local_ba, rot_deg, two_torch_threads  # noqa: F401  (autouse)

import orb_slam2_ros2_tpu.config as jcfg
import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu.io.synthetic import SyntheticStereoDataset as JDataset
from orb_slam2_ros2_tpu.io.trajectory import ate_rmse
from orb_slam2_ros2_tpu.pipeline import system as jsys
from orb_slam2_ros2_tpu_torch.geometry import se3
from orb_slam2_ros2_tpu_torch.pipeline import system as tsys
from orb_slam2_ros2_tpu_torch.pipeline.tracking import TrackState

N_FRAMES = 12
POSE_TOL_M, POSE_TOL_DEG = 1e-2, 0.1
MP_REL_TOL = 0.03


def pipe_cfg(mod, pipelined=True, **tracking):
    """The configuration of ``tests/test_pipelined.py``."""
    return mod.SLAMConfig(
        camera=mod.CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=96.0, baseline=0.5,
                                width=320, height=192),
        orb=mod.ORBConfig(n_features=500, max_keypoints=512),
        tracking=mod.TrackingConfig(**{**dict(min_init_depth_kps=120, max_local_mappoints=4096,
                                              max_local_keyframes=16, min_localmap_matches=20,
                                              min_localmap_inliers=20, pipelined=pipelined),
                                       **tracking}),
        mapping=mod.MappingConfig(synchronous=False),
        map=mod.MapConfig(max_keyframes=32, max_mappoints=8192, max_obs_per_mp=12),
        bow=mod.BoWConfig(branching=4, depth=2),
        ba=mod.BAConfig(pcg_iters=15, **jax_local_ba(mod)),
    )


def render(n, speed):
    ds = JDataset(pipe_cfg(jcfg).camera, n_frames=n, speed=speed)
    return [tuple(np.asarray(x) for x in ds.frame(i)) for i in range(n)]


def run(slam, frames) -> dict:
    out = dict(states=[], returned=[], n_kf=[])
    for img_l, img_r, _ in frames:
        pose, _ = slam.track(img_l, img_r)
        out["states"].append(slam.state.name)
        out["returned"].append(pose is not None)
        out["n_kf"].append(slam._n_kf)
    slam.flush()
    out.update(slam=slam, traj=list(slam.trajectory), final=slam.final_trajectory())
    return out


@pytest.fixture(scope="module")
def frames():
    return render(N_FRAMES, 0.55)


@pytest.fixture(scope="module")
def runs(frames):
    return dict(
        jax=run(jsys.SLAM(pipe_cfg(jcfg), enable_loop_closing=False), frames),
        torch=run(tsys.SLAM(pipe_cfg(tcfg), enable_loop_closing=False, device="cpu"), frames),
        sync=run(tsys.SLAM(pipe_cfg(tcfg, pipelined=False), enable_loop_closing=False, device="cpu"),
                 frames),
    )


def _poses_close(a, b):
    Pa, Pb = np.stack([T for _, T in a]), np.stack([T for _, T in b])
    assert [f for f, _ in a] == [f for f, _ in b]
    assert np.abs(Pa[:, :3, 3] - Pb[:, :3, 3]).max() <= POSE_TOL_M
    assert rot_deg(Pa, Pb).max() <= POSE_TOL_DEG


def _check_states(j, t):
    assert t["states"] == j["states"] and all(s == "OK" for s in t["states"])
    assert t["returned"] == j["returned"] and not t["returned"][1]   # the fill marker
    assert t["n_kf"] == j["n_kf"] and j["n_kf"][-1] >= 4


def _check_trajectory(j, t):
    assert [f for f, _ in t["traj"]] == list(range(N_FRAMES))
    _poses_close(j["traj"], t["traj"])


def _check_final(j, t):
    assert [f for f, _ in t["final"]] == list(range(N_FRAMES))
    _poses_close(j["final"], t["final"])


def _check_map(j, t):
    assert t["slam"].n_keyframes == j["slam"].n_keyframes
    assert abs(t["slam"].n_mappoints - j["slam"].n_mappoints) <= MP_REL_TOL * j["slam"].n_mappoints


CHECKS = {"states_and_keyframes": _check_states, "trajectory": _check_trajectory,
          "final_trajectory": _check_final, "map_size": _check_map}


@pytest.mark.parametrize("check", list(CHECKS))
def test_pipelined_matches_jax(runs, check):
    CHECKS[check](runs["jax"], runs["torch"])


def test_pipelined_matches_sync_accuracy(runs, frames):
    p, s = runs["torch"], runs["sync"]
    fids = [f for f, _ in p["traj"]]
    assert fids == list(range(N_FRAMES))
    assert sum(p["returned"]) >= sum(s["returned"]) - 2
    gt = [frames[f][2] for f in fids]

    def ate(traj):
        return ate_rmse([np.linalg.inv(T) for _, T in traj], gt)

    assert ate(p["traj"]) <= 1.5 * ate(s["traj"]) + 0.03
    assert abs(p["slam"].n_keyframes - s["slam"].n_keyframes) <= 3


def test_pipelined_final_trajectory_and_save(runs, tmp_path):
    slam = runs["torch"]["slam"]
    assert len(runs["torch"]["final"]) == N_FRAMES and slam._inflight is None
    slam.save(str(tmp_path / "m"))
    assert (tmp_path / "m.map.npz").exists()


# ------------------------------------------------- departures from JAX --

def _spy_frames(slam):
    """Record (frame id being tracked, the local map passed, the local map
    returned, the velocity passed) of every frame program the SLAM
    dispatches."""
    calls = []
    run_frame = slam._run_frame

    def spy(img_l, img_r, last, velocity, local, wide):
        out = run_frame(img_l, img_r, last, velocity, local, wide)
        calls.append((slam.frame_id - 1, local, out[3], velocity))
        return out

    slam._run_frame = spy
    return calls


def _run_weak_frame_3(frames, pipelined):
    """Six frames with frame 3 forced weak (a local-map match bar no frame
    reaches) and recovered by the reference-keyframe fallback, no keyframe
    after it, the mapping tail inside each insertion (so nothing else
    replaces the local map).  Returns (the SLAM, its frame programs)."""
    cfg = pipe_cfg(tcfg, pipelined=pipelined)
    cfg = cfg.replace(mapping=dc.replace(cfg.mapping, synchronous=True))
    weak_cfg = cfg.replace(tracking=dc.replace(cfg.tracking, min_localmap_matches=10 ** 6))
    slam = tsys.SLAM(cfg, enable_loop_closing=False, device="cpu")
    calls = _spy_frames(slam)
    need_keyframe = slam._need_keyframe
    weak_at = 4 if pipelined else 3          # the call that resolves frame 3
    for i in range(6):
        slam.cfg = weak_cfg if i == weak_at else cfg
        slam._need_keyframe = (lambda *a, **kw: False) if i == weak_at else need_keyframe
        pose, stats = slam.track(*frames[i][:2])
        if i == weak_at:
            assert stats.get("ref_fallback") == 1 and slam.state == TrackState.OK
    slam.flush()
    return slam, calls


@pytest.mark.parametrize("pipelined", [False, True])
def test_weak_frame_keeps_its_dispatch_local_map(frames, pipelined):
    """Frame 3 resolves weak and the fallback recovers it.  The synchronous
    loop tracks frame 4 against the local map frame 3 was given; the
    pipelined loop re-dispatches frame 4 with that same map — frame 3's
    dispatch input, where the JAX loop restores frame 3's own snapshot."""
    slam, calls = _run_weak_frame_3(frames, pipelined)
    last3 = [c for c in calls if c[0] == 3][-1]          # frame 3's (last) dispatch
    first4 = [c for c in calls if c[0] == 4]
    if pipelined:
        speculative, redispatch = first4[0], first4[1]
        assert speculative[1] is last3[2]                # dispatched on frame 3's snapshot
        assert redispatch[1] is last3[1]                 # re-dispatched on frame 3's input
        assert not torch.equal(redispatch[1].mp_ids, last3[2].mp_ids)
    else:
        assert first4[0][1] is last3[1]
    assert [f for f, _ in slam.trajectory][:5] == [0, 1, 2, 3, 4]


def test_weak_frame_fallback_keeps_the_motion_model(frames, runs):
    """Frame 3 resolves weak.  The pipelined fallback starts from frame 2,
    the frame it dispatched frame 3 from, and re-dispatches frame 4 with the
    velocity it measured — what the synchronous loop tracks frame 4 with:
    the velocities and the poses of frames 0-5 agree within the tolerance.
    The JAX loop's fallback starts from the weak frame's own estimate and
    restarts the motion model from the identity, so a camera that moves
    0.55 m a frame is predicted standing still."""
    (sync, s_calls), (pipe, p_calls) = (_run_weak_frame_3(frames, p) for p in (False, True))
    v_sync = s_calls[[c[0] for c in s_calls].index(4)][3]
    v_pipe = p_calls[[c[0] for c in p_calls].index(4) + 1][3]   # frame 4's re-dispatch
    assert float(torch.linalg.norm(v_sync[:3, 3])) > 0.3
    assert float((v_pipe[:3, 3] - v_sync[:3, 3]).abs().max()) <= POSE_TOL_M
    assert rot_deg(v_pipe[None].numpy(), v_sync[None].numpy()).max() <= POSE_TOL_DEG
    _poses_close(sync.trajectory, pipe.trajectory)

    js = runs["jax"]["slam"]
    stats = {}
    assert js._track_reference(js.last.frame, stats, Tcw0=js.last.Tcw)
    np.testing.assert_array_equal(np.asarray(js._ref_result[1]), np.eye(4, dtype=np.float32))


def _correct_map(slam, G):
    """A correction that moves the whole map by the rigid motion ``G``
    (points ``G·p``, keyframes ``Tcw·G⁻¹``), published as the closure and
    the GBA commit publish theirs, then the tracker re-anchored.  Returns
    the correction's delta of every pose, ``G⁻¹``."""
    m = slam.map
    ref_before = m.kf_Tcw[slam.ref_kf].clone()
    slam.map = m._replace(kf_Tcw=m.kf_Tcw @ se3.inverse(G), mp_pos=se3.apply(G, m.mp_pos))
    slam._publish_local(slam._snapshot(slam.map, slam.ref_kf))
    slam._reanchor_tracker(ref_before)
    return se3.inverse(G)


def test_reanchor_moves_the_inflight_pose(frames):
    """A correction lands while a frame is in flight: the frame is
    re-dispatched against the corrected map from the frame it was
    dispatched from, moved by the correction, and its pose comes out where
    the correction put its scene (within the tolerance); its record now
    holds the corrected local map.  The JAX loop moves an in-flight pose
    only when it is the same object as the last frame."""
    G = se3.exp(torch.tensor([0.05, -0.02, 0.1, 0.01, 0.02, -0.03]))
    slam = tsys.SLAM(pipe_cfg(tcfg), enable_loop_closing=False, device="cpu")
    for i in range(3):
        slam.track(*frames[i][:2])
    inf = slam._inflight
    assert inf is not None and inf.state is slam.last
    T_inf, T_from = inf.state.Tcw.clone(), inf.last_in.Tcw.clone()
    delta = _correct_map(slam, G)
    moved = slam._inflight
    assert moved.fid == inf.fid and moved.state is slam.last
    assert slam.tracer.counts["redispatch.correction"] == 1
    torch.testing.assert_close(moved.last_in.Tcw, T_from @ delta)
    _poses_close([(0, (T_inf @ delta).numpy())], [(0, moved.state.Tcw.numpy())])
    assert not torch.allclose(moved.state.Tcw, T_inf, atol=1e-3)
    assert torch.equal(moved.local_in.pos, slam._snapshot(slam.map, slam.ref_kf).pos)

    js = jsys.SLAM(pipe_cfg(jcfg), enable_loop_closing=False)
    Dj = jnp.asarray(G.numpy())
    T = jnp.asarray(T_inf.numpy())
    for same in (True, False):
        js.last = jsys.SlamFrame(frame=None, Tcw=T, mp_ids=None)
        inflight_state = js.last if same else jsys.SlamFrame(frame=None, Tcw=T, mp_ids=None)
        js._inflight = (5, inflight_state, None, None, 0, None)
        js._reanchor_tracker(jnp.linalg.inv(Dj))           # kf_Tcw[0] is the identity
        moved = not np.allclose(np.asarray(js._inflight[1].Tcw), np.asarray(T), atol=1e-3)
        assert moved == same


def test_reanchor_keeps_the_inflight_velocity(frames):
    """With a frame in flight a correction re-dispatches it with the
    velocity it measured (a motion between two frames tracked on the same
    map, which one correction of both leaves as it was), and the re-tracked
    velocity agrees with it; with none, as in the synchronous loop, the
    motion model restarts from the identity.  The JAX loop restarts it in
    both cases."""
    D = se3.exp(torch.tensor([0.05, -0.02, 0.1, 0.01, 0.02, -0.03]))
    eye = torch.eye(4)
    for pipelined in (True, False):
        slam = tsys.SLAM(pipe_cfg(tcfg, pipelined=pipelined), enable_loop_closing=False, device="cpu")
        for i in range(4):
            slam.track(*frames[i][:2])
        v = slam.velocity.clone()
        assert float(torch.linalg.norm(v[:3, 3])) > 0.3
        calls = _spy_frames(slam)
        if pipelined:
            assert torch.equal(slam._inflight.velocity, v)
        _correct_map(slam, D)
        if pipelined:                                    # the in-flight frame's re-dispatch
            assert len(calls) == 1 and torch.equal(calls[0][3], v)
            assert float((slam.velocity[:3, 3] - v[:3, 3]).abs().max()) <= POSE_TOL_M
        else:
            assert calls == [] and torch.equal(slam.velocity, eye)

    js = jsys.SLAM(pipe_cfg(jcfg), enable_loop_closing=False)
    js.last = jsys.SlamFrame(frame=None, Tcw=jnp.eye(4, dtype=jnp.float32), mp_ids=None)
    js.velocity = jnp.asarray(v.numpy())
    js._inflight = (5, js.last, js.velocity, None, 0, None)
    js._reanchor_tracker(jnp.linalg.inv(jnp.asarray(D.numpy())))
    np.testing.assert_array_equal(np.asarray(js.velocity), np.eye(4, dtype=np.float32))
