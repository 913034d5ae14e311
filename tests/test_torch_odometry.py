"""Parity of the port's odometry path with the JAX package's, on the CPU, at
the odometry configuration of ``tests/test_odometry_e2e.py`` (320×192, 600
features, 768 keypoint slots), on JAX-rendered frames 0.35 m apart.

* ``search_by_area`` on the same JAX features: indices and distances exact,
  for forward, backward and sideways motion.
* ``motion_track_step`` on the same converted frames and state: match and
  inlier counts exact, pose within 1e-4 (the tolerance of
  ``slam_track_step`` on identical state, ``tests/test_torch_tracking.py``).
* ``OdometryTracker`` over 10 frames, each package on its own frontend, with
  a match floor that sends some frames through the wide-radius retry:
  the same states, ``wide_retry`` flags and initialization, poses within
  1 cm / 0.1° (the mapping parity budget: a few corners move between the
  frontends), and the JAX test's ATE bound (5% of the path).
* The fused step against JAX's ``make_fused_odometry_step`` over the same
  frames (poses 1 cm / 0.1°), and the port's graph wrapper run eagerly
  (``StepGraph(capture=False)``: static inputs copied in, outputs cloned)
  bit-equal to the direct program, capturing once.
* ``SLAM._pose_from_mp`` against JAX's on the same map points and frame.
* ``SLAM.time_programs`` on the CPU eager path records every stage that
  ran as a host span.
"""

import types
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mapping import small_cfg, two_torch_threads  # noqa: F401  (autouse)

import orb_slam2_ros2_tpu.config as jcfg
import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu.features.extractor import make_stereo_frontend as jfrontend
from orb_slam2_ros2_tpu.geometry import se3 as jse3
from orb_slam2_ros2_tpu.geometry.camera import CameraParams as JCam
from orb_slam2_ros2_tpu.io.synthetic import SyntheticStereoDataset as JDataset
from orb_slam2_ros2_tpu.io.trajectory import ate_rmse
from orb_slam2_ros2_tpu.matching import matcher as jmatcher
from orb_slam2_ros2_tpu.pipeline import system as jsys
from orb_slam2_ros2_tpu.pipeline import tracking as jtr
from orb_slam2_ros2_tpu_torch import convert
from orb_slam2_ros2_tpu_torch.features.extractor import make_stereo_frontend as tfrontend
from orb_slam2_ros2_tpu_torch.geometry.camera import CameraParams as TCam
from orb_slam2_ros2_tpu_torch.io.synthetic import SyntheticStereoDataset as TDataset
from orb_slam2_ros2_tpu_torch.matching import matcher as tmatcher
from orb_slam2_ros2_tpu_torch.pipeline import system as tsys
from orb_slam2_ros2_tpu_torch.pipeline import tracking as ttr
from orb_slam2_ros2_tpu_torch.pipeline.frame_graph import StepGraph, tree_leaves

N_FRAMES = 10
SPEED = 0.35
POSE_M, POSE_DEG = 1e-2, 0.1


def odo_cfg(mod, **tracking):
    return mod.SLAMConfig(
        camera=mod.CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=96.0, baseline=0.5, width=320, height=192),
        orb=mod.ORBConfig(n_features=600, max_keypoints=768),
        tracking=mod.TrackingConfig(min_init_depth_kps=150, **tracking),
    )


def pose_close(a, b, tol_m=POSE_M, tol_deg=POSE_DEG):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    dR = a[:3, :3] @ b[:3, :3].T
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    dt = np.linalg.norm(np.linalg.inv(a)[:3, 3] - np.linalg.inv(b)[:3, 3])
    assert dt <= tol_m and ang <= tol_deg, (dt, ang)


@pytest.fixture(scope="module")
def frames():
    ds = JDataset(odo_cfg(jcfg).camera, n_frames=N_FRAMES, speed=SPEED)
    return [tuple(np.array(x) for x in ds.frame(i)) for i in range(N_FRAMES)]


@pytest.fixture(scope="module")
def jax_frames(frames):
    """The JAX frontend's StereoFrames of every frame (numpy trees)."""
    cfg = odo_cfg(jcfg)
    fe, cam = jax.jit(jfrontend(cfg)), JCam.from_config(cfg.camera)
    return [jax.tree.map(np.asarray, fe(jnp.asarray(l), jnp.asarray(r), cam)) for l, r, _ in frames]


def to_t(sf):
    return convert.stereo_frame_to_torch(sf, "cpu")


@pytest.mark.parametrize("z_forward", [1.0, -1.0, 0.0])
def test_search_by_area_exact(jax_frames, z_forward):
    cfg = odo_cfg(jcfg)
    prev, cur = jax_frames[3].feats, jax_frames[4].feats
    r = np.random.default_rng(int(z_forward) + 5)
    prev_has = r.random(prev.valid.shape) < 0.8
    cur_has = r.random(cur.valid.shape) < 0.1
    kw = dict(radius=cfg.tracking.motion_search_radius, scale_factor=cfg.orb.scale_factor,
              n_levels=cfg.orb.n_levels, baseline=cfg.camera.baseline,
              max_dist=cfg.matcher.min_threshold, ratio=cfg.matcher.nn_ratio_track)
    want = jmatcher.search_by_area(jax.tree.map(jnp.asarray, prev), jnp.asarray(prev_has),
                                   jax.tree.map(jnp.asarray, cur), jnp.asarray(cur_has),
                                   jnp.float32(z_forward), **kw)
    got = tmatcher.search_by_area(convert.features_to_torch(prev, "cpu"), torch.from_numpy(prev_has),
                                  convert.features_to_torch(cur, "cpu"), torch.from_numpy(cur_has),
                                  torch.tensor(z_forward), **kw)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.dist.numpy(), np.asarray(want.dist))
    assert (np.asarray(want.idx) >= 0).sum() > 50


def test_motion_track_step_on_identical_state(jax_frames):
    cfg_j, cfg_t = odo_cfg(jcfg), odo_cfg(tcfg)
    jcam, tcam = JCam.from_config(cfg_j.camera), TCam.from_config(cfg_t.camera, "cpu")
    Tcw0 = np.array(jse3.exp(jnp.asarray([0.01, -0.02, 0.3, 0.002, -0.01, 0.003], jnp.float32)))
    vel = np.array(jse3.exp(jnp.asarray([0.0, 0.0, -0.33, 0.0, 0.001, 0.0], jnp.float32)))
    last_sf, cur_sf = jax_frames[5], jax_frames[6]
    pw, has = jtr.unproject_frame(jcam, jax.tree.map(jnp.asarray, last_sf), jnp.asarray(Tcw0))
    jlast = jtr.TrackedFrame(jax.tree.map(jnp.asarray, last_sf), jnp.asarray(Tcw0), pw, has)
    tpw, thas = ttr.unproject_frame(tcam, to_t(last_sf), torch.from_numpy(Tcw0))
    np.testing.assert_allclose(tpw.numpy(), np.asarray(pw), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(thas.numpy(), np.asarray(has))
    tlast = ttr.TrackedFrame(to_t(last_sf), torch.from_numpy(Tcw0), tpw, thas)
    common = ttr._step_kw(cfg_t)
    want = jtr.motion_track_step(jcam, jax.tree.map(jnp.asarray, cur_sf), jlast, jnp.asarray(vel),
                                 radius=15.0, **common)
    got = ttr.motion_track_step(tcam, to_t(cur_sf), tlast, torch.from_numpy(vel), radius=15.0, **common)
    assert int(got[1]) == int(want[1]) > 50
    assert int(got[2]) == int(want[2])
    np.testing.assert_array_equal(got[3].idx.numpy(), np.asarray(want[3].idx))
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)


@pytest.fixture(scope="module")
def tracked(frames, jax_frames):
    # a match floor of 80 sends the frames with fewer motion matches through
    # the wide-radius retry (the default 20 never does on this world)
    cfg_j, cfg_t = odo_cfg(jcfg, min_motion_matches=80), odo_cfg(tcfg, min_motion_matches=80)
    jt = jtr.OdometryTracker(cfg_j, JCam.from_config(cfg_j.camera))
    tt = ttr.OdometryTracker(cfg_t, device="cpu")
    fe = tfrontend(cfg_t, "cpu")
    out = dict(j=[], t=[])
    for (l, r, _), jsf in zip(frames, jax_frames):
        out["j"].append((*jt.track(jax.tree.map(jnp.asarray, jsf)), jt.state.name))
        out["t"].append((*tt.track(fe(torch.from_numpy(l), torch.from_numpy(r), tt.cam)), tt.state.name))
    return out


def test_odometry_tracker_matches_jax(tracked, frames):
    for i, ((pj, ij, sj), (pt, it, st)) in enumerate(zip(tracked["j"], tracked["t"])):
        assert st == sj == "OK", i
        assert it.get("wide_retry", False) == ij.get("wide_retry", False), i
        assert it.get("initialized", False) == ij.get("initialized", False), i
        assert abs(it.get("n_inliers", 0) - ij.get("n_inliers", 0)) <= max(5, 0.05 * ij.get("n_inliers", 0)), i
        pose_close(pt, pj)
    retries = [bool(i.get("wide_retry")) for _, i, _ in tracked["t"]]
    assert 0 < sum(retries) < N_FRAMES - 1, retries
    est = [np.linalg.inv(p) for p, _, _ in tracked["t"]]
    gt = [f[2] for f in frames]
    assert ate_rmse(est, gt) < 0.05 * N_FRAMES * SPEED
    assert np.linalg.norm(est[-1][:3, 3] - est[0][:3, 3]) > 0.5 * (N_FRAMES - 1) * SPEED


def test_odometry_tracker_init_gate():
    """Too few stereo depths: NOT_INITING with the count, as in JAX."""
    cfg = odo_cfg(tcfg)
    tt = ttr.OdometryTracker(cfg, device="cpu")
    sf = tfrontend(cfg, "cpu")(torch.zeros(192, 320), torch.zeros(192, 320), tt.cam)
    pose, info = tt.track(sf)
    assert pose is None and info == {"init_depth_kps": 0} and tt.state == ttr.TrackState.NOT_INITING


@pytest.fixture(scope="module")
def fused(frames, jax_frames):
    """Both fused steps over the frames, from the same initial state (the
    JAX frame 0 unprojected at the identity); the port's as the direct
    program and through the eager graph wrapper."""
    cfg_j, cfg_t = odo_cfg(jcfg), odo_cfg(tcfg)
    jcam, tcam = JCam.from_config(cfg_j.camera), TCam.from_config(cfg_t.camera, "cpu")
    jstep = jtr.make_fused_odometry_step(cfg_j)
    pw, has = jtr.unproject_frame(jcam, jax.tree.map(jnp.asarray, jax_frames[0]), jnp.eye(4))
    jlast, jvel = jtr.TrackedFrame(jax.tree.map(jnp.asarray, jax_frames[0]), jnp.eye(4), pw, has), jnp.eye(4)
    direct = ttr.make_fused_odometry_step(cfg_t, "cpu")
    wrapped = StepGraph(ttr.odometry_program(cfg_t, "cpu"), capture=False)
    tpw, thas = ttr.unproject_frame(tcam, to_t(jax_frames[0]), torch.eye(4))
    t0 = (ttr.TrackedFrame(to_t(jax_frames[0]), torch.eye(4), tpw, thas), torch.eye(4))
    (dlast, dvel), (wlast, wvel) = t0, t0
    out = dict(j=[], d=[], w=[])
    for l, r, _ in frames[1:]:
        jlast, jvel, T, nm, ni = jstep(jcam, jnp.asarray(l), jnp.asarray(r), jlast, jvel)
        out["j"].append((np.asarray(T), int(nm), int(ni)))
        tl, tr = torch.from_numpy(l), torch.from_numpy(r)
        res = direct(tcam, tl, tr, dlast, dvel)
        dlast, dvel = res[:2]
        out["d"].append(res)
        res = wrapped(tcam, tl, tr, wlast, wvel)
        wlast, wvel = res[:2]
        out["w"].append(res)
    return out, wrapped


def test_fused_step_matches_jax(fused):
    out, _ = fused
    for (Tj, nmj, nij), (_, _, Tt, nmt, nit) in zip(out["j"], out["d"]):
        pose_close(Tt.numpy(), Tj)
        assert nit >= 30 and abs(int(nit) - nij) <= max(5, 0.05 * nij)


def test_step_graph_wrapper_equals_the_program(fused):
    out, wrapped = fused
    for d, w in zip(out["d"], out["w"]):
        for a, b in zip(tree_leaves(d), tree_leaves(w)):
            assert torch.equal(a, b)
    assert wrapped.captures == 1 and wrapped.replays == N_FRAMES - 1


def test_pose_from_mp_matches_jax(jax_frames):
    """The pose LM over a per-feature map-point table (−1 = none) on the
    same map points, frame and start pose."""
    cfg_j, cfg_t = small_cfg(jcfg), small_cfg(tcfg)
    sf = jax_frames[2]
    r = np.random.default_rng(9)
    jcam = JCam.from_config(cfg_j.camera)
    pw, ok = jtr.unproject_frame(jcam, jax.tree.map(jnp.asarray, sf), jnp.eye(4))
    M = 1024
    mp_pos = r.normal(0, 5, (M, 3)).astype(np.float32)
    cur_mp = np.where(np.asarray(ok) & (r.random(ok.shape) < 0.9), r.permutation(M)[:ok.shape[0]], -1)
    cur_mp = cur_mp.astype(np.int32)
    mp_pos[np.maximum(cur_mp, 0)[cur_mp >= 0]] = np.asarray(pw)[cur_mp >= 0]
    Tcw0 = np.array(jse3.exp(jnp.asarray([0.02, 0.01, -0.03, 0.004, 0.002, -0.003], jnp.float32)))
    jstub = types.SimpleNamespace(map=types.SimpleNamespace(mp_capacity=M, mp_pos=jnp.asarray(mp_pos)),
                                  cfg=cfg_j, cam=jcam)
    want = jsys.SLAM._pose_from_mp(jstub, jax.tree.map(jnp.asarray, sf), jnp.asarray(Tcw0), jnp.asarray(cur_mp))
    tstub = types.SimpleNamespace(_split=False, map=types.SimpleNamespace(mp_pos=torch.from_numpy(mp_pos)),
                                  cfg=cfg_t, cam=TCam.from_config(cfg_t.camera, "cpu"))
    got = tsys.SLAM._pose_from_mp(tstub, to_t(sf), torch.from_numpy(Tcw0), torch.from_numpy(cur_mp))
    assert int(got[2]) == int(want[2]) > 100
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
    np.testing.assert_allclose(got[0].numpy(), np.eye(4), atol=2e-3)   # back to the points' frame


def test_profile_records_every_stage():
    """``time_programs`` on: each stage that ran is a host span of positive
    length inside the ``track`` span of its call (``frontend`` on the first
    frame, the eager frame program as ``dispatch`` on the others, the
    keyframe programs); off: nothing is recorded."""
    cfg = small_cfg(tcfg, synchronous=True)
    ds = TDataset(cfg.camera, n_frames=4, speed=SPEED, device="cpu")
    on = tsys.SLAM(cfg, enable_loop_closing=False, device="cpu")
    on.time_programs = True
    off = tsys.SLAM(cfg, enable_loop_closing=False, device="cpu")
    for i in range(4):
        l, r, _ = ds.frame(i)
        for slam in (on, off):
            slam.track(l, r)
    assert off.tracer.spans == [] and off.program_events == []
    assert on.n_keyframes >= 2
    spans = on.tracer.spans
    st = Counter(s[0] for s in spans)
    assert set(st) == {"track", "upload", "frontend", "dispatch", "fetch_wait", "decide", "map_front",
                       "map_tail"}, set(st)
    assert st["frontend"] == 1 and st["dispatch"] == 3 and st["track"] == st["upload"] == 4
    assert st["map_front"] == st["map_tail"] == on.n_keyframes - 1
    assert all(s[2] > s[1] for s in spans)
    tracks = {s[4]: s for s in spans if s[0] == "track"}
    assert all(tracks[s[4]][1] <= s[1] and s[2] <= tracks[s[4]][2] for s in spans)
