"""Parity of the PyTorch port's tracking modules with the JAX package, on
the CPU, at the small configuration of ``__graft_entry__.entry()``.

State is carried across with ``orb_slam2_ros2_tpu_torch.convert``: the JAX
package initializes a map from a rendered frame, and both packages then run
the same function on the same state.  Tolerances: matcher functions, integer
map fields and local-map ids are exact; poses within 1e-4 m and 1e-4 rad
with equal counts; geometry helpers to f32 rounding; the renderer within 0.5
grey levels.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

import orb_slam2_ros2_tpu.config as jcfg
import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu import utils as jutils
from orb_slam2_ros2_tpu.geometry import camera as jcam
from orb_slam2_ros2_tpu.geometry import se3 as jse3
from orb_slam2_ros2_tpu.io import synthetic as jsyn
from orb_slam2_ros2_tpu.matching import matcher as jm
from orb_slam2_ros2_tpu.pipeline import system as jsys
from orb_slam2_ros2_tpu.solvers import linalg_small as jlin
from orb_slam2_ros2_tpu.solvers import pose_opt as jpo
from orb_slam2_ros2_tpu_torch import convert
from orb_slam2_ros2_tpu_torch import utils as tutils
from orb_slam2_ros2_tpu_torch.geometry import camera as tcam
from orb_slam2_ros2_tpu_torch.geometry import se3 as tse3
from orb_slam2_ros2_tpu_torch.io import synthetic as tsyn
from orb_slam2_ros2_tpu_torch.mapstate import local_map as tlm
from orb_slam2_ros2_tpu_torch.mapstate import map_state as tms
from orb_slam2_ros2_tpu_torch.matching import matcher as tm
from orb_slam2_ros2_tpu_torch.pipeline import system as tsys
from orb_slam2_ros2_tpu_torch.solvers import linalg_small as tlin
from orb_slam2_ros2_tpu_torch.solvers import pose_opt as tpo

POSE_TOL = 1e-4  # metres and radians


def small_cfg(mod):
    """The small configuration of ``__graft_entry__.entry()``."""
    return mod.SLAMConfig(
        camera=mod.CameraConfig(fx=200.0, fy=200.0, cx=160.0, cy=96.0, baseline=0.5,
                                width=320, height=192),
        orb=mod.ORBConfig(n_features=500, max_keypoints=512),
        tracking=mod.TrackingConfig(min_init_depth_kps=150, max_local_mappoints=4096,
                                    max_local_keyframes=16, only_tracking=True),
        map=mod.MapConfig(max_keyframes=64, max_mappoints=16384, max_obs_per_mp=16),
    )


def t(a):
    """numpy → torch on the CPU (uint32 words reinterpreted as int32)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a))


def n(x):
    return np.asarray(x) if not torch.is_tensor(x) else x.numpy()


def pose_close(A, B):
    A, B = np.asarray(A, np.float64), np.asarray(B, np.float64)
    dR = A[:3, :3].T @ B[:3, :3]
    # sin of the relative angle from the skew part (arccos of the trace
    # amplifies f32 rounding to ~1e-4 near zero)
    ang = 0.5 * np.linalg.norm([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]])
    assert np.abs(A[:3, 3] - B[:3, 3]).max() <= POSE_TOL and ang <= POSE_TOL, (A, B)


@pytest.fixture(scope="module")
def jax_world():
    """A JAX SLAM initialized on frame 0, plus the JAX StereoFrame of frame 1."""
    cfg = small_cfg(jcfg)
    ds = jsyn.SyntheticStereoDataset(cfg.camera, n_frames=2, speed=0.35)
    slam = jsys.SLAM(cfg, enable_loop_closing=False)
    slam.track(*ds.frame(0)[:2])
    img_l, img_r, _ = ds.frame(1)
    cur = slam._frontend(img_l, img_r, slam.cam)
    return cfg, slam, cur


# -------------------------------------------------------------- renderer --

@pytest.mark.parametrize("i", [0, 3, 7])
def test_renderer_matches_jax(i):
    cam = small_cfg(jcfg).camera
    jd = jsyn.SyntheticStereoDataset(cam, n_frames=8, speed=0.35)
    td = tsyn.SyntheticStereoDataset(small_cfg(tcfg).camera, n_frames=8, speed=0.35, device="cpu")
    np.testing.assert_array_equal(td.poses_wc, jd.poses_wc)
    jl, jr, _ = jd.frame(i)
    tl, tr, _ = td.frame(i)
    assert np.abs(np.asarray(jl) - tl.numpy()).max() <= 0.5
    assert np.abs(np.asarray(jr) - tr.numpy()).max() <= 0.5


def test_circle_trajectory_matches_jax():
    np.testing.assert_array_equal(tsyn.circle_trajectory(40), jsyn.circle_trajectory(40))


# -------------------------------------------------------------- geometry --

def test_se3_and_small_linalg():
    r = np.random.default_rng(0)
    xi = r.normal(0, 0.3, (16, 6)).astype(np.float32)
    xi[0] = 0.0
    xi[1, 3:] = 1e-5  # series branch
    Tj, Tt = jse3.exp(jnp.asarray(xi)), tse3.exp(t(xi))
    np.testing.assert_allclose(n(Tt), n(Tj), atol=2e-6)
    np.testing.assert_allclose(n(tse3.inverse(Tt)), n(jse3.inverse(Tj)), atol=2e-6)
    np.testing.assert_allclose(n(tse3.normalize(Tt)), n(jse3.normalize(Tj)), atol=2e-6)
    p = r.normal(0, 2, (16, 3)).astype(np.float32)
    np.testing.assert_allclose(n(tse3.apply(Tt, t(p))), n(jse3.apply(Tj, jnp.asarray(p))), atol=1e-5)
    A = r.normal(0, 1, (8, 6, 6)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(6, dtype=np.float32)
    b = r.normal(0, 1, (8, 6)).astype(np.float32)
    np.testing.assert_allclose(n(tlin.cholesky_solve_spd(t(A), t(b))),
                               n(jlin.cholesky_solve_spd(jnp.asarray(A), jnp.asarray(b))), rtol=1e-4, atol=1e-4)
    M3 = r.normal(0, 1, (8, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(n(tlin.inv3(t(M3))), n(jlin.inv3(jnp.asarray(M3))), rtol=1e-4, atol=1e-4)
    R = n(Tj)[:, :3, :3]
    q_t, q_j = tlin.rot_to_quat(t(R)), jlin.rot_to_quat(jnp.asarray(R))
    np.testing.assert_allclose(n(q_t), n(q_j), atol=2e-6)
    np.testing.assert_allclose(n(tlin.quat_to_rot(q_t)), n(jlin.quat_to_rot(q_j)), atol=2e-6)


def test_camera_functions():
    cj = jcfg.CameraConfig(fx=200.0, fy=210.0, cx=160.0, cy=96.0, k1=-0.2, k2=0.05, p1=1e-3, p2=-1e-3)
    ct = tcfg.CameraConfig(**dataclasses.asdict(cj))
    J, T = jcam.CameraParams.from_config(cj), tcam.CameraParams.from_config(ct, "cpu")
    r = np.random.default_rng(1)
    pc = np.concatenate([r.normal(0, 2, (64, 2)), r.uniform(-1, 20, (64, 1))], 1).astype(np.float32)
    uv_j, ok_j = jcam.project(J, jnp.asarray(pc))
    uv_t, ok_t = tcam.project(T, t(pc))
    np.testing.assert_array_equal(n(ok_t), n(ok_j))
    np.testing.assert_allclose(n(uv_t), n(uv_j), rtol=1e-6, atol=1e-4)
    uv = r.uniform(0, 300, (64, 2)).astype(np.float32)
    d = r.uniform(1, 30, 64).astype(np.float32)
    np.testing.assert_allclose(n(tcam.unproject(T, t(uv), t(d))), n(jcam.unproject(J, jnp.asarray(uv), jnp.asarray(d))),
                               rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(n(tcam.undistort_points(T, t(uv))), n(jcam.undistort_points(J, jnp.asarray(uv))),
                               rtol=1e-5, atol=1e-3)


# --------------------------------------------------------------- helpers --

def test_topk_ties_lower_index_first():
    x = np.array([[3, 1, 3, 0, 3, 1], [0, 0, 0, 0, 0, 0]], np.int32)
    for k in (2, 4, 9):
        vj, ij = jutils.topk_bounded(jnp.asarray(x), k)
        vt, it = tutils.topk_bounded(t(x), k)
        np.testing.assert_array_equal(n(vt), n(vj))
        np.testing.assert_array_equal(n(it), n(ij))


def test_argmin_ties_first_index():
    x = t(np.array([[5, 2, 2, 7], [1, 1, 1, 1]], np.int32))
    assert torch.argmin(x, dim=1).tolist() == [1, 0]
    assert torch.argmin(x.T.contiguous(), dim=0).tolist() == [1, 0]


# --------------------------------------------------------------- matcher --

@pytest.mark.parametrize("seed", [0, 1])
def test_match_primitives_exact(seed):
    r = np.random.default_rng(seed)
    Q, T_, N_ = 96, 80, 80
    dist = r.integers(0, 120, (Q, T_)).astype(np.int32)
    dist[:, 10] = dist[:, 11]  # ties
    mask = r.random((Q, T_)) < 0.3
    mj = jm.best_match(jnp.asarray(dist), jnp.asarray(mask), 50, 0.9)
    mt = tm.best_match(t(dist), t(mask), 50, 0.9)
    np.testing.assert_array_equal(n(mt.idx), n(mj.idx))
    np.testing.assert_array_equal(n(mt.dist), n(mj.dist))
    np.testing.assert_array_equal(n(tm.mutual_filter(mt, N_).idx), n(jm.mutual_filter(mj, N_).idx))
    aq = r.uniform(0, 360, Q).astype(np.float32)
    at = (aq + r.choice([0.0, 12.0, 200.0], Q) + r.normal(0, 2, Q)).astype(np.float32)
    found = r.random(Q) < 0.7
    np.testing.assert_array_equal(
        n(tm.rotation_consistency(t(aq), t(at), t(found))),
        n(jm.rotation_consistency(jnp.asarray(aq), jnp.asarray(at), jnp.asarray(found))))


@pytest.mark.parametrize("z_forward", [-1.0, 0.0, 1.0])
def test_area_candidates_and_octaves_exact(z_forward):
    r = np.random.default_rng(4)
    Q, T_ = 64, 90
    qo = r.integers(0, 8, Q).astype(np.int32)
    lo_j, hi_j = jm.forward_backward_octaves(jnp.asarray(qo), jnp.asarray(z_forward, jnp.float32), 0.5, 8)
    lo_t, hi_t = tm.forward_backward_octaves(t(qo), torch.tensor(z_forward), 0.5, 8)
    np.testing.assert_array_equal(n(lo_t), n(lo_j))
    np.testing.assert_array_equal(n(hi_t), n(hi_j))
    fields = dict(
        uv=r.uniform(0, 100, (T_, 2)).astype(np.float32), uv_raw=np.zeros((T_, 2), np.float32),
        octave=r.integers(0, 8, T_).astype(np.int32), response=np.zeros(T_, np.float32),
        angle=np.zeros(T_, np.float32), desc=np.zeros((T_, 8), np.uint32), valid=r.random(T_) < 0.9,
    )
    quv = r.uniform(0, 100, (Q, 2)).astype(np.float32)
    from orb_slam2_ros2_tpu.features.frame import FrameFeatures as JF

    cj = jm.area_candidates(jnp.asarray(quv), jnp.asarray(qo), JF(**{k: jnp.asarray(v) for k, v in fields.items()}),
                            15.0, lo_j, hi_j, 1.2)
    ct = tm.area_candidates(t(quv), t(qo), convert.features_to_torch(fields, "cpu"), 15.0, lo_t, hi_t, 1.2)
    np.testing.assert_array_equal(n(ct), n(cj))


def test_projection_search_exact(jax_world):
    """Local-map projection search on the JAX world's local map against the
    frame-1 features: visibility, predicted levels and matches equal."""
    cfg, slam, cur = jax_world
    c, o = cfg.camera, cfg.orb
    local = jax.tree.map(np.asarray, slam.local)
    Tcw = np.asarray(jse3.exp(jnp.asarray([0.0, 0.0, -0.35, 0.0, 0.0, 0.0], jnp.float32)))
    kw = dict(width=c.width, height=c.height, scale_factor=o.scale_factor, n_levels=o.n_levels)
    args_j = [jnp.asarray(local[i]) for i in (1, 2, 4, 5)]
    vis_j = jm.mappoint_visibility(slam.cam, jnp.asarray(Tcw), *args_j, **kw)
    tcam_ = tcam.CameraParams.from_config(small_cfg(tcfg).camera, "cpu")
    tloc = convert.local_map_to_torch(local, "cpu")
    vis_t = tm.mappoint_visibility(tcam_, t(Tcw), tloc.pos, tloc.normal, tloc.min_dist, tloc.max_dist, **kw)
    for a, b in zip(vis_t[1:3], vis_j[1:3]):
        np.testing.assert_array_equal(n(a), n(b))
    np.testing.assert_allclose(n(vis_t[0]), n(vis_j[0]), atol=1e-3)
    curj = jax.tree.map(np.asarray, cur)
    has = np.zeros(curj.feats.uv.shape[0], bool)
    has[::7] = True
    mj = jm.search_mappoints_projection(
        slam.cam, jnp.asarray(Tcw), *args_j, jnp.asarray(local.desc), jnp.asarray(local.valid),
        jax.tree.map(jnp.asarray, curj.feats), jnp.asarray(has), th=3.0, max_dist=50, ratio=0.8, **kw)
    mt = tm.search_mappoints_projection(
        tcam_, t(Tcw), tloc.pos, tloc.normal, tloc.min_dist, tloc.max_dist, tloc.desc, tloc.valid,
        convert.features_to_torch(curj.feats, "cpu"), t(has), th=3.0, max_dist=50, ratio=0.8, **kw)
    assert int((n(mj.idx) >= 0).sum()) > 20
    np.testing.assert_array_equal(n(mt.idx), n(mj.idx))


# ------------------------------------------------------------- pose opt --

def test_optimize_pose_parity():
    """Noisy stereo/mono observations of known points with 15% gross
    outliers: both optimizers land on the same pose and inlier set."""
    r = np.random.default_rng(9)
    cfgc = small_cfg(jcfg).camera
    Jc, Tc = jcam.CameraParams.from_config(cfgc), tcam.CameraParams.from_config(small_cfg(tcfg).camera, "cpu")
    M = 300
    T_true = np.asarray(jse3.exp(jnp.asarray([0.1, -0.05, 0.3, 0.02, -0.03, 0.01], jnp.float32)))
    pw = np.stack([r.uniform(-4, 4, M), r.uniform(-2, 2, M), r.uniform(3, 20, M)], 1).astype(np.float32)
    pc = pw @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([cfgc.fx * pc[:, 0] / pc[:, 2] + cfgc.cx, cfgc.fy * pc[:, 1] / pc[:, 2] + cfgc.cy], 1)
    ru = uv[:, 0] - cfgc.bf / pc[:, 2]
    uv = (uv + r.normal(0, 0.7, uv.shape)).astype(np.float32)
    ru = (ru + r.normal(0, 0.7, M)).astype(np.float32)
    out = r.random(M) < 0.15
    uv[out] += r.uniform(-40, 40, (out.sum(), 2)).astype(np.float32)
    octave = r.integers(0, 4, M).astype(np.int32)
    stereo = r.random(M) < 0.6
    obs = dict(pw=pw, uv=uv, right_u=np.where(stereo, ru, -1).astype(np.float32),
               inv_sigma2=(1.0 / 1.44 ** octave).astype(np.float32), is_stereo=stereo,
               valid=r.random(M) < 0.95)
    T0 = np.eye(4, dtype=np.float32)
    Tj, inl_j, nj = jpo.optimize_pose(Jc, jnp.asarray(T0), jpo.PoseObs(**{k: jnp.asarray(v) for k, v in obs.items()}),
                                      rounds=4, iters_per_round=4)
    Tt, inl_t, nt = tpo.optimize_pose(Tc, t(T0), tpo.PoseObs(**{k: t(v) for k, v in obs.items()}),
                                      rounds=4, iters_per_round=4)
    pose_close(n(Tt), n(Tj))
    assert int(nt) == int(nj)
    np.testing.assert_array_equal(n(inl_t), n(inl_j))
    assert np.abs(n(Tt)[:3, 3] - T_true[:3, 3]).max() < 0.05


# ------------------------------------------------------------- map state --

def test_insert_keyframe_and_snapshot_parity(jax_world):
    """Port insert_keyframe on the JAX frame-0 StereoFrame: integer fields
    and local-map ids equal the JAX map's, floats to f32 rounding."""
    cfg, slam, _ = jax_world
    o, c, t_ = cfg.orb, cfg.camera, cfg.tracking
    frame0 = convert.stereo_frame_to_torch(jax.tree.map(np.asarray, slam.last.frame), "cpu")
    tmap = tms.empty_map(small_cfg(tcfg), "cpu")
    tcam_ = tcam.CameraParams.from_config(small_cfg(tcfg).camera, "cpu")
    st, kf = tms.insert_keyframe(
        tmap, frame0, torch.eye(4), torch.full((o.max_keypoints,), -1, dtype=torch.int32), 0, tcam_,
        depth_threshold=c.baseline * t_.th_depth, scale_factor=o.scale_factor, n_levels=o.n_levels,
        min_covis_weight=cfg.mapping.min_covis_weight, seed_floor=cfg.mapping.seed_far_floor)
    assert int(kf) == 0
    want = jax.tree.map(np.asarray, slam.map)
    got = convert.to_numpy(st)
    for name in tms.MapState._fields:
        w, g = getattr(want, name), got[name]
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    loc = tlm.local_map_snapshot(st, 0, max_kfs=t_.max_local_keyframes, max_mps=t_.max_local_mappoints)
    wl = jax.tree.map(np.asarray, slam.local)
    for name in ("mp_ids", "valid", "kf_ids", "kf_mask", "desc"):
        np.testing.assert_array_equal(convert.to_numpy(loc)[name], getattr(wl, name), err_msg=name)


def test_convert_round_trip(jax_world):
    _, slam, _ = jax_world
    want = jax.tree.map(np.asarray, slam.map)
    got = convert.to_numpy(convert.map_state_to_torch(want, "cpu"))
    for name in tms.MapState._fields:
        assert got[name].dtype == getattr(want, name).dtype, name
        np.testing.assert_array_equal(got[name], getattr(want, name))


# -------------------------------------------------------- tracking step --

def test_slam_track_step_parity(jax_world):
    """Both slam_track_steps on the same converted state (JAX frame-1
    StereoFrame, JAX last frame, local map and map points)."""
    cfg, slam, cur = jax_world
    o, c, m, t_, b = cfg.orb, cfg.camera, cfg.matcher, cfg.tracking, cfg.ba
    common = dict(
        radius=t_.motion_search_radius, scale_factor=o.scale_factor, n_levels=o.n_levels,
        baseline=c.baseline, width=c.width, height=c.height, max_dist=m.min_threshold,
        ratio_track=m.nn_ratio_track, chi2_mono=b.chi2_mono, chi2_stereo=b.chi2_stereo,
        depth_threshold=c.baseline * t_.th_depth, min_motion_matches=t_.min_motion_matches,
        pose_rounds=b.pose_rounds, pose_iters=b.pose_iters_per_round, proj_th=3.0,
    )
    step_j = jax.jit(partial(jsys.slam_track_step, **common))
    vel = jnp.eye(4, dtype=jnp.float32)
    ns_j, vel_j, hv_j, vis_j, found_j = step_j(
        slam.cam, cur, slam.last, vel, slam.local, slam.map.mp_pos, slam.map.mp_valid)
    npt = lambda x: jax.tree.map(np.asarray, x)  # noqa: E731
    tcam_ = tcam.CameraParams.from_config(small_cfg(tcfg).camera, "cpu")
    ns_t, vel_t, hv_t, vis_t, found_t = tsys.slam_track_step(
        tcam_, convert.stereo_frame_to_torch(npt(cur), "cpu"),
        convert.slam_frame_to_torch(npt(slam.last), "cpu"), torch.eye(4),
        convert.local_map_to_torch(npt(slam.local), "cpu"),
        t(slam.map.mp_pos), t(slam.map.mp_valid), **common)
    hv_j, hv_t = np.asarray(hv_j), hv_t.numpy()
    assert hv_j[3] > 30  # n_tracked: the step really tracked
    np.testing.assert_array_equal(hv_t[:7], hv_j[:7])
    pose_close(hv_t[7:].reshape(4, 4), hv_j[7:].reshape(4, 4))
    np.testing.assert_array_equal(ns_t.mp_ids.numpy(), np.asarray(ns_j.mp_ids))
    np.testing.assert_array_equal(vis_t.numpy(), np.asarray(vis_j))
    np.testing.assert_array_equal(found_t.numpy(), np.asarray(found_j))


@pytest.mark.parametrize("stop_after", ["match1", "opt1", "match2", "vis", "opt2"])
def test_slam_track_step_truncations_match_jax(jax_world, stop_after):
    """``slam_track_step(stop_after=...)`` (the stage profile's
    truncations) returns what the JAX step returns at each point: matches,
    masks and counts exact, poses within ``POSE_TOL``."""
    cfg, slam, cur = jax_world
    o, c, m, t_, b = cfg.orb, cfg.camera, cfg.matcher, cfg.tracking, cfg.ba
    common = dict(
        radius=t_.motion_search_radius, scale_factor=o.scale_factor, n_levels=o.n_levels,
        baseline=c.baseline, width=c.width, height=c.height, max_dist=m.min_threshold,
        ratio_track=m.nn_ratio_track, chi2_mono=b.chi2_mono, chi2_stereo=b.chi2_stereo,
        depth_threshold=c.baseline * t_.th_depth, min_motion_matches=t_.min_motion_matches,
        pose_rounds=b.pose_rounds, pose_iters=b.pose_iters_per_round, proj_th=3.0, stop_after=stop_after,
    )
    out_j = jax.jit(partial(jsys.slam_track_step, **common))(
        slam.cam, cur, slam.last, jnp.eye(4, dtype=jnp.float32), slam.local, slam.map.mp_pos, slam.map.mp_valid)
    npt = lambda x: jax.tree.map(np.asarray, x)  # noqa: E731
    tcam_ = tcam.CameraParams.from_config(small_cfg(tcfg).camera, "cpu")
    out_t = tsys.slam_track_step(
        tcam_, convert.stereo_frame_to_torch(npt(cur), "cpu"),
        convert.slam_frame_to_torch(npt(slam.last), "cpu"), torch.eye(4),
        convert.local_map_to_torch(npt(slam.local), "cpu"),
        t(slam.map.mp_pos), t(slam.map.mp_valid), **common)
    if stop_after in ("match1", "match2"):
        assert int((n(out_t.idx) >= 0).sum()) > 10   # the step really matched
        np.testing.assert_array_equal(n(out_t.idx), n(out_j.idx))
        np.testing.assert_array_equal(n(out_t.dist), n(out_j.dist))
    elif stop_after == "vis":
        assert n(out_t).any()
        np.testing.assert_array_equal(n(out_t), n(out_j))
    else:
        pose_close(n(out_t[0]), n(out_j[0]))
        assert [int(x) for x in out_t[1:]] == [int(x) for x in out_j[1:]]
        assert int(out_t[1]) > 30


def test_slam_track_step_refuses_an_unknown_stop():
    with pytest.raises(ValueError, match="stop_after"):
        tsys.slam_track_step(None, None, None, None, None, None, None, radius=1.0, proj_th=3.0,
                             scale_factor=1.2, n_levels=8, baseline=0.5, width=1, height=1, max_dist=50,
                             ratio_track=0.9, chi2_mono=5.991, chi2_stereo=7.815, depth_threshold=1.0,
                             min_motion_matches=20, stop_after="stage9")
