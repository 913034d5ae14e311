"""Parity of the port's local bundle adjustment with the JAX package's, on the
CPU, at the small mapping configuration of ``tests/test_slam_e2e.py``.

``edge_fm`` runs on seeded random edge planes; the window extraction, the
per-point Schur engine and ``local_ba`` run on the map the JAX ``SLAM``
built (the fixture of ``tests/test_torch_mapping.py``), at the input of its
final deferred tail.  Tolerances: edge terms and reductions to f32 rounding
(rtol 1e-4); the window's integer fields exact and its gathers bit-equal;
one Gauss-Newton step within 1e-4 for pose entries and 5 mm for points;
the full solve and ``local_ba`` within 1 mm / 0.01° for poses and 5 mm for
points, with equal integer tables (with injected outliers, 90% of the points
within 5 mm).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mapping import (  # noqa: F401  (two_torch_threads is autouse)
    assert_maps_agree, rot_deg, run_jax_mapping, small_cfg, to_torch, two_torch_threads)

import orb_slam2_ros2_tpu.config as jcfg
import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu.geometry import camera as jcam
from orb_slam2_ros2_tpu.solvers import edge_fm as jefm
from orb_slam2_ros2_tpu.solvers import local_ba as jlba
from orb_slam2_ros2_tpu.solvers import pcg_ba as jpcg
from orb_slam2_ros2_tpu.solvers import schur_ba as jschur
from orb_slam2_ros2_tpu_torch.geometry import camera as tcam
from orb_slam2_ros2_tpu_torch.solvers import edge_fm as tefm
from orb_slam2_ros2_tpu_torch.solvers import local_ba as tlba
from orb_slam2_ros2_tpu_torch.solvers import pcg_ba as tpcg
from orb_slam2_ros2_tpu_torch.solvers import schur_ba as tschur


def t(a):
    return torch.from_numpy(np.array(a))


def close(a, b, rtol=1e-4):
    """Elementwise agreement relative to the magnitude of ``b``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * max(np.abs(b).max(), 1e-6))


@pytest.fixture(scope="module")
def cams():
    return (jcam.CameraParams.from_config(small_cfg(jcfg).camera),
            tcam.CameraParams.from_config(small_cfg(tcfg).camera, "cpu"))


# --------------------------------------------------------------- edge_fm --

@pytest.fixture(scope="module")
def planes():
    """Random feature-major edge planes over E = [4, 96]: rotations near
    identity, points 2-20 m ahead, half the edges stereo."""
    r = np.random.default_rng(0)
    E = (4, 96)
    phi = r.normal(0, 0.1, (3,) + E)
    R = np.zeros((9,) + E)
    for i in range(E[0]):
        for j in range(E[1]):
            w = phi[:, i, j]
            K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
            R[:, i, j] = (np.eye(3) + K + 0.5 * K @ K).reshape(9)
    pw = np.stack([r.uniform(-3, 3, E), r.uniform(-2, 2, E), r.uniform(2, 20, E)])
    uv = np.stack([r.uniform(0, 320, E), r.uniform(0, 192, E)])
    right_u = np.where(r.random(E) < 0.5, uv[0] - r.uniform(1, 20, E), -1.0)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(R9=f32(R), t3=f32(r.normal(0, 0.3, (3,) + E)), pw3=f32(pw), uv2=f32(uv),
                right_u=f32(right_u), inv_sigma2=f32(1.2 ** (-2.0 * r.integers(0, 8, E))),
                w=f32(r.uniform(0, 2, E)))


def test_edge_terms_and_chi2_match_jax(cams, planes):
    args = [planes[k] for k in ("R9", "t3", "pw3", "uv2", "right_u", "inv_sigma2")]
    jt = jefm.edge_terms(cams[0], *args)
    tt = tefm.edge_terms(cams[1], *map(t, args))
    for name in jt._fields:
        close(getattr(tt, name).numpy(), getattr(jt, name))
    close(tefm.edge_chi2(cams[1], *map(t, args)).numpy(), jefm.edge_chi2(cams[0], *args))


@pytest.mark.parametrize("reduce_axis", [0, 1, None])
def test_edge_reductions_match_jax(cams, planes, reduce_axis):
    args = [planes[k] for k in ("R9", "t3", "pw3", "uv2", "right_u", "inv_sigma2")]
    jt, tt = jefm.edge_terms(cams[0], *args), tefm.edge_terms(cams[1], *map(t, args))
    w = planes["w"]
    pairs = [(jefm.hcc_comps, tefm.hcc_comps), (jefm.bc_comps, tefm.bc_comps)]
    if reduce_axis is not None:
        pairs += [(jefm.hpp_comps, tefm.hpp_comps), (jefm.bp_comps, tefm.bp_comps)]
    for jf, tf in pairs:
        close(tf(tt, t(w), reduce_axis=reduce_axis).numpy(), jf(jt, w, reduce_axis=reduce_axis))
    close(tefm.g_comps(tt, t(w)).numpy(), jefm.g_comps(jt, w))


def test_small_symmetric_helpers_match_jax():
    r = np.random.default_rng(1)
    A = r.normal(0, 1, (64, 3, 3))
    S3 = (A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3)).astype(np.float32)
    c3 = np.stack([S3[:, a, b] for a, b in jefm.SYM3])
    c3[:, :2] = 0.0  # singular: the clamped determinant
    B = r.normal(0, 1, (64, 6, 6))
    S6 = (B @ B.transpose(0, 2, 1)).astype(np.float32)
    c6 = np.stack([S6[:, a, b] for a in range(6) for b in range(a, 6)])
    v3, v6 = (r.normal(0, 1, (k, 64)).astype(np.float32) for k in (3, 6))
    G = r.normal(0, 1, (18, 64)).astype(np.float32)
    close(tefm.sym3_inv(t(c3)).numpy(), jefm.sym3_inv(c3))
    close(tefm.sym3_apply(t(c3), t(v3)).numpy(), jefm.sym3_apply(c3, v3))
    close(tefm.sym6_apply(t(c6), t(v6)).numpy(), jefm.sym6_apply(c6, v6))
    np.testing.assert_array_equal(tefm.sym6_to_dense(t(c6)).numpy(), np.asarray(jefm.sym6_to_dense(c6)))
    close(tefm.gT_apply(t(G), t(v6)).numpy(), jefm.gT_apply(G, v6))
    close(tefm.g_apply(t(G), t(v3)).numpy(), jefm.g_apply(G, v3))


# ----------------------------------------------- the window and the solver --

@pytest.fixture(scope="module")
def world(cams):
    cfg_j, cfg_t = small_cfg(jcfg), small_cfg(tcfg)
    slam, P, rec = run_jax_mapping(cfg_j)
    b = cfg_t.ba
    win = dict(max_free=b.max_local_ba_kfs, max_fixed=b.max_local_ba_fixed,
               max_points=b.local_ba_points, scale_factor=cfg_t.orb.scale_factor)
    jwin = jax.jit(partial(jlba.extract_window_points, **win))(rec["tail"], jnp.int32(rec["kf"]))
    twin = tlba.extract_window_points(to_torch(rec["tail"]), rec["kf"], **win)
    return dict(cfg=cfg_t, P=P, rec=rec, jwin=jwin, twin=twin)


def test_extract_window_points_matches_jax(world):
    (jp, *jids), (tp, *tids) = world["jwin"], world["twin"]
    for a, b in zip(tids, jids):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for name in jp._fields:
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)), err_msg=name)
    assert tp.cam_free.sum() >= 3 and tp.pt_valid.sum() > 200  # a real window


def test_chi2_point_matches_jax(cams, world):
    jp, tp = world["jwin"][0], world["twin"][0]
    jc = jpcg._chi2_point(cams[0], jp, jp.cam_Tcw, jp.pt_pos)
    tc = tpcg._chi2_point(cams[1], tp, tp.cam_Tcw, tp.pt_pos)
    v = np.asarray(jp.obs_valid)
    close(tc.numpy()[v], np.asarray(jc)[v])


def test_schur_step_matches_jax(cams, world):
    """``_to_fm``, ``_fm_edge_terms`` and one dense-Schur step with the
    information weights."""
    jp, tp = world["jwin"][0], world["twin"][0]
    jfm, tfm = jschur._to_fm(jp), tschur._to_fm(tp)
    for name in jfm._fields:
        np.testing.assert_array_equal(getattr(tfm, name).numpy(), np.asarray(getattr(jfm, name)), err_msg=name)
    jt = jschur._fm_edge_terms(cams[0], jfm, jp.cam_Tcw, jp.pt_pos)
    tt = tschur._fm_edge_terms(cams[1], tfm, tp.cam_Tcw, tp.pt_pos)
    v = np.asarray(jfm.valid)
    for name in jt._fields:
        close(getattr(tt, name).numpy()[..., v], np.asarray(getattr(jt, name))[..., v])

    w = np.asarray(jfm.valid, np.float32) * np.asarray(jfm.inv_sigma2)
    lam = 1e-3
    jT, jP = jax.jit(jschur._solve_iteration_points)(cams[0], jp, jfm, jp.cam_Tcw, jp.pt_pos, w, lam)
    tT, tP = tschur._solve_iteration_points(cams[1], tp, tfm, tp.cam_Tcw, tp.pt_pos, t(w),
                                            torch.tensor(lam))
    free = np.asarray(jp.cam_free)
    assert np.abs(np.asarray(jT) - np.asarray(jp.cam_Tcw))[free].max() > 1e-6  # the step moved
    np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-4)
    pv = np.asarray(jp.pt_valid)
    np.testing.assert_allclose(tP.numpy()[pv], np.asarray(jP)[pv], atol=5e-3)


def _torch_local_ba(world, state, kf):
    cfg = world["cfg"]
    b = cfg.ba
    cam = tcam.CameraParams.from_config(cfg.camera, "cpu")
    return tlba.local_ba(state, kf, cam, max_free=b.max_local_ba_kfs, max_fixed=b.max_local_ba_fixed,
                         max_points=b.local_ba_points, chi2_mono=b.chi2_mono, chi2_stereo=b.chi2_stereo,
                         lam=b.lm_lambda_init, scale_factor=cfg.orb.scale_factor,
                         phase_iters=tuple(b.local_ba_phase_iters))


def test_solve_ba_points_matches_jax(cams, world):
    """The two-phase robust LM with step acceptance on the device, against
    the JAX solution that the JAX run's final local BA wrote back (read
    through the window's ids); the inlier gate against the χ² of that
    solution."""
    b = world["cfg"].ba
    kw = dict(chi2_mono=b.chi2_mono, chi2_stereo=b.chi2_stereo,
              phase_iters=tuple(b.local_ba_phase_iters), lam=b.lm_lambda_init)
    (jp, cam_ids, pt_ids, _, _), tp = world["jwin"], world["twin"][0]
    after = world["rec"]["local_ba"]
    free, pv = np.asarray(jp.cam_free), np.asarray(jp.pt_valid)
    jT = np.where(free[:, None, None], np.asarray(after.kf_Tcw)[np.maximum(cam_ids, 0)], jp.cam_Tcw)
    jP = np.where(pv[:, None], np.asarray(after.mp_pos)[np.maximum(pt_ids, 0)], jp.pt_pos)
    tT, tP, tin = tschur.solve_ba_points(cams[1], tp, **kw)
    assert np.abs(tT.numpy()[free, :3, 3] - jT[free, :3, 3]).max() <= 1e-3
    assert rot_deg(tT.numpy()[free], jT[free]).max() <= 0.01
    assert np.abs(tP.numpy()[pv] - jP[pv]).max() <= 5e-3
    chi2 = np.asarray(jax.jit(jpcg._chi2_point)(cams[0], jp, jT, jP))
    th = np.where(np.asarray(jp.obs_right_u) > 0, b.chi2_stereo, b.chi2_mono)
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jp.obs_valid) & (chi2 < th))


@pytest.mark.parametrize("outliers", [False, True])
def test_local_ba_matches_jax(cams, world, outliers):
    """``local_ba`` on the tail's input state, against the JAX run's final
    local BA; with ``outliers`` every fifth observed feature of the new
    keyframe is first moved 12 px, so that the removal of observations at
    twice the χ² gate has work to do."""
    rec = world["rec"]
    state, kf, jout = rec["tail"], rec["kf"], rec["local_ba"]
    moved = 0
    if outliers:
        obs = np.flatnonzero(np.asarray(state.kf_mp_idx[kf]) >= 0)[::5]
        state = state._replace(kf_uv=state.kf_uv.at[kf, obs, 0].add(12.0))
        moved = len(obs)
        jout = world["P"]["local_ba"](state, jnp.int32(kf), cams[0])
    runs = tlba.local_ba_runs
    tout = _torch_local_ba(world, to_torch(state), kf)
    assert tlba.local_ba_runs == runs + 1
    removed = int(np.asarray(state.mp_n_obs).sum() - np.asarray(jout.mp_n_obs).sum())
    assert removed >= moved // 2
    # with outliers, the points left with one or two observations are
    # ill-conditioned along their rays and follow the f32 LM path
    assert_maps_agree(jout, tout, point_quantile=0.9 if outliers else 1.0)
