"""Parity of the port's per-camera Schur BA (``BAProblem``, ``_edge_terms``,
``_solve_iteration``, ``_chi2``, ``solve_ba``) with the JAX package's, on the
CPU, on the seeded problems of ``tests/test_schur_ba.py`` (6 cameras, the
first fixed, 64 features each, 128 points).

Tolerances: edge terms and χ² to f32 rounding (1e-4 relative).  One Schur
step in f32 is as close to the same step in f64 as JAX's f32 step is (within
a factor 2, plus 1e-5): with outliers at full weight, or mono points along
their rays, one undamped step is conditioned far beyond f32 in both
packages.  The whole solve: the χ² gate's inlier mask exact; stereo
cameras within 1e-4 m / 1e-3° and points within 1e-3 m of JAX's (15 LM
iterations of f32 solves in another summation order); mono has a free
scale with one fixed camera, so its cameras are compared through the cost
reached (within 1e-3 relative) rather than the poses.  The fixed camera
keeps its bits (the JAX version re-orthonormalizes it, moving it by
rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_schur_ba import build_problem
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

import orb_slam2_ros2_tpu_torch.config as tcfg
from orb_slam2_ros2_tpu.solvers import schur_ba as jsba
from orb_slam2_ros2_tpu_torch.geometry.camera import CameraParams as TCam
from orb_slam2_ros2_tpu_torch.solvers import schur_ba as tsba

POSE_M, POSE_DEG, POINT_M = 1e-4, 1e-3, 1e-3
CAM = dict(fx=400.0, fy=400.0, cx=320.0, cy=240.0, baseline=0.5, width=640, height=480)


def to_torch(prob) -> tsba.BAProblem:
    return tsba.BAProblem(*(torch.from_numpy(np.array(a)) for a in prob))


def assert_poses_close(got: torch.Tensor, want, tol_m=POSE_M, tol_deg=POSE_DEG):
    a, b = got.double().numpy(), np.asarray(want, np.float64)
    dR = a[:, :3, :3] @ np.swapaxes(b[:, :3, :3], 1, 2)
    # the angle from the skew part (2 sin θ), well-conditioned at θ ≈ 0
    w = np.stack([dR[:, 2, 1] - dR[:, 1, 2], dR[:, 0, 2] - dR[:, 2, 0], dR[:, 1, 0] - dR[:, 0, 1]], 1)
    ang = np.degrees(np.arcsin(np.clip(np.linalg.norm(w, axis=1) / 2, 0, 1)))
    ca = -np.einsum("cji,cj->ci", a[:, :3, :3], a[:, :3, 3])
    cb = -np.einsum("cji,cj->ci", b[:, :3, :3], b[:, :3, 3])
    assert np.abs(ca - cb).max() <= tol_m and ang.max() <= tol_deg, (np.abs(ca - cb).max(), ang.max())


@pytest.fixture(scope="module")
def tcam():
    return TCam.from_config(tcfg.CameraConfig(**CAM), "cpu")


@pytest.fixture(scope="module", params=["stereo", "outliers", "mono"])
def solved(request):
    kw = dict(stereo=dict(), outliers=dict(outlier_frac=0.15, pose_noise=0.03),
              mono=dict(stereo=False, pose_noise=0.03))[request.param]
    jcam, jprob, Tcw_gt, pts_gt = build_problem(**kw)
    want = tuple(np.asarray(a) for a in jsba.solve_ba(jcam, jprob))
    return request.param, jcam, jprob, to_torch(jprob), want


def test_edge_terms_and_chi2(solved, tcam):
    _, jcam, jprob, tprob, _ = solved
    want = jsba._edge_terms(jcam, jprob, jprob.cam_Tcw, jprob.pt_pos)
    got = tsba._edge_terms(tcam, tprob, tprob.cam_Tcw, tprob.pt_pos)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max())
    np.testing.assert_allclose(tsba._chi2(tcam, tprob, tprob.cam_Tcw, tprob.pt_pos).numpy(),
                               np.asarray(jsba._chi2(jcam, jprob, jprob.cam_Tcw, jprob.pt_pos)), rtol=1e-4)


def f64(cam, prob):
    return (type(cam)(*(x.double() for x in cam)),
            tsba.BAProblem(*(x.double() if x.is_floating_point() else x for x in prob)))


def centres(T) -> np.ndarray:
    T = np.asarray(T, np.float64)
    return -np.einsum("cji,cj->ci", T[:, :3, :3], T[:, :3, 3])


def test_one_schur_step(solved, tcam):
    _, jcam, jprob, tprob, _ = solved
    w = np.asarray(jprob.edge_valid, np.float32) * np.asarray(jprob.inv_sigma2)
    T_j, p_j = (np.asarray(a, np.float64) for a in jsba._solve_iteration(
        jcam, jprob, jprob.cam_Tcw, jprob.pt_pos, jnp.asarray(w), 1e-3))
    T_t, p_t = tsba._solve_iteration(tcam, tprob, tprob.cam_Tcw, tprob.pt_pos, torch.from_numpy(w),
                                     torch.tensor(1e-3))
    cam64, prob64 = f64(tcam, tprob)
    T_x, p_x = tsba._solve_iteration(cam64, prob64, prob64.cam_Tcw, prob64.pt_pos,
                                     torch.from_numpy(w).double(), torch.tensor(1e-3, dtype=torch.float64))
    T_t, p_t, T_x, p_x = (a.double().numpy() for a in (T_t, p_t, T_x, p_x))
    for got, want, exact in ((centres(T_t), centres(T_j), centres(T_x)), (T_t[:, :3, :3], T_j[:, :3, :3],
                                                                           T_x[:, :3, :3]), (p_t, p_j, p_x)):
        assert np.abs(got - exact).max() <= 2 * np.abs(want - exact).max() + 1e-5


def test_solve_matches_jax_and_converges(solved, tcam):
    case, jcam, jprob, tprob, (T_j, p_j, in_j) = solved
    T_t, p_t, in_t = tsba.solve_ba(tcam, tprob)
    np.testing.assert_array_equal(in_t.numpy(), in_j)
    assert torch.equal(T_t[0], tprob.cam_Tcw[0])          # the fixed camera keeps its bits
    np.testing.assert_allclose(T_j[0], tprob.cam_Tcw[0].numpy(), atol=1e-6)
    v = tprob.edge_valid
    chi = tsba._chi2(tcam, tprob, T_t, p_t)[v].mean()
    chi_j = np.asarray(jsba._chi2(jcam, jprob, jnp.asarray(T_j), jnp.asarray(p_j)))[np.asarray(v)].mean()
    if case == "mono":
        np.testing.assert_allclose(float(chi), chi_j, rtol=1e-3)
    else:
        assert_poses_close(T_t, T_j)
        np.testing.assert_allclose(p_t.numpy(), p_j, atol=POINT_M)
    if case == "outliers":
        n_out = int(tprob.uv.shape[1] * 0.15)
        assert in_t[:, :n_out][v[:, :n_out]].float().mean() < 0.4
    else:
        chi0 = tsba._chi2(tcam, tprob, tprob.cam_Tcw, tprob.pt_pos)[v].mean()
        assert chi < (0.2 if case == "mono" else 0.1) * chi0


def test_empty_problem_no_nan(tcam):
    jcam, jprob, *_ = build_problem()
    prob = to_torch(jprob)._replace(edge_valid=torch.zeros(6, 64, dtype=torch.bool))
    T, p, inl = tsba.solve_ba(tcam, prob)
    assert torch.isfinite(T).all() and torch.isfinite(p).all() and not inl.any()
    T_j, p_j, _ = jsba.solve_ba(jcam, jprob._replace(edge_valid=jnp.zeros_like(jprob.edge_valid)))
    np.testing.assert_allclose(T.numpy(), np.asarray(T_j), atol=1e-6)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_j), atol=1e-6)
