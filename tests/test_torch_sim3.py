"""Parity of the port's Sim(3) algebra and Sim3 solver with the JAX package,
on the CPU: ``geometry/sim3.py`` to 1e-5, ``ransac_sim3`` on the minimal sets
the JAX function drew (equal best score ±2, transform within 1e-3) and
``optimize_sim3`` from the same start (transform within 1e-3, inlier sets
equal up to 2 entries)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_epnp import cams, jax_minimal_sets, rot, t
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

from orb_slam2_ros2_tpu.geometry import se3 as jse3
from orb_slam2_ros2_tpu.geometry import sim3 as jsim3
from orb_slam2_ros2_tpu.solvers import sim3_solver as jsolver
from orb_slam2_ros2_tpu_torch import convert
from orb_slam2_ros2_tpu_torch.geometry import se3 as tse3
from orb_slam2_ros2_tpu_torch.geometry import sim3 as tsim3
from orb_slam2_ros2_tpu_torch.solvers import sim3_solver as tsolver


def to_t(S) -> tsim3.Sim3:
    return convert.sim3_to_torch(jax.tree.map(np.asarray, S), "cpu")


def assert_sim3_close(St, Sj, tol=1e-5):
    for name in ("R", "t", "s"):
        np.testing.assert_allclose(getattr(St, name).numpy(), np.asarray(getattr(Sj, name)),
                                   atol=tol, err_msg=name)


def tangents(r, n):
    """Tangent vectors covering the four (θ small / σ small) regimes of W."""
    xi = r.normal(0, 0.4, (n, 7)).astype(np.float32)
    xi[0] = 0.0
    xi[1, 3:6] = 0.0                # θ = 0, σ large
    xi[2, 6] = 0.0                  # σ = 0, θ large
    xi[3, 3:] = [1e-6, 0, 0, 1e-6]  # both tiny
    xi[4, 6] = -0.7
    return xi


def test_so3_log_matches_jax():
    r = np.random.default_rng(0)
    R = np.stack([rot(r) for _ in range(32)] + [np.eye(3, dtype=np.float32)])
    np.testing.assert_allclose(tse3.so3_log(t(R)).numpy(), np.asarray(jse3.so3_log(jnp.asarray(R))), atol=1e-5)


@pytest.mark.parametrize("op", ["exp", "log", "compose", "inverse", "apply", "se3"])
def test_sim3_algebra_matches_jax(op):
    r = np.random.default_rng(1)
    xa, xb = tangents(r, 24), tangents(r, 24)[::-1].copy()
    Aj, Bj = jsim3.exp(jnp.asarray(xa)), jsim3.exp(jnp.asarray(xb))
    At, Bt = tsim3.exp(t(xa)), tsim3.exp(t(xb))
    p = r.normal(0, 3, (24, 3)).astype(np.float32)
    if op == "exp":
        assert_sim3_close(At, Aj)
    elif op == "log":
        np.testing.assert_allclose(tsim3.log(to_t(Aj)).numpy(), np.asarray(jsim3.log(Aj)), atol=1e-5)
        np.testing.assert_allclose(tsim3.log(At).numpy(), xa, atol=1e-4)
    elif op == "compose":
        assert_sim3_close(tsim3.compose(to_t(Aj), to_t(Bj)), jsim3.compose(Aj, Bj))
    elif op == "inverse":
        assert_sim3_close(tsim3.inverse(to_t(Aj)), jsim3.inverse(Aj))
        ident = tsim3.compose(tsim3.inverse(At), At)
        assert_sim3_close(ident, jsim3.identity((24,)), tol=1e-5)
        assert_sim3_close(tsim3.identity((24,), device="cpu"), jsim3.identity((24,)), tol=0)
    elif op == "apply":
        np.testing.assert_allclose(tsim3.apply(to_t(Aj), t(p)).numpy(),
                                   np.asarray(jsim3.apply(Aj, jnp.asarray(p))), atol=1e-5)
    else:
        T = np.asarray(jse3.exp(jnp.asarray(xa[:, :6])))
        s = np.exp(xa[:, 6])
        assert_sim3_close(tsim3.from_se3(t(T), t(s)), jsim3.from_se3(jnp.asarray(T), jnp.asarray(s)), tol=0)
        assert_sim3_close(tsim3.from_se3(t(T)), jsim3.from_se3(jnp.asarray(T)), tol=0)
        np.testing.assert_allclose(tsim3.to_se3(to_t(Aj)).numpy(), np.asarray(jsim3.to_se3(Aj)), atol=1e-6)


def pair_scene(seed, scale, n=150, outliers=30):
    """Points seen from two cameras related by a similarity, with outliers
    and invalid rows."""
    r = np.random.default_rng(seed)
    pc2 = np.stack([r.uniform(-4, 4, n), r.uniform(-2, 2, n), r.uniform(4, 15, n)], 1).astype(np.float32)
    R = np.asarray(jse3.so3_exp(jnp.asarray([0.05, -0.1, 0.03], jnp.float32)))
    tr = np.array([0.4, -0.1, 0.3], np.float32)
    pc1 = (scale * pc2 @ R.T + tr + r.normal(0, 0.005, (n, 3))).astype(np.float32)
    pc1[:outliers] += r.uniform(1, 3, (outliers, 3)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[-10:] = False
    inv1 = r.uniform(0.5, 1.0, n).astype(np.float32)
    inv2 = r.uniform(0.5, 1.0, n).astype(np.float32)
    return pc1, pc2, valid, inv1, inv2, (R, tr, scale)


@pytest.mark.parametrize("fix_scale,scale", [(True, 1.0), (False, 1.25)], ids=["fixed", "free"])
def test_ransac_and_optimize_sim3_match_jax(fix_scale, scale):
    cam_j, cam_t = cams()
    pc1, pc2, valid, inv1, inv2, (R, tr, s) = pair_scene(4, scale)
    key = jax.random.PRNGKey(3)
    j = [jnp.asarray(a) for a in (pc1, pc2, valid)]
    Sj, inlj, nj = jsolver.ransac_sim3(*j, cam_j, jnp.asarray(inv1), jnp.asarray(inv2), key,
                                       fix_scale=fix_scale)
    sets = jax_minimal_sets(key, valid, min_set=3)
    St, inlt, nt = tsolver.ransac_sim3(t(pc1), t(pc2), t(valid), cam_t, t(inv1), t(inv2),
                                       sets=t(sets), fix_scale=fix_scale)
    assert int(nj) > 60 and abs(int(nt) - int(nj)) <= 2
    assert_sim3_close(St, Sj, tol=1e-3)
    assert (inlt.numpy() != np.asarray(inlj)).sum() <= 2

    So_j, inl_oj, n_oj = jsolver.optimize_sim3(Sj, *j, cam_j, jnp.asarray(inv1), jnp.asarray(inv2),
                                               fix_scale=fix_scale)
    So_t, inl_ot, n_ot = tsolver.optimize_sim3(to_t(Sj), t(pc1), t(pc2), t(valid), cam_t, t(inv1),
                                               t(inv2), fix_scale=fix_scale)
    assert_sim3_close(So_t, So_j, tol=1e-3)
    assert abs(int(n_ot) - int(n_oj)) <= 2 and (inl_ot.numpy() != np.asarray(inl_oj)).sum() <= 2
    assert int(n_ot) >= int(nt)
    np.testing.assert_allclose(So_t.R.numpy(), R, atol=5e-3)
    np.testing.assert_allclose(So_t.t.numpy(), tr, atol=5e-2)
    np.testing.assert_allclose(float(So_t.s), s, atol=1e-2 if not fix_scale else 0)


def test_ransac_sim3_generator_path():
    _, cam_t = cams()
    pc1, pc2, valid, inv1, inv2, _ = pair_scene(5, 1.0)

    def run(seed):
        g = torch.Generator(device="cpu")
        g.manual_seed(seed)
        return tsolver.ransac_sim3(t(pc1), t(pc2), t(valid), cam_t, t(inv1), t(inv2), g)

    (Sa, _, na), (Sb, _, nb) = run(2), run(2)
    assert torch.equal(Sa.R, Sb.R) and int(na) == int(nb) > 60
    with pytest.raises(ValueError):
        tsolver.ransac_sim3(t(pc1), t(pc2), t(valid), cam_t, t(inv1), t(inv2))
