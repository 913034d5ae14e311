"""Parity of the port's Sim(3) pose graph (``solvers/pose_graph.py``) with
the JAX package's, on the CPU.

* residuals to 1e-5 and both Jacobians (forward-mode ``jvp`` in the port,
  ``jax.jacfwd`` in JAX) to 1e-4 + 1e-3 relative, with fixed vertices and
  invalid edges masked alike;
* one dense and one PCG Gauss-Newton step from the same start to 1e-4;
* ``optimize_pose_graph`` (20 iterations) on the drift chain of
  ``tests/test_sim3_posegraph.py:73-106``, through the dense route and the
  PCG route (``dense_max_k=0``), to 2e-3 of the JAX poses — the budget of
  f32 rounding over 20 iterations whose sums run in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)

from orb_slam2_ros2_tpu.geometry import se3 as jse3
from orb_slam2_ros2_tpu.geometry import sim3 as jsim3
from orb_slam2_ros2_tpu.solvers import pose_graph as jpg
from orb_slam2_ros2_tpu_torch import convert
from orb_slam2_ros2_tpu_torch.geometry import sim3 as tsim3
from orb_slam2_ros2_tpu_torch.solvers import pose_graph as tpg


def to_t(prob) -> tpg.PoseGraphProblem:
    return convert.pose_graph_problem_to_torch(jax.tree.map(np.asarray, prob), "cpu")


def se3_of(S) -> np.ndarray:
    """SE3 [K, 4, 4] of a Sim3 of either package (translation over scale)."""
    if isinstance(S, tsim3.Sim3):
        return tsim3.to_se3(S).numpy()
    return np.asarray(jsim3.to_se3(S))


def drift_chain(K=24, seed=3):
    """Chain of K poses with accumulated odometry drift, plus a loop edge
    from the last back to the first carrying the TRUE relative pose; vertex
    0 fixed."""
    r = np.random.default_rng(seed)
    step = np.asarray(jse3.exp(jnp.asarray([0.5, 0, 0.05, 0, 0.26, 0], jnp.float32)))
    gt, est = [np.eye(4, dtype=np.float32)], [np.eye(4, dtype=np.float32)]
    for _ in range(1, K):
        gt.append((step @ gt[-1]).astype(np.float32))
        noise = np.asarray(jse3.exp(jnp.asarray(np.concatenate([r.normal(0, 0.02, 3), r.normal(0, 0.005, 3)]),
                                                jnp.float32)))
        est.append((step @ noise @ est[-1]).astype(np.float32))
    gt, est = np.stack(gt), np.stack(est)
    S_est = jsim3.from_se3(jnp.asarray(est))
    ei = jnp.asarray(list(range(K - 1)) + [0], jnp.int32)
    ej = jnp.asarray(list(range(1, K)) + [K - 1], jnp.int32)
    S_meas = jpg.make_relative_measurements(S_est, ei, ej)
    true_rel = jpg.make_relative_measurements(jsim3.from_se3(jnp.asarray(gt)), jnp.asarray([0]),
                                              jnp.asarray([K - 1]))
    S_meas = jsim3.Sim3(R=S_meas.R.at[-1].set(true_rel.R[0]), t=S_meas.t.at[-1].set(true_rel.t[0]),
                        s=S_meas.s.at[-1].set(true_rel.s[0]))
    prob = jpg.PoseGraphProblem(
        S_cw=S_est, kf_valid=jnp.ones(K, bool), kf_fixed=jnp.zeros(K, bool).at[0].set(True),
        edge_i=ei, edge_j=ej, edge_Sji=S_meas, edge_valid=jnp.ones(K, bool), edge_weight=jnp.ones(K),
    )
    return prob, gt, est


def random_graph(seed=0, K=12, E=40):
    """Random Sim3 vertices (scales 0.5-2) and measurements, covering the
    small-angle branches; one fixed vertex, two invalid edges, weights
    other than 1."""
    r = np.random.default_rng(seed)
    xi = r.normal(0, 0.5, (K, 7)).astype(np.float32)
    xi[0, 3:] = 0.0                      # θ = 0, σ = 0
    xi[1, 6] = 0.0                       # σ = 0
    xm = r.normal(0, 0.3, (E, 7)).astype(np.float32)
    xm[:4] = 0.0                         # identity measurements
    ei = r.integers(0, K, E).astype(np.int32)
    ej = ((ei + 1 + r.integers(0, K - 1, E)) % K).astype(np.int32)
    valid = np.ones(E, bool)
    valid[[5, 9]] = False
    return jpg.PoseGraphProblem(
        S_cw=jsim3.exp(jnp.asarray(xi)), kf_valid=jnp.asarray(np.arange(K) != 7),
        kf_fixed=jnp.asarray(np.arange(K) == 2), edge_i=jnp.asarray(ei), edge_j=jnp.asarray(ej),
        edge_Sji=jsim3.exp(jnp.asarray(xm)), edge_valid=jnp.asarray(valid),
        edge_weight=jnp.asarray(r.uniform(0.5, 2.0, E).astype(np.float32)),
    )


def test_make_relative_measurements_matches_jax():
    prob = random_graph(1)
    S_j = jpg.make_relative_measurements(prob.S_cw, prob.edge_i, prob.edge_j)
    tp = to_t(prob)
    S_t = tpg.make_relative_measurements(tp.S_cw, tp.edge_i, tp.edge_j)
    for name in ("R", "t", "s"):
        np.testing.assert_allclose(getattr(S_t, name).numpy(), np.asarray(getattr(S_j, name)), atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_linearize_matches_jax_jacfwd(seed):
    """Residuals and both Jacobians of every edge, masked alike."""
    prob = random_graph(seed)
    rj, Jij, Jjj, wj = jax.jit(jpg._linearize)(prob, prob.S_cw)
    tp = to_t(prob)
    rt, Jit, Jjt, wt = tpg._linearize(tp, tp.S_cw)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-5)
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    for Jt, Jj in ((Jit, Jij), (Jjt, Jjj)):
        Jj = np.asarray(Jj)
        assert np.abs(Jj).max() > 0.5
        np.testing.assert_allclose(Jt.numpy(), Jj, atol=1e-4, rtol=1e-3)
    # a fixed endpoint or an invalid edge has a zero block
    fixed_i = np.asarray(prob.kf_fixed)[np.asarray(prob.edge_i)] | ~np.asarray(prob.edge_valid)
    assert fixed_i.any() and not Jit.numpy()[fixed_i].any()


@pytest.mark.parametrize("route", ["dense", "pcg"])
def test_one_gn_step_matches_jax(route):
    prob, _, _ = drift_chain()
    tp = to_t(prob)
    if route == "dense":
        Sj = jax.jit(jpg._gn_step_dense, static_argnums=2)(prob, prob.S_cw, 1e-6)
        St = tpg._gn_step_dense(tp, tp.S_cw, 1e-6)
    else:
        Sj = jax.jit(jpg._gn_step_pcg, static_argnums=(2, 3))(prob, prob.S_cw, 1e-6, 150)
        St = tpg._gn_step_pcg(tp, tp.S_cw, 1e-6, 150)
    moved = np.abs(se3_of(Sj) - np.asarray(jsim3.to_se3(prob.S_cw))).max()
    assert moved > 1e-2
    np.testing.assert_allclose(se3_of(St), se3_of(Sj), atol=1e-4)


@pytest.mark.parametrize("route", ["dense", "pcg"])
def test_optimize_pose_graph_matches_jax(route):
    """The drift chain through both solver routes: the port lands on the
    JAX solution, spreads the drift and leaves the fixed vertex alone."""
    prob, gt, est = drift_chain()
    kw = dict(iters=20) if route == "dense" else dict(iters=20, dense_max_k=0)
    Sj = jax.jit(lambda p: jpg.optimize_pose_graph(p, **kw))(prob)
    St = tpg.optimize_pose_graph(to_t(prob), **kw)
    Tj, Tt = se3_of(Sj), se3_of(St)
    np.testing.assert_allclose(Tt, Tj, atol=2e-3)
    drift_before = np.linalg.norm(est[-1][:3, 3] - gt[-1][:3, 3])
    drift_after = np.linalg.norm(Tt[-1][:3, 3] - gt[-1][:3, 3])
    assert drift_after < 0.35 * drift_before, (drift_before, drift_after)
    np.testing.assert_allclose(Tt[0], est[0], atol=1e-5)


def test_pcg_route_freezes_at_the_cg_tolerance():
    """With more CG iterations than the solve needs, the frozen iterate
    equals the one at the smaller count (the CG stopped on its tolerance)."""
    prob, _, _ = drift_chain(K=10)
    tp = to_t(prob)
    a = tpg._gn_step_pcg(tp, tp.S_cw, 1e-6, 150)
    b = tpg._gn_step_pcg(tp, tp.S_cw, 1e-6, 400)
    assert torch.equal(a.t, b.t) and torch.equal(a.R, b.R)


def test_sharded_pose_graph_refuses():
    """A mesh no longer raises: the drift chain over two CPU slots lands
    within the solve budget of the unsharded PCG; only a mesh whose axis is
    not ``mesh_axis`` is refused."""
    from orb_slam2_ros2_tpu_torch.parallel import ba_mesh

    prob, _, _ = drift_chain(K=6)
    tp, mesh = to_t(prob), ba_mesh(2, devices=["cpu"] * 2)
    np.testing.assert_allclose(se3_of(tpg.optimize_pose_graph(tp, mesh=mesh)),
                               se3_of(tpg.optimize_pose_graph(tp, dense_max_k=0)), atol=2e-3)
    with pytest.raises(ValueError, match="axis"):
        tpg.optimize_pose_graph(tp, mesh=mesh, mesh_axis="other")
