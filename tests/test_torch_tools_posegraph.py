"""``tools/bench_posegraph.py`` on the CPU: its ``chain_problem`` against
the JAX script's recipe (built here from JAX's ``se3``, ``sim3`` and
``make_relative_measurements``: the root script points JAX's compile cache
into the repository) — edges exact, poses and measurements within f32
rounding; ``iters`` calls of a ``StepGraph(gn_step, capture=False)``
bit-equal to ``optimize_pose_graph`` on both routes; the dense and PCG
solves within ``test_torch_pose_graph.py``'s 2e-3 of JAX's; ``main``'s keys.
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
from orb_slam2_ros2_tpu_torch.geometry import sim3 as tsim3
from orb_slam2_ros2_tpu_torch.solvers import pose_graph as tpg
from orb_slam2_ros2_tpu_torch.tools import bench_posegraph as tbp

K, EXTRA = 32, 64
POSE_TOL = 1e-5
SOLVE_TOL = 2e-3   # tests/test_torch_pose_graph.py, test_optimize_pose_graph_matches_jax
ROUTES = {"pcg": dict(dense_max_k=0, cg_iters=150), "dense": dict(dense_max_k=1 << 20)}


def jax_chain(K: int, E_extra: int, seed: int = 0):
    """The recipe of the repository's ``bench_posegraph.chain_problem``."""
    r = np.random.default_rng(seed)
    step = np.asarray(jse3.exp(jnp.asarray([0.5, 0, 0.05, 0, 2 * np.pi / K, 0], jnp.float32)))
    gt = [np.eye(4, dtype=np.float32)]
    est = [gt[0]]
    for _ in range(1, K):
        gt.append((step @ gt[-1]).astype(np.float32))
        noise = jse3.exp(jnp.asarray(np.concatenate([r.normal(0, 0.01, 3), r.normal(0, 0.002, 3)]), jnp.float32))
        est.append(((step @ np.asarray(noise)) @ est[-1]).astype(np.float32))
    S_est = jsim3.from_se3(jnp.asarray(np.stack(est)))
    S_gt = jsim3.from_se3(jnp.asarray(np.stack(gt)))
    ei, ej = list(range(K - 1)), list(range(1, K))
    a = r.integers(0, K - 3, E_extra)
    b = a + r.integers(2, 4, E_extra)
    ei += a.tolist()
    ej += b.tolist()
    ei.append(0)
    ej.append(K - 1)
    ei, ej = jnp.asarray(ei, jnp.int32), jnp.asarray(ej, jnp.int32)
    S_meas = jpg.make_relative_measurements(S_est, ei, ej)
    true_rel = jpg.make_relative_measurements(S_gt, jnp.asarray([0]), jnp.asarray([K - 1]))
    S_meas = jsim3.Sim3(R=S_meas.R.at[-1].set(true_rel.R[0]), t=S_meas.t.at[-1].set(true_rel.t[0]),
                        s=S_meas.s.at[-1].set(true_rel.s[0]))
    E = int(ei.shape[0])
    return jpg.PoseGraphProblem(S_cw=S_est, kf_valid=jnp.ones(K, bool), kf_fixed=jnp.zeros(K, bool).at[0].set(True),
                                edge_i=ei, edge_j=ej, edge_Sji=S_meas, edge_valid=jnp.ones(E, bool),
                                edge_weight=jnp.ones(E))


@pytest.fixture(scope="module")
def problems():
    return jax_chain(K, EXTRA), tbp.chain_problem(K, EXTRA)


def test_chain_problem_matches_jax(problems):
    jp, tp = problems
    for f in ("edge_i", "edge_j", "kf_valid", "kf_fixed", "edge_valid"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)), err_msg=f)
    np.testing.assert_array_equal(tp.edge_weight.numpy(), np.asarray(jp.edge_weight, np.float32))
    for name in ("R", "t", "s"):
        np.testing.assert_allclose(getattr(tp.S_cw, name).numpy(), np.asarray(getattr(jp.S_cw, name)),
                                   atol=POSE_TOL, err_msg=name)
        np.testing.assert_allclose(getattr(tp.edge_Sji, name).numpy(), np.asarray(getattr(jp.edge_Sji, name)),
                                   atol=POSE_TOL, err_msg=name)


@pytest.mark.parametrize("route", list(ROUTES))
def test_gn_step_replays_equal_optimize_pose_graph(problems, route):
    out = tbp.solve_routes(problems[1], ROUTES[route], torch.device("cpu"), iters=20, reps=1)
    assert out["bit_equal"] and out["eager_ms"] > 0 and out["replay_ms"] > 0
    eager = tpg.optimize_pose_graph(problems[1], iters=20, **ROUTES[route])
    assert all(torch.equal(a, b) for a, b in zip(out["S"], eager))


@pytest.mark.parametrize("route", list(ROUTES))
def test_solves_match_jax(problems, route):
    jp, tp = problems
    Sj = jax.jit(lambda p: jpg.optimize_pose_graph(p, iters=20, **ROUTES[route]))(jp)
    St = tpg.optimize_pose_graph(tp, iters=20, **ROUTES[route])
    np.testing.assert_allclose(tsim3.to_se3(St).numpy(), np.asarray(jsim3.to_se3(Sj)), atol=SOLVE_TOL)


def test_main_returns_its_keys():
    out = tbp.main(["--device", "cpu", "--sizes", "16:32,24:48", "--dense-max-k", "16", "--reps", "1"])
    for key in ("pcg_K16_ms", "pcg_K16_replay_ms", "dense_K16_ms", "dense_K16_replay_ms", "pcg_K24_ms"):
        assert out[key] > 0, key
    assert "dense_K24_ms" not in out and set(out["pcg_vs_dense"]) == {"K16"}
    assert out["pcg_vs_dense"]["K16"] <= SOLVE_TOL
    assert all(r["bit_equal"] for r in out["runs"]) and len(out["runs"]) == 3
