"""The essential-graph solver alone, dense Cholesky against matrix-free PCG
(port of the repository's ``bench_posegraph.py``)::

    python3 -m orb_slam2_ros2_tpu_torch.tools.bench_posegraph [--sizes 256:1024,1024:4096,2048:8192]
        [--dense-max-k 1024] [--iters 20] [--reps 3]

For each size K:E (a drifted chain of K keyframes, E random covisibility
edges between near-in-time keyframes and one loop edge carrying the true
relative pose, ``chain_problem``) the 20-iteration solve is timed by route
— PCG (``dense_max_k=0``, ``cg_iters=150``) at every K, dense for K up to
``--dense-max-k`` — two ways:

* eager ``solvers.pose_graph.optimize_pose_graph(iters=20)``;
* 20 replays of one captured graph of ``gn_step``, the route of the
  system's ``loop_closing.EssentialGraph`` (the problem static, the poses
  carried from replay to replay).

``bit_equal`` says whether the replays' poses equal the eager solve's bit
for bit; ``start_cost`` and ``cost`` are the weighted squared residuals
before and after the solve; ``pcg_vs_dense`` is the largest difference
between the two routes' SE(3) poses where both ran.  (Past K ≈ 100 the
150 CG iterations a step leave the PCG route short of the optimum the
dense route reaches in 20 steps: its cost stays above the dense one.)
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import se3, sim3
from ..pipeline.frame_graph import tree_map
from ..solvers import pose_graph
from ..solvers.pose_graph import PoseGraphProblem, gn_step, make_relative_measurements, optimize_pose_graph
from . import _timing

SIZES = "256:1024,1024:4096,2048:8192"
CG_ITERS = 150


def chain_problem(K: int, E_extra: int, seed: int = 0) -> PoseGraphProblem:
    """A drifted chain of ``K`` keyframes + ``E_extra`` covisibility-style
    edges + one loop edge with the true relative pose, vertex 0 fixed — the
    JAX script's recipe, drawn with numpy from ``seed``, on the CPU."""
    r = np.random.default_rng(seed)
    f32 = torch.float32
    step = se3.exp(torch.tensor([0.5, 0, 0.05, 0, 2 * np.pi / K, 0], dtype=f32)).numpy()
    draws = [np.concatenate([r.normal(0, 0.01, 3), r.normal(0, 0.002, 3)]) for _ in range(1, K)]
    noise = se3.exp(torch.tensor(np.asarray(draws), dtype=f32).reshape(-1, 6)).numpy()
    gt, est = [np.eye(4, dtype=np.float32)], [np.eye(4, dtype=np.float32)]
    for n in noise:
        gt.append((step @ gt[-1]).astype(np.float32))
        est.append(((step @ n) @ est[-1]).astype(np.float32))
    S_est = sim3.from_se3(torch.from_numpy(np.stack(est)))
    S_gt = sim3.from_se3(torch.from_numpy(np.stack(gt)))
    a = r.integers(0, K - 3, E_extra)
    b = a + r.integers(2, 4, E_extra)
    ei = torch.tensor(list(range(K - 1)) + a.tolist() + [0], dtype=torch.int32)
    ej = torch.tensor(list(range(1, K)) + b.tolist() + [K - 1], dtype=torch.int32)
    S_meas = make_relative_measurements(S_est, ei, ej)
    true_rel = make_relative_measurements(S_gt, torch.tensor([0]), torch.tensor([K - 1]))
    S_meas = sim3.Sim3(*(torch.cat([m[:-1], t]) for m, t in zip(S_meas, true_rel)))
    E = int(ei.shape[0])
    fixed = torch.zeros(K, dtype=torch.bool)
    fixed[0] = True
    return PoseGraphProblem(S_cw=S_est, kf_valid=torch.ones(K, dtype=torch.bool), kf_fixed=fixed, edge_i=ei,
                            edge_j=ej, edge_Sji=S_meas, edge_valid=torch.ones(E, dtype=torch.bool),
                            edge_weight=torch.ones(E, dtype=f32))


def cost(prob: PoseGraphProblem, S: sim3.Sim3) -> float:
    """The weighted sum of squared edge residuals at ``S``."""
    r, _, _, w = pose_graph._linearize(prob, S)
    return float((w[:, None] * r * r).sum())


def solve_routes(prob: PoseGraphProblem, kw: dict, device, *, iters: int = 20, reps: int = 3) -> dict:
    """One route of ``prob``: eager ``optimize_pose_graph`` and ``iters``
    replays of a captured ``gn_step`` (ms: the best of ``reps``), their
    poses and whether they are bit-equal."""
    step = _timing.Replay(lambda S, p: gn_step(p, S, **kw), device)

    def replayed():
        S = prob.S_cw
        for _ in range(iters):
            S = step(S, fixed=(prob,))
        return S

    replayed()
    eager = [_timing.span_ms(lambda: optimize_pose_graph(prob, iters=iters, **kw), device) for _ in range(reps)]
    graph = [_timing.span_ms(replayed, device) for _ in range(reps)]
    S_eager, S_graph = eager[-1][1], graph[-1][1]
    return {"eager_ms": min(ms for ms, _ in eager), "replay_ms": min(ms for ms, _ in graph),
            "bit_equal": all(torch.equal(a, b) for a, b in zip(S_eager, S_graph)),
            "start_cost": cost(prob, prob.S_cw), "cost": cost(prob, S_graph), "S": S_graph}


def main(argv=None) -> dict:
    ap = _timing.base_parser("bench_posegraph", __doc__)
    ap.add_argument("--sizes", default=SIZES, help="K:E_extra pairs (JAX: 256:1024,1024:4096,2048:8192)")
    ap.add_argument("--dense-max-k", type=int, default=1024, help="largest K the dense route runs at (JAX: 1024)")
    ap.add_argument("--iters", type=int, default=20, help="GN iterations (JAX: 20)")
    ap.add_argument("--reps", type=int, default=3, help="timed solves; the best is kept (JAX: 3)")
    args = ap.parse_args(argv)
    dev = _timing.resolve_device(args.device)
    routes = {"pcg": dict(dense_max_k=0, cg_iters=CG_ITERS), "dense": dict(dense_max_k=1 << 20)}
    out, rows, diffs = {}, [], {}
    for pair in args.sizes.split(","):
        K, extra = (int(x) for x in pair.split(":"))
        prob = tree_map(lambda t: t.to(dev), chain_problem(K, extra))
        E = int(prob.edge_i.shape[0])
        poses = {}
        for route, kw in routes.items():
            if route == "dense" and K > args.dense_max_k:
                continue
            r = solve_routes(prob, kw, dev, iters=args.iters, reps=args.reps)
            poses[route] = sim3.to_se3(r.pop("S"))
            rows.append({"K": K, "E": E, "route": route, **r})
            out[f"{route}_K{K}_ms"] = r["eager_ms"]
            out[f"{route}_K{K}_replay_ms"] = r["replay_ms"]
            _timing.release(dev)
        if len(poses) == 2:
            diffs[f"K{K}"] = float((poses["pcg"] - poses["dense"]).abs().max())
    return _timing.emit("bench_posegraph", dev, {"iters": args.iters, "reps": args.reps, **out, "runs": rows,
                                                 "pcg_vs_dense": diffs})


if __name__ == "__main__":
    main()
