"""``tools.bench_scaling`` (the port of the repository's
``bench_scaling.py``) on the CPU at C = 16 cameras, P = 400 points, O = 6
observations a point, made with numpy from seed 0:

* its problem is the JAX script's (``jax_problem``, a copy of the root
  script's ``build_problem``: importing the script would change JAX's
  platform flags and ``sys.path``): every integer and mask of the
  camera-major view equal, poses within 1e-6 and pixels within 1e-3;
* the port's ``solve_global_ba``, JAX's, and the port's sharded solve over
  2 and 4 CPU slots each bring the problem's reprojection cost under
  ``COST_CUT`` of its start, and each cuts its robust cost (the gated
  Huber cost the solve minimises).  Their poses are not compared: the
  cameras start at the truth and every edge is monocular, so this problem
  leaves them undetermined — a 1e-6 m change of the points moves the
  solved cameras by centimetres, as far as the solve moves them
  (``test_the_problem_leaves_the_cameras_undetermined``).  The sharded
  solves are held to the unsharded one's poses on a problem that
  determines them in ``test_torch_sharded_solvers.py``;
* ``main`` returns the JAX script's keys, one time and efficiency a mesh
  size, and the costs;
* at C = 1024 cameras and P = 50,000 points the port's and JAX's solves
  each cut their robust cost, whatever the plain cost does (here it
  falls in the port and rises in JAX: ``pytest -s`` prints both);
* ``chip_smoke.run_corridor_shards``, phase 21's comparison of the sharded
  solves on the dry run's corridor (C = 256, P = 25,000), on the CPU: in
  float64 the 4-slot solve and the unsharded solve of the points
  reordered agree with the unsharded solve within 1e-9; in float32 the
  reordering alone moves the unsharded solve beyond the 1e-4 m of
  ``test_torch_sharded_solvers.py`` (cameras 141-147 see 1-4 points,
  148-255 none) and within phase 21's float32 bounds, as does the 4-slot
  solve.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mapping import two_torch_threads  # noqa: F401  (autouse)
from test_torch_tools_benches import jax_dicts

import chip_smoke

from orb_slam2_ros2_tpu.config import SLAMConfig as JConfig
from orb_slam2_ros2_tpu.geometry import se3 as jse3
from orb_slam2_ros2_tpu.geometry.camera import CameraParams as JCam
from orb_slam2_ros2_tpu.geometry.camera import project as jproject
from orb_slam2_ros2_tpu.solvers import pcg_ba as jpcg
from orb_slam2_ros2_tpu_torch.parallel import ba_mesh
from orb_slam2_ros2_tpu_torch.tools import bench_scaling

C, P, O = 16, 400, 6
COST_CUT = 1e-3     # a solve's reprojection cost over its start at most


def jax_problem(C, P, O, seed):
    """The root ``bench_scaling.py``'s ``build_problem`` (its lines 44-72)."""
    r = np.random.default_rng(seed)
    cam = JCam.from_config(JConfig().camera)
    pts = np.stack([r.uniform(-30, 30, P), r.uniform(-6, 6, P), r.uniform(5, 80, P)], 1).astype(np.float32)
    Tcw = np.stack([np.asarray(jse3.exp(jnp.asarray([0.3 * i, 0, 0.05 * i, 0, 0.002 * i, 0], jnp.float32)))
                    for i in range(C)])
    obs_cam = r.integers(0, C, (P, O)).astype(np.int32)
    pc = np.einsum("poij,pj->poi", Tcw[obs_cam][..., :3, :3], pts) + Tcw[obs_cam][..., :3, 3]
    uv, _ = jproject(cam, jnp.asarray(pc.reshape(-1, 3)))
    uv = np.asarray(uv).reshape(P, O, 2)
    valid = (pc[..., 2] > 1) & (uv[..., 0] > 0) & (uv[..., 0] < 1241) & (uv[..., 1] > 0) & (uv[..., 1] < 376)
    cam_free = np.ones(C, bool)
    cam_free[0] = False
    prob = jpcg.PointBAProblem(
        cam_Tcw=jnp.asarray(Tcw), cam_free=jnp.asarray(cam_free),
        pt_pos=jnp.asarray(pts + r.normal(0, 0.05, pts.shape).astype(np.float32)),
        pt_valid=jnp.ones(P, bool), obs_cam=jnp.asarray(np.where(valid, obs_cam, -1)),
        obs_uv=jnp.asarray(uv.astype(np.float32)), obs_right_u=jnp.full((P, O), -1.0, jnp.float32),
        obs_inv_sigma2=jnp.ones((P, O), jnp.float32), obs_valid=jnp.asarray(valid))
    return cam, jpcg.point_to_global(prob)


@pytest.fixture(scope="module")
def problems():
    arrays = bench_scaling.problem_arrays(C, P, O, seed=0)
    cam_t, prob_t = bench_scaling.build_problem(arrays, "cpu")
    cam_j, prob_j = jax_problem(C, P, O, seed=0)
    return dict(arrays=arrays, cam_t=cam_t, prob_t=prob_t, cam_j=cam_j, prob_j=prob_j)


def test_problem_is_jax_scripts(problems):
    pt, pj = problems["prob_t"], problems["prob_j"]
    for f in pt._fields:
        a, b = getattr(pt, f).numpy(), np.asarray(getattr(pj, f))
        assert a.shape == b.shape, f
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, atol=1e-3 if "uv" in f else 1e-6, rtol=0, err_msg=f)
    assert 0 < pt.pm_valid.sum() < P * O


def cost(problems, T, pts):
    return bench_scaling.reprojection_cost(problems["arrays"], np.asarray(T), np.asarray(pts))


def test_solves_cut_the_cost(problems):
    a = problems["arrays"]
    start = cost(problems, a["cam_Tcw"], a["pt_pos"])
    Tt, pts_t, _ = bench_scaling.solve_global_ba(problems["cam_t"], problems["prob_t"], **bench_scaling.SOLVER)
    Tj, pts_j, _ = jpcg.solve_global_ba(problems["cam_j"], problems["prob_j"], **bench_scaling.SOLVER)
    costs = {"port": cost(problems, Tt.numpy(), pts_t.numpy()), "jax": cost(problems, Tj, pts_j)}
    for n in (2, 4):
        Tn, pts_n, _ = bench_scaling.solve_global_ba_sharded(problems["cam_t"], problems["prob_t"],
                                                             ba_mesh(n, devices=["cpu"] * n), **bench_scaling.SOLVER)
        assert Tn.shape == (C, 4, 4) and pts_n.shape == (P, 3)
        costs[n] = cost(problems, Tn.numpy(), pts_n.numpy())
    assert start > 1000 and all(c < COST_CUT * start for c in costs.values()), (start, costs)
    robust = {k: bench_scaling.robust_cost(problems["cam_t"], problems["prob_t"], torch.as_tensor(np.array(T)),
                                           torch.as_tensor(np.array(q)))
              for k, (T, q) in dict(start=(a["cam_Tcw"], a["pt_pos"]), port=(Tt, pts_t), jax=(Tj, pts_j)).items()}
    assert all(v < COST_CUT * robust["start"] for k, v in robust.items() if k != "start"), robust
    np.testing.assert_array_equal(Tt.numpy()[0], a["cam_Tcw"][0])   # camera 0 is fixed
    assert np.abs(pts_t.numpy() - a["pt_pos"]).max() > 1e-2          # the 5 cm perturbation moved


def test_the_problem_leaves_the_cameras_undetermined(problems):
    """A 1e-6 m shift of every point moves the solved cameras by more than
    a centimetre and by at least a third of what the solve moves them
    (measured: 1.7 of 3.4 cm)."""
    a = problems["arrays"]
    shifted = dict(a, pt_pos=a["pt_pos"] + np.float32(1e-6))
    T0 = bench_scaling.solve_global_ba(problems["cam_t"], problems["prob_t"], **bench_scaling.SOLVER)[0].numpy()
    T1 = bench_scaling.solve_global_ba(*bench_scaling.build_problem(shifted, "cpu"), **bench_scaling.SOLVER)[0].numpy()
    moved = np.abs(T0[:, :3, 3] - a["cam_Tcw"][:, :3, 3]).max()
    apart = np.abs(T1[:, :3, 3] - T0[:, :3, 3]).max()
    assert apart > 1e-2 and apart > moved / 3, (apart, moved)


def test_main_keys():
    out = bench_scaling.main(["--device", "cpu", "--cams", str(C), "--points", str(P), "--obs", str(O),
                              "--shards", "2,4", "--reps", "1"])
    line = next(k for k in jax_dicts("bench_scaling.py") if "efficiency_vs_1" in k)
    assert list(line) == ["metric", "problem", "seconds", "efficiency_vs_1", "note"]
    assert set(line) <= set(out) and out["problem"] == f"C={C} P={P} O={O}" and out["card"] == "cpu"
    assert set(out["seconds"]) == set(out["efficiency_vs_1"]) == {"1", "2", "4"}
    assert all(t > 0 for t in out["seconds"].values()) and out["efficiency_vs_1"]["1"] == 1.0
    assert set(out["cost"]) == set(out["robust_cost"]) == {"start", "1", "2", "4"}
    assert set(out["pose_diff_vs_1"]) == {"2", "4"}
    for key in ("cost", "robust_cost"):
        assert all(out[key][n] < COST_CUT * out[key]["start"] for n in ("1", "2", "4")), out[key]


def test_solves_cut_the_robust_cost_at_a_thousand_cameras():
    """JAX's problem at C=1024, P=50,000: 815 of its cameras see no point."""
    arrays = bench_scaling.problem_arrays(1024, 50_000, O, seed=0)
    cam_t, prob_t = bench_scaling.build_problem(arrays, "cpu")
    cam_j, prob_j = jax_problem(1024, 50_000, O, seed=0)
    Tt, pts_t, _ = bench_scaling.solve_global_ba(cam_t, prob_t, **bench_scaling.SOLVER)
    Tj, pts_j, _ = jpcg.solve_global_ba(cam_j, prob_j, **bench_scaling.SOLVER)
    costs = {}
    for k, (T, q) in dict(start=(arrays["cam_Tcw"], arrays["pt_pos"]), port=(Tt, pts_t), jax=(Tj, pts_j)).items():
        T, q = np.array(T), np.array(q)
        costs[k] = (bench_scaling.reprojection_cost(arrays, T, q),
                    bench_scaling.robust_cost(cam_t, prob_t, torch.as_tensor(T), torch.as_tensor(q)))
    print("(plain, robust) cost", costs)
    assert all(np.isfinite(costs[k]).all() and costs[k][1] < costs["start"][1] for k in ("port", "jax")), costs


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
def test_corridor_shards_within_the_rounding_floor(dtype):
    gaps = chip_smoke.run_corridor_shards(dtype, [4], seed=1, device="cpu")
    floor = chip_smoke.run_corridor_shards(dtype, [], seed=2, device="cpu")["reordered"]
    print(dtype, gaps, floor)
    tol = chip_smoke.SHARDED_TOL[dtype]
    for r in (gaps["4"], gaps["reordered"], floor):
        assert all(r[k] <= lim for k, lim in tol.items()), (r, tol)
    if dtype == torch.float64:
        assert all(r["pose_diff_m"] < 1e-9 and r["rot_diff_deg"] < 1e-9 for r in (gaps["4"], gaps["reordered"], floor))
    else:
        tight = chip_smoke.SHARDED_TOL[torch.float64]["pose_diff_m"]
        assert max(gaps["reordered"]["pose_diff_m"], floor["pose_diff_m"]) > tight
