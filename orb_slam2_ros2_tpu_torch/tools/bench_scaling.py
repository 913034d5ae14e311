"""The landmark-sharded global BA over 1, 2, 4 and 8 mesh slots (port of
the repository's ``bench_scaling.py``)::

    python3 -m orb_slam2_ros2_tpu_torch.tools.bench_scaling [--cams 1024] [--points 200000] [--obs 6] [--reps 3]

One global-BA problem at the KITTI-00 scale (C cameras on a forward track,
P points each seen by O random cameras, the points perturbed by 5 cm;
made with numpy from ``--seed``, ``build_problem``) is solved by
``solve_global_ba`` and then by ``solve_global_ba_sharded`` over
``ba_mesh(n)`` for each n of ``--shards`` (phase iterations (2, 2), 20
PCG iterations, λ = 1e-3); each time is the best of REPS solves after an
untimed one, between two CUDA events on the card.  The solves stay eager,
as the system's synchronous solve does.

Every slot of the mesh is the one device (this process's card, or the
CPU), so the figure measures what sharding costs on one device — the
shards' launches and the collectives between them — not scaling across
devices (JAX runs the same script on a virtual CPU mesh).
``cost`` is the squared reprojection error summed over the valid edges
(float64, pinhole) and ``robust_cost`` the gated Huber cost the solve
minimises (every valid edge in its gate), at the start and after each
solve.  ``pose_diff_vs_1`` holds each sharded solve's largest camera
difference from the unsharded one (metres, degrees).

The problem leaves most cameras undetermined: the track runs sideways out
of the points' 60 m wide slab, so at the full size 810 of the 1024 cameras
see no point and 7 see fewer than 10, and every edge is monocular (at
C=16 a 1e-6 m shift of the points moves the solved cameras about as far
as the solve moves them, ``tests/test_torch_tools_scaling.py``).  So the
plain cost after a solve says little: the solve minimises the robust
cost, and the squared error of the edges it gates out may grow.  At
C=1024, P=50,000 on the CPU the port's solve halves the plain cost and
JAX's raises it 1.2-fold, each cutting its robust cost (the same test);
at the full size on an NVIDIA H100 80GB HBM3 at 700 W the port's raises
it 8.5-fold and cuts its robust cost 36-fold.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SLAMConfig
from ..entry import _rot_deg
from ..geometry import se3
from ..geometry.camera import CameraParams, project
from ..parallel.mesh import ba_mesh
from ..solvers import pcg_ba
from ..solvers.pcg_ba import PointBAProblem, point_to_global, solve_global_ba, solve_global_ba_sharded
from . import _timing

SOLVER = dict(phase_iters=(2, 2), pcg_iters=20, lam=1e-3)


def problem_arrays(C: int = 1024, P: int = 200_000, O: int = 6, seed: int = 0) -> dict:
    """JAX's problem (``bench_scaling.py:44-72``) as numpy arrays, by the
    ``PointBAProblem`` field names."""
    r = np.random.default_rng(seed)
    cam_cfg = SLAMConfig().camera
    pts = np.stack([r.uniform(-30, 30, P), r.uniform(-6, 6, P), r.uniform(5, 80, P)], 1).astype(np.float32)
    i, z = np.arange(C, dtype=np.float64), np.zeros(C)
    xi = np.stack([0.3 * i, z, 0.05 * i, z, 0.002 * i, z], 1).astype(np.float32)
    Tcw = se3.exp(torch.from_numpy(xi)).numpy()
    obs_cam = r.integers(0, C, (P, O)).astype(np.int32)
    pc = np.einsum("poij,pj->poi", Tcw[obs_cam][..., :3, :3], pts) + Tcw[obs_cam][..., :3, 3]
    uv = project(CameraParams.from_config(cam_cfg, "cpu"), torch.from_numpy(pc.reshape(-1, 3)))[0]
    uv = uv.numpy().reshape(P, O, 2)
    valid = ((pc[..., 2] > 1) & (uv[..., 0] > 0) & (uv[..., 0] < cam_cfg.width) & (uv[..., 1] > 0)
             & (uv[..., 1] < cam_cfg.height))
    cam_free = np.ones(C, bool)
    cam_free[0] = False
    return dict(cam_Tcw=Tcw, cam_free=cam_free, pt_pos=pts + r.normal(0, 0.05, pts.shape).astype(np.float32),
                pt_valid=np.ones(P, bool), obs_cam=np.where(valid, obs_cam, -1).astype(np.int32),
                obs_uv=uv.astype(np.float32), obs_right_u=np.full((P, O), -1.0, np.float32),
                obs_inv_sigma2=np.ones((P, O), np.float32), obs_valid=valid)


def build_problem(arrays: dict, device):
    """(camera, the camera-major ``GlobalBAProblem``) of ``arrays`` on ``device``."""
    cam = CameraParams.from_config(SLAMConfig().camera, device)
    prob = PointBAProblem(*(torch.from_numpy(np.ascontiguousarray(arrays[f])).to(device)
                            for f in PointBAProblem._fields))
    return cam, point_to_global(prob)


def reprojection_cost(arrays: dict, Tcw, pts) -> float:
    """The squared pixel error of every valid edge of ``arrays`` under the
    poses ``Tcw`` [C, 4, 4] and points ``pts`` [P, 3], summed in float64."""
    cam = SLAMConfig().camera
    T, p = np.asarray(Tcw, np.float64), np.asarray(pts, np.float64)
    ok = arrays["obs_valid"] & (arrays["obs_cam"] >= 0)
    Ti = T[np.where(ok, arrays["obs_cam"], 0)]
    pc = np.einsum("poij,pj->poi", Ti[..., :3, :3], p) + Ti[..., :3, 3]
    z = np.where(pc[..., 2] > 1e-6, pc[..., 2], 1.0)
    uv = arrays["obs_uv"]
    e2 = (cam.fx * pc[..., 0] / z + cam.cx - uv[..., 0]) ** 2 + (cam.fy * pc[..., 1] / z + cam.cy - uv[..., 1]) ** 2
    return float(e2[ok].sum())


def robust_cost(cam, prob, Tcw, pts) -> float:
    """The gated Huber cost the solve minimises, with every valid edge of
    the camera-major problem ``prob`` in its gate, under the poses ``Tcw``
    and points ``pts`` [P, 3] (the solve's default χ² thresholds)."""
    pm_th, _ = pcg_ba._thresholds(prob, 5.991, 7.815)
    return float(pcg_ba._robust_cost(cam, prob, Tcw, pts.T, prob.pm_valid, pm_th))


def time_solve(fn, device, reps: int):
    """(best seconds of ``reps`` calls after an untimed one, the last result)."""
    fn()
    _timing.sync(device)
    best, out = float("inf"), None
    for _ in range(reps):
        ms, out = _timing.span_ms(fn, device)
        best = min(best, ms / 1e3)
    return best, out


def main(argv=None) -> dict:
    ap = _timing.base_parser("bench_scaling", __doc__)
    ap.add_argument("--cams", type=int, default=1024, help="cameras C (JAX: 1024)")
    ap.add_argument("--points", type=int, default=200_000, help="points P (JAX: 200,000)")
    ap.add_argument("--obs", type=int, default=6, help="observations a point O (JAX: 6)")
    ap.add_argument("--shards", default="2,4,8", help="mesh sizes after the unsharded solve (JAX: 2,4,8)")
    ap.add_argument("--reps", type=int, default=3, help="timed solves; the best is kept (JAX: 3)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = _timing.resolve_device(args.device)
    arrays = problem_arrays(args.cams, args.points, args.obs, args.seed)
    cam, prob = build_problem(arrays, dev)
    seconds, poses, cost = {}, {}, {"start": reprojection_cost(arrays, arrays["cam_Tcw"], arrays["pt_pos"])}
    robust = {"start": robust_cost(cam, prob, prob.cam_Tcw, prob.pt_pos)}
    meshes = {1: None, **{int(n): ba_mesh(int(n), devices=[dev] * int(n)) for n in args.shards.split(",")}}
    for n, mesh in meshes.items():
        if mesh is None:
            seconds[n], out = time_solve(lambda: solve_global_ba(cam, prob, **SOLVER), dev, args.reps)
        else:
            seconds[n], out = time_solve(lambda: solve_global_ba_sharded(cam, prob, mesh, **SOLVER), dev, args.reps)
        poses[n] = out[0]
        cost[str(n)] = reprojection_cost(arrays, out[0].cpu().numpy(), out[1].cpu().numpy())
        robust[str(n)] = robust_cost(cam, prob, out[0], out[1])
        del out
    diff = {str(n): {"m": float((poses[n][:, :3, 3] - poses[1][:, :3, 3]).abs().max()),
                     "deg": float(_rot_deg(poses[n], poses[1]).max())} for n in seconds if n != 1}
    del poses
    _timing.release(dev)
    return _timing.emit("bench_scaling", dev, {
        "metric": f"global_ba_sharding_{dev.type}_slots_one_device",
        "problem": f"C={args.cams} P={args.points} O={args.obs}",
        "seconds": {str(n): t for n, t in seconds.items()},
        "efficiency_vs_1": {str(n): seconds[1] / (t * n) for n, t in seconds.items()},
        "note": f"every mesh slot on the one {dev.type} device: the cost of sharding, not scaling across "
                f"devices",
        "cost": cost,
        "robust_cost": robust,
        "pose_diff_vs_1": diff,
        "reps": args.reps,
    })


if __name__ == "__main__":
    main()
