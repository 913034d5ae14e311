"""The plain reference of what local BA leaves behind: a keyframe's pose
and the points it observes should sit where ORB-SLAM2's robust
reprojection cost (Optimizer.cc: the χ²-gate Huber kernel, each residual
weighed by its octave's inverse variance) has its optimum.  The reference
takes the program's map as it stands after the window and solves, itself,

- each point observed by the sampled keyframes alone, over every keyframe
  that observes it, the keyframe poses held; ``map_point_gain_med_pct`` is
  the median, over the sampled keyframes, of the share (%) of the robust
  cost of each keyframe's points that this solve removes;
- each sampled keyframe's pose alone, over the points it observes, the
  points held; ``map_pose_gain_pct`` is the share (%) of the robust cost
  of all their observations that this solve removes.

The median stands against one keyframe whose points the bounded local-BA
window (``ba.local_ba_points``, most recent points first) left partly
unadjusted after a later fuse gave them new observations: in sound runs
that keyframe's share reads up to ~15% while the others read ~0.  A
map that local BA adjusted leaves little to remove; one whose points keep
the depth one stereo pair or one triangulation gave them, or whose poses
were not adjusted with them, leaves much more.

The keypoints the sampled keyframes observe are the reference's own
(``frontend.py``, worked out again from the benchmark's frames); those of
the other keyframes that observe the same points are read from the map (the
frontend's numbers hold the map's keypoints to the reference's on the
sampled keyframes).  The poses, the points and which point each slot
observes are the program's outputs, read here only to judge them.  Plain PyTorch in
float64; imports nothing of the port."""

from __future__ import annotations

import numpy as np
import torch

ITERS = 10


def _project(Tcw: torch.Tensor, pw: torch.Tensor, cam: dict):
    """Camera coordinates [..., 3] and (u, v, u_right) [..., 3] of ``pw``
    under ``Tcw`` [..., 4, 4]."""
    pc = (Tcw[..., :3, :3] @ pw[..., None])[..., 0] + Tcw[..., :3, 3]
    z = pc[..., 2]
    zs = torch.where(z > 1e-9, z, torch.ones_like(z))
    fx, fy, cx, cy = (float(cam[k]) for k in ("fx", "fy", "cx", "cy"))
    bf = fx * float(cam["baseline"])
    u = fx * pc[..., 0] / zs + cx
    v = fy * pc[..., 1] / zs + cy
    return pc, torch.stack([u, v, u - bf / zs], -1)


def _jac_cam(pc: torch.Tensor, cam: dict) -> torch.Tensor:
    """d(u, v, u_right) / d(camera coordinates), [..., 3, 3]."""
    fx, fy = float(cam["fx"]), float(cam["fy"])
    bf = fx * float(cam["baseline"])
    x, y, z = pc.unbind(-1)
    z = torch.where(z > 1e-9, z, torch.ones_like(z))
    zero = torch.zeros_like(z)
    rows = [torch.stack([fx / z, zero, -fx * x / z ** 2], -1),
            torch.stack([zero, fy / z, -fy * y / z ** 2], -1),
            torch.stack([fx / z, zero, (-fx * x + bf) / z ** 2], -1)]
    return torch.stack(rows, -2)


def _costs(Tcw, pw, obs, w, mask, gate, cam):
    """Residuals [..., 3] (the right one zeroed for a mono observation),
    χ² and the robust cost (Huber with δ² the χ² gate) of each observation,
    and the camera coordinates."""
    pc, pred = _project(Tcw, pw, cam)
    r = (pred - obs) * mask
    chi2 = (r * r).sum(-1) * w
    e = torch.sqrt(chi2.clamp(min=0))
    rho = torch.where(chi2 <= gate, chi2, 2.0 * torch.sqrt(gate) * e - gate)
    rho = torch.where(pc[..., 2] > 1e-9, rho, torch.full_like(rho, 1e6))
    return r, chi2, rho, pc


def _weights(chi2, gate):
    """IRLS weight of the Huber kernel."""
    e = torch.sqrt(chi2.clamp(min=1e-30))
    return torch.where(chi2 <= gate, torch.ones_like(chi2), torch.sqrt(gate) / e)


def solve_points(Tcw, pw0, obs, inv_s2, mask, gate, valid, cam):
    """Each point alone ([P, 3]), its observations [P, O] held by their
    poses ``Tcw`` [P, O, 4, 4]: damped Gauss-Newton on the robust cost,
    a step kept only where it lowers it.  Returns (cost at ``pw0``, cost
    after), each [P]."""
    X = pw0.clone()

    def total(Xb):
        _, _, rho, _ = _costs(Tcw, Xb[:, None].expand_as(obs), obs, inv_s2, mask, gate, cam)
        return (rho * valid).sum(-1)

    start = cur = total(X)
    lam = torch.full_like(cur, 1e-4)
    for _ in range(ITERS):
        r, chi2, _, pc = _costs(Tcw, X[:, None].expand_as(obs), obs, inv_s2, mask, gate, cam)
        wgt = (_weights(chi2, gate) * inv_s2 * valid)[..., None]
        J = (_jac_cam(pc, cam) * mask[..., None]) @ Tcw[..., :3, :3]          # [P, O, 3, 3]
        H = (J.transpose(-1, -2) @ (J * wgt[..., None])).sum(1)
        g = (J.transpose(-1, -2) @ (r * wgt)[..., None]).sum(1)[..., 0]
        H = H + lam[:, None, None] * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1) + 1e-9)
        step = torch.linalg.solve(H, -g)
        Xn = X + step
        new = total(Xn)
        better = new < cur
        X = torch.where(better[:, None], Xn, X)
        cur = torch.where(better, new, cur)
        lam = torch.where(better, lam * 0.5, lam * 8.0)
    return start, cur


def _hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _exp_se3(xi):
    """SE(3) exponential of [ω, ν] (left perturbation), [4, 4]."""
    w, v = xi[:3], xi[3:]
    th = torch.linalg.norm(w)
    K = _hat(w)
    I = torch.eye(3, dtype=xi.dtype)
    if th < 1e-12:
        R, V = I + K, I + 0.5 * K
    else:
        a, b = torch.sin(th) / th, (1 - torch.cos(th)) / th ** 2
        R = I + a * K + b * K @ K
        V = I + b * K + (th - torch.sin(th)) / th ** 3 * K @ K
    T = torch.eye(4, dtype=xi.dtype)
    T[:3, :3], T[:3, 3] = R, V @ v
    return T


def solve_pose(Tcw0, pw, obs, inv_s2, mask, gate, cam):
    """One keyframe's pose alone, its points ``pw`` [N, 3] held: damped
    Gauss-Newton on the robust cost.  Returns (cost at ``Tcw0``, cost
    after)."""
    def total(T):
        _, _, rho, _ = _costs(T, pw, obs, inv_s2, mask, gate, cam)
        return rho.sum()

    T, lam = Tcw0.clone(), 1e-4
    start = cur = total(T)
    for _ in range(ITERS):
        r, chi2, _, pc = _costs(T, pw, obs, inv_s2, mask, gate, cam)
        wgt = (_weights(chi2, gate) * inv_s2)[..., None]
        dpc = torch.cat([-_hat(pc), torch.eye(3, dtype=pc.dtype).expand(pc.shape[0], 3, 3)], -1)   # [N, 3, 6]
        J = (_jac_cam(pc, cam) * mask[..., None]) @ dpc
        H = (J.transpose(-1, -2) @ (J * wgt[..., None])).sum(0)
        g = (J.transpose(-1, -2) @ (r * wgt)[..., None]).sum(0)[..., 0]
        H = H + lam * torch.diag(torch.diagonal(H) + 1e-9)
        Tn = _exp_se3(torch.linalg.solve(H, -g)) @ T
        new = total(Tn)
        if new < cur:
            T, cur, lam = Tn, new, lam * 0.5
        else:
            lam *= 8.0
    return start, cur


def _obs_fields(uv, right_u, octave, scale_factor, chi2_mono, chi2_stereo):
    stereo = right_u > 0
    obs = torch.stack([uv[..., 0], uv[..., 1], torch.where(stereo, right_u, uv[..., 0])], -1).double()
    mask = torch.stack([torch.ones_like(stereo), torch.ones_like(stereo), stereo], -1).double()
    inv_s2 = torch.pow(torch.tensor(float(scale_factor), dtype=torch.float64), -2.0 * octave.double())
    gate = torch.where(stereo, chi2_stereo, chi2_mono).double()
    return obs, mask, inv_s2, gate


def judge(samples: list, refs: list, points: dict, cam: dict, scale_factor: float, chi2_mono: float,
          chi2_stereo: float) -> dict:
    """``map_point_gain_med_pct`` and ``map_pose_gain_pct`` (see the module's
    docstring) and the counts they were read over.  ``samples``: for each
    sampled keyframe its ``kf_Tcw`` and per slot the point it observes
    (``mp_idx``, ``mp_pos``, ``mp_ok``); ``refs``: the reference's features
    of the same keyframes; ``points``: the observed points' positions and,
    per observation, the observing keyframe's pose and keypoint."""
    fields = dict(scale_factor=scale_factor, chi2_mono=chi2_mono, chi2_stereo=chi2_stereo)
    pose_start = pose_end = 0.0
    n_pose_obs, per_kf = 0, []
    for s, r in zip(samples, refs):
        keep = r["valid"] & s["mp_ok"]
        if int(keep.sum()) < 6:
            per_kf.append(dict(pose_gain_pct=None))
            continue
        obs, mask, inv_s2, gate = _obs_fields(r["uv"][keep], r["right_u"][keep], r["octave"][keep], **fields)
        a, b = solve_pose(s["kf_Tcw"].double(), s["mp_pos"][keep].double(), obs, inv_s2, mask, gate, cam)
        pose_start, pose_end, n_pose_obs = pose_start + float(a), pose_end + float(b), n_pose_obs + int(keep.sum())
        per_kf.append(dict(pose_gain_pct=_share(float(a), float(b))))
    out = dict(map_pose_gain_pct=_share(pose_start, pose_end) if n_pose_obs else float("inf"),
               pose_observations=n_pose_obs)
    valid = points["valid"]
    multi = valid.sum(-1) >= 2
    if int(multi.sum()) == 0:
        return dict(out, map_point_gain_med_pct=float("inf"), points_solved=0, per_keyframe=per_kf)
    obs, mask, inv_s2, gate = _obs_fields(points["uv"][multi], points["right_u"][multi],
                                          points["octave"][multi], **fields)
    a, b = solve_points(points["Tcw"][multi].double(), points["pos"][multi].double(), obs, inv_s2, mask, gate,
                        valid[multi].double(), cam)
    ids = points["ids"][multi]
    for s, d in zip(samples, per_kf):
        mine = torch.isin(ids, s["mp_idx"][s["mp_ok"]].long())
        d.update(point_gain_pct=_share(float(a[mine].sum()), float(b[mine].sum())), points=int(mine.sum()))
    per_point = [d["point_gain_pct"] for d in per_kf if d["points"] > 0]
    return dict(out, map_point_gain_med_pct=float(np.median(per_point)) if per_point else float("inf"),
                map_point_gain_all_pct=_share(float(a.sum()), float(b.sum())), points_solved=int(multi.sum()),
                point_observations=int(valid[multi].sum()), per_keyframe=per_kf)


def _share(start: float, end: float) -> float:
    """The share (%) of ``start`` that the solve removed."""
    return 100.0 * (start - end) / start if start > 0 else 0.0
