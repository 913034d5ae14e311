"""Pose-only optimization: batched Levenberg-Marquardt on SE(3), replacing
g2o (port of ``orb_slam2_ros2_tpu/solvers/pose_opt.py``; reference
src/Optimizer.cc:33-203, χ² 5.991/7.815, information 1/σ² per octave).

Residuals and analytic Jacobians for all matches at once, a 6×6 normal
system per iteration, fixed trip counts (``rounds × iters_per_round``) and
step acceptance by ``torch.where`` — no data-dependent control flow and no
host synchronisation.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..geometry import se3
from ..geometry.camera import CameraParams
from ..geometry.robust import huber_weight
from .linalg_small import cholesky_solve_spd


class PoseObs(NamedTuple):
    """Padded observation set for one frame's pose optimization."""

    pw: torch.Tensor          # f32[M, 3] world points
    uv: torch.Tensor          # f32[M, 2] observed keypoint
    right_u: torch.Tensor     # f32[M] observed right-image u (stereo only)
    inv_sigma2: torch.Tensor  # f32[M] octave information weight
    is_stereo: torch.Tensor   # bool[M]
    valid: torch.Tensor       # bool[M]


def residuals_and_jac(cam: CameraParams, Tcw: torch.Tensor, obs: PoseObs):
    """Residuals r [M, 3] and Jacobians J = ∂r/∂ξ [M, 3, 6] for the update
    T ← exp(ξ)·T (``[..., M, ...]`` for a pose batch ``Tcw [..., 4, 4]``)."""
    pc = se3.apply(Tcw if Tcw.dim() == 2 else Tcw[..., None, :, :], obs.pw)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z = torch.where(z > 1e-6, z, 1e-6)
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z

    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    ur = u - cam.bf * inv_z

    r = torch.stack(
        [u - obs.uv[..., 0], v - obs.uv[..., 1], torch.where(obs.is_stereo, ur - obs.right_u, 0.0)],
        dim=-1,
    )

    zero = torch.zeros_like(z)
    du = torch.stack([cam.fx * inv_z, zero, -cam.fx * x * inv_z2], dim=-1)
    dv = torch.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z2], dim=-1)
    dur = du + torch.stack([zero, zero, cam.bf * inv_z2], dim=-1)
    dpix = torch.stack([du, dv, dur], dim=-2)  # [M, 3, 3]

    I = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(*pc.shape[:-1], 3, 3)
    dpc = torch.cat([I, -se3.hat(pc)], dim=-1)  # [M, 3, 6]
    return r, dpix @ dpc


def _residual_dim_mask(obs: PoseObs) -> torch.Tensor:
    """[M, 3] mask: rows use 2 (mono) or 3 (stereo) residual components."""
    one = torch.ones_like(obs.is_stereo)
    return torch.stack([one, one, obs.is_stereo], dim=-1).float()


def chi2_per_obs(cam: CameraParams, Tcw: torch.Tensor, obs: PoseObs) -> torch.Tensor:
    r, _ = residuals_and_jac(cam, Tcw, obs)
    return torch.sum(r * r * _residual_dim_mask(obs), dim=-1) * obs.inv_sigma2


def optimize_pose(
    cam: CameraParams,
    Tcw0: torch.Tensor,
    obs: PoseObs,
    *,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    rounds: int = 4,
    iters_per_round: int = 10,
    damping: float = 1e-4,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (Tcw_opt, inlier_mask [M], n_inliers).

    A batch of poses ``Tcw0 [..., 4, 4]`` solves one problem per leading
    index: the observation fields broadcast against ``[..., M]`` (``valid``
    or ``pw`` carry the batch, the frame's fields may be shared).

    Each round runs ``iters_per_round`` LM steps, then re-gates every
    observation against its χ² threshold (outliers may return); the Huber
    kernel is dropped for the last two rounds.  A loss beyond 1e4·χ²_th is
    constant (redescending), so a catastrophic mismatch cannot drag the pose.
    """
    dev = Tcw0.device
    lead = Tcw0.shape[:-2]
    chi2_th = torch.where(obs.is_stereo, chi2_stereo, chi2_mono)
    inlier = obs.valid
    trunc = 1e4 * chi2_th
    dm = _residual_dim_mask(obs)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)

    Tcw = Tcw0
    for rnd in range(rounds):
        use_huber = rnd < rounds - 2

        def terms(T):
            """One combined pass: residuals + Jacobians → (cost, H, b)."""
            r, J = residuals_and_jac(cam, T, obs)
            chi2 = torch.sum(r * r * dm, dim=-1) * obs.inv_sigma2
            w = obs.inv_sigma2 * inlier.float()
            w = torch.where(chi2 < trunc, w, 0.0)
            if use_huber:
                w = w * huber_weight(chi2, chi2_th)
            wm = w[..., None] * dm  # [..., M, 3]
            H = torch.einsum("...mki,...mk,...mkj->...ij", J, wm, J)
            b = torch.einsum("...mki,...mk,...mk->...i", J, wm, r)
            if use_huber:
                c = torch.where(
                    chi2 <= chi2_th, chi2,
                    2.0 * torch.sqrt(chi2_th * torch.clamp(chi2, min=1e-12)) - chi2_th,
                )
                c_cap = 2.0 * torch.sqrt(chi2_th * trunc) - chi2_th
            else:
                c, c_cap = chi2, trunc
            cost = torch.sum(torch.where(inlier, torch.minimum(c, c_cap), 0.0), dim=-1)
            return cost, H, b

        cost, H, b = terms(Tcw)
        lam = torch.full(lead, damping, dtype=torch.float32, device=dev)
        for _ in range(iters_per_round):
            Hd = H + lam[..., None, None] * (eye6 + torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1)))
            dx = -cholesky_solve_spd(Hd, b)
            dx = torch.where(torch.isfinite(dx).all(dim=-1, keepdim=True), dx, 0.0)
            T_new = se3.exp(dx) @ Tcw
            cost_new, H_new, b_new = terms(T_new)
            accept = cost_new < cost
            Tcw = torch.where(accept[..., None, None], T_new, Tcw)
            H = torch.where(accept[..., None, None], H_new, H)
            b = torch.where(accept[..., None], b_new, b)
            cost = torch.where(accept, cost_new, cost)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 8.0), 1e-7, 1e4)
        inlier = obs.valid & (chi2_per_obs(cam, Tcw, obs) < chi2_th)

    Tcw = se3.normalize(Tcw)
    return Tcw, inlier, torch.sum(inlier.to(torch.int32), dim=-1)
