"""Sim(3) estimation between keyframes: batched RANSAC + GN refinement.

Port of ``orb_slam2_ros2_tpu/solvers/sim3_solver.py`` (reference
``Sim3Solver``, src/Sim3Solver.cc:24-259, and ``Optimizer::OptimizeSim3``,
src/Optimizer.cc:464-619).  All RANSAC hypotheses at once (batched Horn with
scale) and one dense bidirectional-reprojection scoring pass; the refinement
is Gauss-Newton on the sim(3) tangent with analytic Jacobians at ξ = 0 (the
JAX version takes the same derivatives by ``jax.jacfwd``).  Stereo maps fix
the scale (``bFixScale``,
Sim3Solver.h:71-76) by pinning the σ component of the update.

Minimal sets are drawn as in ``solvers/epnp.py``: by Gumbel top-k from a
``torch.Generator`` or a uniform draw ``u`` made from one beforehand (a
captured graph cannot draw from a generator), or handed in as ``sets``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..geometry import se3, sim3
from ..geometry.align import horn_align
from ..geometry.camera import CameraParams
from ..geometry.robust import huber_weight
from .epnp import sample_minimal_sets


def _proj(cam: CameraParams, p: torch.Tensor) -> torch.Tensor:
    z = torch.where(p[..., 2] > 1e-6, p[..., 2], 1e-6)
    return torch.stack([cam.fx * p[..., 0] / z + cam.cx, cam.fy * p[..., 1] / z + cam.cy], dim=-1)


def _proj_jac(cam: CameraParams, p: torch.Tensor) -> torch.Tensor:
    """∂_proj/∂p [..., 2, 3]; a depth at the 1e-6 clamp is a constant."""
    front = p[..., 2] > 1e-6
    inv_z = 1.0 / torch.where(front, p[..., 2], 1e-6)
    zero = torch.zeros_like(inv_z)
    dz = torch.where(front, inv_z * inv_z, 0.0)
    return torch.stack([
        torch.stack([cam.fx * inv_z, zero, -cam.fx * p[..., 0] * dz], dim=-1),
        torch.stack([zero, cam.fy * inv_z, -cam.fy * p[..., 1] * dz], dim=-1),
    ], dim=-2)


def _point_jac(q: torch.Tensor) -> torch.Tensor:
    """∂(exp(ξ)·q)/∂ξ at ξ = 0, [..., 3, 7]: columns (ρ, φ, σ) = (I, −q^, q)."""
    I = torch.eye(3, dtype=q.dtype, device=q.device).expand(*q.shape[:-1], 3, 3)
    return torch.cat([I, -se3.hat(q), q[..., None]], dim=-1)


def ransac_sim3(
    pc1: torch.Tensor,       # [N, 3] matched points in camera frame 1
    pc2: torch.Tensor,       # [N, 3] matched points in camera frame 2
    valid: torch.Tensor,     # bool[N]
    cam: CameraParams,
    inv_sigma2_1: torch.Tensor,
    inv_sigma2_2: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    sets: Optional[torch.Tensor] = None,
    u: Optional[torch.Tensor] = None,
    n_hyp: int = 64,
    min_set: int = 3,
    fix_scale: bool = True,
    chi2_th: float = 9.21,
) -> Tuple[sim3.Sim3, torch.Tensor, torch.Tensor]:
    """Estimate S12 (frame 2 → frame 1) with parallel hypotheses.  Inliers
    are gated by bidirectional reprojection error < ``chi2_th``·σ²
    (Sim3Solver.cc:215-259).  Returns (S12, inliers [N], n_inliers).  The
    minimal sets come from ``sets`` (integer [H, S]) when given, else from
    the uniform draw ``u`` ([H, N], ``epnp.uniform_draw``) or ``generator``."""
    if sets is None:
        if generator is None and u is None:
            raise ValueError("ransac_sim3 needs a generator, a uniform draw or explicit sets")
        sets = sample_minimal_sets(valid, n_hyp, min_set, generator, u=u)
    sets = sets.long()
    # hypothesis: pc1 ≈ s R pc2 + t
    R, t, s = horn_align(pc2[sets], pc1[sets],
                         torch.ones(sets.shape, dtype=pc1.dtype, device=pc1.device),
                         with_scale=not fix_scale)
    if fix_scale:
        s = torch.ones_like(s)
    S12 = sim3.Sim3(R=R, t=t, s=s)

    # forward: map pc2 into frame 1, compare against pc1's projection
    uv1_obs = _proj(cam, pc1)
    uv2_obs = _proj(cam, pc2)
    p2in1 = sim3.apply(sim3.Sim3(R=R[:, None], t=t[:, None], s=s[:, None]), pc2[None])
    e1 = torch.sum((_proj(cam, p2in1) - uv1_obs[None]) ** 2, dim=-1) * inv_sigma2_1[None]
    Sinv = sim3.inverse(S12)
    p1in2 = sim3.apply(sim3.Sim3(R=Sinv.R[:, None], t=Sinv.t[:, None], s=Sinv.s[:, None]), pc1[None])
    e2 = torch.sum((_proj(cam, p1in2) - uv2_obs[None]) ** 2, dim=-1) * inv_sigma2_2[None]
    inl = (e1 < chi2_th) & (e2 < chi2_th) & valid[None, :] & (p2in1[..., 2] > 0) & (p1in2[..., 2] > 0)
    scores = inl.to(torch.int32).sum(dim=1).to(torch.int32)
    best = torch.argmax(scores).reshape(1)
    S_best = sim3.Sim3(R=R[best][0], t=t[best][0], s=s[best][0])
    return S_best, inl[best][0], scores[best][0]


def optimize_sim3(
    S12: sim3.Sim3,
    pc1: torch.Tensor,
    pc2: torch.Tensor,
    valid: torch.Tensor,
    cam: CameraParams,
    inv_sigma2_1: torch.Tensor,
    inv_sigma2_2: torch.Tensor,
    *,
    fix_scale: bool = True,
    iters: int = 10,
    chi2_th: float = 9.21,
    damping: float = 1e-6,
) -> Tuple[sim3.Sim3, torch.Tensor, torch.Tensor]:
    """GN refinement of S12 on fixed point pairs with bidirectional
    projection residuals and Huber δ² = ``chi2_th`` (OptimizeSim3,
    Optimizer.cc:464-619).  Returns (S12_opt, inliers [N], n_inliers)."""
    dev, dt = pc1.device, pc1.dtype
    uv1_obs = _proj(cam, pc1)
    uv2_obs = _proj(cam, pc2)
    sq1 = torch.sqrt(inv_sigma2_1)[:, None]
    sq2 = torch.sqrt(inv_sigma2_2)[:, None]

    def residuals(S, with_jac=False):
        """4-vector residual per point, forward + backward pixel errors, and
        its Jacobian [N, 4, 7] for the update S ← exp(ξ)∘S at ξ = 0: the
        forward point is exp(ξ)·S(p2), the backward one S⁻¹(exp(−ξ)·p1)."""
        Sinv = sim3.inverse(S)
        p2in1 = sim3.apply(S, pc2)
        p1in2 = sim3.apply(Sinv, pc1)
        r = torch.cat([(_proj(cam, p2in1) - uv1_obs) * sq1,
                       (_proj(cam, p1in2) - uv2_obs) * sq2], dim=-1)  # [N, 4]
        if not with_jac:
            return r
        J_fwd = _proj_jac(cam, p2in1) @ _point_jac(p2in1) * sq1[..., None]
        J_bwd = -(_proj_jac(cam, p1in2) @ (Sinv.s * Sinv.R) @ _point_jac(pc1)) * sq2[..., None]
        return r, torch.cat([J_fwd, J_bwd], dim=-2)

    eye7 = torch.eye(7, dtype=dt, device=dev)
    # the scale DOF pinned (stereo maps: bFixScale): row and column 6 of H
    # become the unit vector, entry 6 of b zero
    free = torch.ones(7, dtype=dt, device=dev)
    if fix_scale:
        free[6:].fill_(0.0)
    pin = torch.diag(1.0 - free)

    def chi2_of(r):
        return torch.sum(r[:, :2] ** 2, dim=-1), torch.sum(r[:, 2:] ** 2, dim=-1)

    S = S12
    for _ in range(iters):
        r0, J = residuals(S, with_jac=True)
        c1, c2 = chi2_of(r0)
        w = valid.to(dt) * torch.minimum(huber_weight(c1, chi2_th), huber_weight(c2, chi2_th))
        H = torch.einsum("nki,n,nkj->ij", J, w, J)
        b = torch.einsum("nki,n,nk->i", J, w, r0)
        H = H * free[:, None] * free[None, :] + pin + damping * eye7
        dx = -torch.linalg.solve_ex(H, (b * free)[:, None]).result[:, 0]
        dx = torch.where(torch.isfinite(dx).all(), dx, 0.0)
        S = sim3.compose(sim3.exp(dx), S)

    c1, c2 = chi2_of(residuals(S))
    inl = valid & (c1 < chi2_th) & (c2 < chi2_th)
    return S, inl, inl.to(torch.int32).sum().to(torch.int32)
