"""Batched EPnP + RANSAC for relocalization.

Port of ``orb_slam2_ros2_tpu/solvers/epnp.py`` (reference: src/PnPSolver.cc —
control points :139-176, barycentric :185-212, M matrix :221-241, null
vectors :249-272, β cases :280-355, Gauss-Newton :367-395; Ransac.hpp:63-103).
All hypotheses are generated and scored at once: H minimal sets, the EPnP
closed form batched over them (12×12 SVDs), every hypothesis scored against
every correspondence on one [H, N] residual grid, the argmax wins.  Every
function takes leading batch dimensions (``...``), so the relocalization
cascade runs its candidates as one batch.

Where torch and JAX differ: a singular barycentric or normal system returns
inf/NaN from ``solve_ex`` (``torch.linalg.solve`` would raise) and is gated
by ``isfinite`` as in the JAX version.  The decompositions — the control
points' principal axes, the null space of M, and the rank-deficient least
squares of the β cases (minimum-norm, with ``jnp.linalg.lstsq``'s default
cutoff eps·max(m, n)) — go through ``linalg_small.jacobi_svd``: on the H100
``torch.linalg.eigh``, ``svd`` and ``pinv`` synchronise with the host and
refuse a CUDA-graph capture, and ``torch.linalg.lstsq`` on CUDA solves
full-rank systems only.

Minimal sets are drawn by Gumbel top-k over logits (0 for valid rows, −1e9
for the others, as the JAX version's), which never fails when fewer than
``min_set`` rows are valid.  The uniform draw comes from a
``torch.Generator``, or is handed in as ``u`` (``uniform_draw``): a captured
program takes it as an input, since a generator's draw cannot be captured.
``sets`` overrides the draw, so a caller can hand in the sets another
implementation drew.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..geometry import se3
from ..geometry.align import horn_align
from ..geometry.camera import CameraParams
from .linalg_small import jacobi_svd, lstsq_min_norm

_PAIR_I = (0, 0, 0, 1, 1, 2)
_PAIR_J = (1, 2, 3, 2, 3, 3)
_LSTSQ_EPS = 1.1920929e-07  # f32 machine epsilon
N_HYP = 64   # RANSAC hypotheses


def _solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``A⁻¹ B`` that returns inf/NaN for a singular ``A`` and never checks
    on the host."""
    return torch.linalg.solve_ex(A, B).result


def _min_norm_lstsq(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least squares ``argmin ‖A x − b‖`` for [..., m, n] × [..., m]."""
    return lstsq_min_norm(A, b, _LSTSQ_EPS * max(A.shape[-2:]))


def _pair_diffs(x: torch.Tensor) -> torch.Tensor:
    """``x[..., i, :] − x[..., j, :]`` over the 6 control-point pairs, [..., 4, 3]
    → [..., 6, 3], by slices (an index tensor built from a host list would
    be a copy from the host)."""
    return torch.stack([x[..., i, :] - x[..., j, :] for i, j in zip(_PAIR_I, _PAIR_J)], dim=-2)


def uniform_draw(lead: tuple, n: int, generator: torch.Generator, n_hyp: int = N_HYP,
                 device=None) -> torch.Tensor:
    """The uniform numbers ``sample_minimal_sets`` turns into ``n_hyp``
    minimal sets over ``n`` rows: f32[*lead, n_hyp, n] from ``generator``
    (on ``device``, by default the generator's).  The draw depends on the
    shape only."""
    return torch.rand((*lead, n_hyp, n), generator=generator,
                      device=generator.device if device is None else device)


def sample_minimal_sets(valid: torch.Tensor, n_hyp: int, min_set: int,
                        generator: Optional[torch.Generator] = None, *,
                        u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``n_hyp`` index sets of ``min_set`` distinct rows each, i64[..., H, S],
    drawn without replacement with valid rows infinitely preferred: Gumbel
    top-k over logits 0 (valid) / −1e9 (invalid).  With fewer than
    ``min_set`` valid rows the rest of a set are invalid rows.  The uniform
    draw ``u`` ([..., H, N], ``uniform_draw``) is taken from ``generator``
    unless given."""
    if u is None:
        u = uniform_draw(valid.shape[:-1], valid.shape[-1], generator, n_hyp, device=valid.device)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    keys = gumbel + torch.where(valid, 0.0, -1e9)[..., None, :]
    return torch.topk(keys, min_set, dim=-1).indices


def epnp_solve(cam: CameraParams, pw: torch.Tensor, uv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form EPnP of minimal sets: pw [..., S, 3], uv [..., S, 2] →
    (Tcw [..., 4, 4], ok [...])."""
    S = pw.shape[-2]
    dev, dt = pw.device, pw.dtype
    # control points: centroid + PCA axes (PnPSolver.cc:139-176)
    c0 = pw.mean(dim=-2)
    centered = pw - c0[..., None, :]
    # the covariance's eigenpairs (ascending) from the SVD of the centred set
    sv, V, _ = jacobi_svd(centered)
    eigval, eigvec = (sv * sv / S).flip(-1), V.flip(-1)
    # axes scaled by sqrt eigenvalue (largest last).  An exactly planar set
    # has eigval[0] == 0: give that axis a small relative extent so the
    # barycentric system stays invertible — the β-case search covers the
    # enlarged null space the flat geometry induces
    floor = 0.25 * torch.clamp(eigval[..., 2], min=1e-9)
    axes = eigvec * torch.sqrt(torch.maximum(eigval, floor[..., None]))[..., None, :]
    ctrl_w = torch.cat([c0[..., None, :], c0[..., None, :] + axes.transpose(-1, -2)], dim=-2)  # [..., 4, 3]

    # barycentric coordinates (PnPSolver.cc:185-212): pw = Σ α_i ctrl_i
    ones4 = torch.ones((*pw.shape[:-2], 1, 4), dtype=dt, device=dev)
    Cmat = torch.cat([ctrl_w.transpose(-1, -2), ones4], dim=-2)             # [..., 4, 4]
    pwh = torch.cat([pw.transpose(-1, -2), torch.ones((*pw.shape[:-2], 1, S), dtype=dt, device=dev)], dim=-2)
    alpha = _solve(Cmat, pwh).transpose(-1, -2)                              # [..., S, 4]

    # M matrix (PnPSolver.cc:221-241), columns (x of 4 ctrls, y of 4, z of 4)
    fu, fv, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
    zeros = torch.zeros_like(alpha)
    row_u = torch.cat([alpha * fu, zeros, alpha * (cx - uv[..., 0:1])], dim=-1)
    row_v = torch.cat([zeros, alpha * fv, alpha * (cy - uv[..., 1:2])], dim=-1)
    M = torch.cat([row_u, row_v], dim=-2)                                    # [..., 2S, 12]
    # SVD of M itself, not eigh(MᵀM): squaring doubles the condition number
    # and in f32 the noise floor swamps the true null eigenvalue.  The
    # rotations run in f64: the near-null singular values sit ~1e-7·‖M‖
    # apart, inside f32 rounding, and a planar set's null space has four
    # of them, whose order picks the β cases' vectors.  A non-finite M
    # (singular barycentric system) is zeroed for the SVD and rejected by
    # the isfinite gate below
    finite_M = torch.isfinite(M).all(dim=(-2, -1), keepdim=True)
    vt = jacobi_svd(torch.where(finite_M, M, 0.0).double())[1].to(dt).transpose(-1, -2)
    # four smallest-singular-value directions, each as 4 control points
    # [4, 3] in the camera frame
    Vk = torch.stack(
        [torch.stack([vt[..., 11 - k, 0:4], vt[..., 11 - k, 4:8], vt[..., 11 - k, 8:12]], dim=-1)
         for k in range(4)], dim=-3,
    )                                                                        # [..., 4(null), 4(ctrl), 3]

    # control-point difference vectors of the 6 pairs
    dv = _pair_diffs(Vk)                                                     # [..., 4, 6, 3]
    dw_vec = _pair_diffs(ctrl_w)                                             # [..., 6, 3]
    rho = torch.sum(dw_vec * dw_vec, dim=-1)                                 # [..., 6] squared dists

    # β initializations of the three null-space cases, each refined by
    # Gauss-Newton on the distance residuals (PnPSolver.cc:280-395)
    betas = _gauss_newton_betas(_beta_cases(dv, rho), dv[..., None, :, :, :], rho[..., None, :])

    # one pose per case; the reprojection error of the minimal set picks
    ctrl_c = torch.einsum("...ck,...kij->...cij", betas, Vk)                 # [..., 3, 4, 3]
    pc = torch.einsum("...sa,...cai->...csi", alpha, ctrl_c)
    sign = torch.where(pc[..., 2].mean(dim=-1) < 0, -1.0, 1.0)
    ctrl_c = ctrl_c * sign[..., None, None]
    R, t, _ = horn_align(ctrl_w[..., None, :, :].expand_as(ctrl_c), ctrl_c,
                         torch.ones(ctrl_c.shape[:-1], dtype=dt, device=dev))
    Tcws = se3.from_Rt(R, t)                                                 # [..., 3, 4, 4]
    pcs = se3.apply(Tcws[..., None, :, :], pw[..., None, :, :])              # [..., 3, S, 3]
    z = torch.clamp(pcs[..., 2], min=1e-6)
    uh = fu * pcs[..., 0] / z + cx
    vh = fv * pcs[..., 1] / z + cy
    err = torch.sum((uh - uv[..., None, :, 0]) ** 2 + (vh - uv[..., None, :, 1]) ** 2, dim=-1)
    err = torch.where(torch.isfinite(Tcws).all(dim=(-2, -1)) & finite_M[..., 0], err, float("inf"))
    best = torch.argmin(err, dim=-1)
    Tcw = torch.gather(Tcws, -3, best[..., None, None, None].expand(*best.shape, 1, 4, 4))[..., 0, :, :]
    best_err = torch.gather(err, -1, best[..., None])[..., 0]
    # reject collinear/point-degenerate sets (eigval[1] ~ 0) but accept
    # planar ones (only eigval[0] = 0): the β cases cover those
    ok = torch.isfinite(best_err) & (eigval[..., 1] > 1e-9 * torch.clamp(eigval[..., 2], min=1e-12))
    eye = torch.eye(4, dtype=dt, device=dev)
    return torch.where(ok[..., None, None], Tcw, eye), ok


def _beta_cases(dv: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """β init for null-space dimensions N = 1, 2, 3 (PnPSolver.cc:280-355,
    the classic EPnP approximations of the linearized inter-distance
    system).  dv [..., 4, 6, 3], rho [..., 6] → β rows [..., 3, 4]."""
    d = torch.einsum("...kni,...lni->...kln", dv, dv)  # [..., 4, 4, 6] pairwise dot products
    zero = torch.zeros_like(rho[..., 0])

    # case N=1: ρ = β₁² |dv1|² → β₁ = Σ|dv1||dw| / Σ|dv1|²
    d00 = d[..., 0, 0, :]
    b1 = torch.sum(torch.sqrt(d00 * rho), dim=-1) / torch.clamp(d00.sum(dim=-1), min=1e-12)
    case1 = torch.stack([b1, zero, zero, zero], dim=-1)

    def signed(b, i, j):
        return torch.where(torch.sign(b[..., i]) * torch.sign(b[..., j]) < 0, -1.0, 1.0)

    # case N=2: unknowns (β₁₁, β₁₂, β₂₂) over 6 equations
    L2 = torch.stack([d00, 2.0 * d[..., 0, 1, :], d[..., 1, 1, :]], dim=-1)  # [..., 6, 3]
    b2v = _min_norm_lstsq(L2, rho)
    b2_0 = torch.sqrt(b2v[..., 0].abs())
    b2_1 = torch.sqrt(b2v[..., 2].abs()) * signed(b2v, 1, 0)
    case2 = torch.stack([b2_0, b2_1, zero, zero], dim=-1)

    # case N=3: unknowns (β₁₁, β₁₂, β₂₂, β₁₃, β₂₃) — β₃₃ dropped like the
    # classic approx_3
    L3 = torch.stack(
        [d00, 2.0 * d[..., 0, 1, :], d[..., 1, 1, :], 2.0 * d[..., 0, 2, :], 2.0 * d[..., 1, 2, :]],
        dim=-1,
    )  # [..., 6, 5]
    b3v = _min_norm_lstsq(L3, rho)
    b3_0 = torch.sqrt(b3v[..., 0].abs())
    b3_1 = torch.sqrt(b3v[..., 2].abs()) * signed(b3v, 1, 0)
    b3_2 = b3v[..., 3] / torch.clamp(b3_0, min=1e-12)
    case3 = torch.stack([b3_0, b3_1, b3_2, zero], dim=-1)
    return torch.stack([case1, case2, case3], dim=-2)


def _gauss_newton_betas(beta: torch.Tensor, dv: torch.Tensor, rho: torch.Tensor,
                        iters: int = 5) -> torch.Tensor:
    """Refine β [..., 4] so Σ_n (‖Σᵢ βᵢ dvᵢ‖² − ρ_n)² is minimized
    (PnPSolver::GaussNewton, :367-395): residuals over the 6 control-point
    pair distances, damped 4×4 normal-equation steps.  ``dv`` and ``rho``
    broadcast against β's leading dimensions."""
    d = torch.einsum("...kni,...lni->...kln", dv, dv)  # [..., 4, 4, 6]
    eye = 1e-9 * torch.eye(4, dtype=beta.dtype, device=beta.device)
    for _ in range(iters):
        # r_n = Σ_{k,l} b_k b_l d[k,l,n] − ρ_n ; ∂r/∂b_k = 2 Σ_l b_l d[k,l,n]
        r = torch.einsum("...k,...l,...kln->...n", beta, beta, d) - rho
        J = 2.0 * torch.einsum("...l,...kln->...nk", beta, d)
        H = J.transpose(-1, -2) @ J + eye
        g = torch.einsum("...nk,...n->...k", J, r)
        beta = beta - _solve(H, g[..., None])[..., 0]
    return beta


def ransac_pnp(
    cam: CameraParams,
    pw: torch.Tensor,          # [..., N, 3]
    uv: torch.Tensor,          # [..., N, 2]
    inv_sigma2: torch.Tensor,  # [..., N]
    valid: torch.Tensor,       # bool[..., N]
    generator: Optional[torch.Generator] = None,
    *,
    sets: Optional[torch.Tensor] = None,
    u: Optional[torch.Tensor] = None,
    n_hyp: int = N_HYP,
    min_set: int = 6,
    chi2_th: float = 5.991,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Parallel-hypothesis EPnP RANSAC (replaces PnPSolver::create +
    Ransac<T>::iterate).  Returns (Tcw [..., 4, 4], inliers [..., N],
    n_inliers [...]).  ``uv`` and ``inv_sigma2`` broadcast against the
    leading dimensions of ``pw`` and ``valid``.  The minimal sets come from
    ``sets`` (integer [..., H, S]) when given, else from the uniform draw
    ``u`` ([..., H, N]) or ``generator``."""
    lead = valid.shape[:-1]
    N = valid.shape[-1]
    pw = pw.expand(*lead, N, 3)
    uv = uv.expand(*lead, N, 2)
    inv_sigma2 = inv_sigma2.expand(*lead, N)
    if sets is None:
        if generator is None and u is None:
            raise ValueError("ransac_pnp needs a generator, a uniform draw or explicit sets")
        sets = sample_minimal_sets(valid, n_hyp, min_set, generator, u=u)
    sets = sets.long()
    H, S = sets.shape[-2:]
    flat = sets.reshape(*lead, H * S)

    def rows(a):  # [..., N, c] → [..., H, S, c]
        idx = flat[..., None].expand(*lead, H * S, a.shape[-1])
        return torch.gather(a, -2, idx).reshape(*lead, H, S, a.shape[-1])

    Tcws, oks = epnp_solve(cam, rows(pw), rows(uv))                         # [..., H, 4, 4]

    # score all hypotheses × all correspondences
    pc = torch.einsum("...hij,...nj->...hni", se3.R_of(Tcws), pw) + se3.t_of(Tcws)[..., :, None, :]
    z = torch.where(pc[..., 2] > 1e-6, pc[..., 2], 1e-6)
    u = cam.fx * pc[..., 0] / z + cam.cx
    v = cam.fy * pc[..., 1] / z + cam.cy
    err2 = ((u - uv[..., None, :, 0]) ** 2 + (v - uv[..., None, :, 1]) ** 2) * inv_sigma2[..., None, :]
    inl = (err2 < chi2_th) & (pc[..., 2] > 0) & valid[..., None, :]
    scores = inl.to(torch.int32).sum(dim=-1).to(torch.int32) * oks.to(torch.int32)
    best = torch.argmax(scores, dim=-1)
    Tcw = torch.gather(Tcws, -3, best[..., None, None, None].expand(*lead, 1, 4, 4))[..., 0, :, :]
    inl_best = torch.gather(inl, -2, best[..., None, None].expand(*lead, 1, N))[..., 0, :]
    return Tcw, inl_best, torch.gather(scores, -1, best[..., None])[..., 0]
