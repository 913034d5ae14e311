"""Dense-Schur bundle adjustment over the per-point layout (port of the
per-point engine of ``orb_slam2_ros2_tpu/solvers/schur_ba.py``: ``_PointFM``,
``_to_fm``, ``_fm_edge_terms``, ``_solve_iteration_points`` and
``solve_ba_points``; reference Optimizer::OptimizeLocalMap,
src/Optimizer.cc:225-442).

Per-edge quantities are ``[k, O, P]`` scalar planes (``edge_fm``); point
blocks reduce over O, camera blocks through one one-hot matmul over the
C+1 camera slots (deterministic, unlike a float ``index_add_`` on CUDA), and
the reduced camera system ``S = blkdiag(Hcc + λ) − (B Wp) Bᵀ`` is one
``[6C, 3P] × [3P, 6C]`` matmul solved by ``cholesky_ex`` and two triangular
solves — no host synchronisation (``torch.linalg.cholesky`` checks its
``info`` on the host).  The LM accept/reject stays on the device.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..geometry import se3
from ..geometry.camera import CameraParams
from ..geometry.robust import huber_weight
from . import edge_fm
from .pcg_ba import PointBAProblem


class _PointFM(NamedTuple):
    """Obs-slot-major planes of a PointBAProblem (minor dim = points)."""

    ci: torch.Tensor          # i64[O, P] clipped camera index
    uv: torch.Tensor          # f32[2, O, P]
    right_u: torch.Tensor     # f32[O, P]
    inv_sigma2: torch.Tensor  # f32[O, P]
    valid: torch.Tensor       # bool[O, P]


def _to_fm(prob: PointBAProblem) -> _PointFM:
    C = prob.cam_Tcw.shape[0]
    return _PointFM(
        ci=prob.obs_cam.clamp(0, C - 1).T.long(),
        uv=prob.obs_uv.permute(2, 1, 0),
        right_u=prob.obs_right_u.T,
        inv_sigma2=prob.obs_inv_sigma2.T,
        valid=prob.obs_valid.T,
    )


def _fm_planes(Tcw: torch.Tensor, fm: _PointFM, pts: torch.Tensor):
    C = Tcw.shape[0]
    R9 = Tcw[:, :3, :3].reshape(C, 9).T[:, fm.ci]   # [9, O, P]
    t3 = Tcw[:, :3, 3].T[:, fm.ci]
    return R9, t3, pts.T[:, None, :]                  # pw [3, 1, P] broadcasts over O


def _fm_edge_terms(cam: CameraParams, fm: _PointFM, Tcw: torch.Tensor, pts: torch.Tensor):
    """Feature-major edge terms of the per-point layout."""
    R9, t3, pw3 = _fm_planes(Tcw, fm, pts)
    return edge_fm.edge_terms(cam, R9, t3, pw3, fm.uv, fm.right_u, fm.inv_sigma2)


def _fm_chi2(cam: CameraParams, fm: _PointFM, Tcw: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """``_fm_edge_terms(...).chi2`` without the Jacobians."""
    R9, t3, pw3 = _fm_planes(Tcw, fm, pts)
    return edge_fm.edge_chi2(cam, R9, t3, pw3, fm.uv, fm.right_u, fm.inv_sigma2)


def _solve_iteration_points(cam, prob: PointBAProblem, fm: _PointFM, Tcw, pts, weights, lam):
    """One damped Gauss-Newton dense-Schur step; ``weights [O, P]`` is
    validity ⊗ Huber ⊗ information, ``lam`` a 0-d tensor.  Returns
    (Tcw_new, pts_new)."""
    C = Tcw.shape[0]
    O, P = fm.ci.shape
    F6 = C * 6
    dev = Tcw.device

    terms = _fm_edge_terms(cam, fm, Tcw, pts)
    # fixed cameras contribute no camera gradient
    terms = terms._replace(Jc=torch.where(prob.cam_free[fm.ci][None], terms.Jc, 0.0))

    # point blocks: sums over the O axis
    Hpp6 = edge_fm.hpp_comps(terms, weights, reduce_axis=0)   # [6, P]
    b_p3 = edge_fm.bp_comps(terms, weights, reduce_axis=0)    # [3, P]
    d6 = torch.arange(6, device=dev)[:, None]
    lam_diag = torch.where((d6 == 0) | (d6 == 3) | (d6 == 5), lam + 1e-9, 0.0)
    Wp6 = edge_fm.sym3_inv(Hpp6 + lam_diag)
    Wp6 = torch.where(prob.pt_valid[None, :], Wp6, 0.0)

    G = edge_fm.g_comps(terms, weights)                        # [18, O, P]

    # camera reductions: one-hot over C+1 slots (invalid edges → slot C)
    ci_oh = torch.where(fm.valid, fm.ci, C)
    onehot = (ci_oh[None] == torch.arange(C + 1, device=dev)[:, None, None]).float()
    pay = torch.cat([edge_fm.hcc_comps(terms, weights), edge_fm.bc_comps(terms, weights)]).reshape(27, O * P)
    red = pay @ onehot.reshape(C + 1, O * P).T                  # [27, C+1]
    Hcc21 = red[:21, :C]
    b_c = red[21:, :C]                                          # [6, C]

    # per-point per-camera coupling blocks B[c, p] = Σ_o onehot·G
    B18 = torch.einsum("cop,gop->gcp", onehot, G)[:, :C]        # [18, C, P]
    S3 = edge_fm.SYM3_AT
    BW = torch.stack([
        sum(B18[3 * a + j] * Wp6[S3[(j, b)]] for j in range(3))
        for a in range(6) for b in range(3)
    ])                                                          # [18, C, P]

    def flat(x18):  # [18, C, P] → [6C, 3P], column p·3+b
        return x18.reshape(6, 3, C, P).permute(2, 0, 3, 1).reshape(F6, P * 3)

    Uf = flat(BW)
    S = -(Uf @ flat(B18).T)
    eye6 = torch.eye(6, dtype=S.dtype, device=dev)
    anchor = torch.where(prob.cam_free, 0.0, 1.0)[:, None, None] * eye6
    blocks = edge_fm.sym6_to_dense(Hcc21) + lam * eye6 + anchor  # [C, 6, 6]
    # block-diagonal add through a view of S's (c, c) blocks
    S.reshape(C, 6, C, 6).diagonal(dim1=0, dim2=2).add_(blocks.permute(1, 2, 0))
    b_schur = b_c.T.reshape(-1) - Uf @ b_p3.T.reshape(-1)

    L, info = torch.linalg.cholesky_ex(S + 1e-8 * torch.eye(F6, dtype=S.dtype, device=dev))
    y = torch.linalg.solve_triangular(L, b_schur[:, None], upper=False)
    dx_c = -torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
    ok = (info == 0) & torch.all(torch.isfinite(dx_c))
    dx_c = torch.where(ok, dx_c, 0.0).reshape(C, 6)
    dx_c = torch.where(prob.cam_free[:, None], dx_c, 0.0)

    # landmark back-substitution: dx_p = −Wp (b_p + Σ_o Gᵀ dx_c)
    tp = edge_fm.gT_apply(G, dx_c.T[:, fm.ci]).sum(dim=1)       # [3, P]
    dx_p = edge_fm.sym3_apply(Wp6, b_p3 + tp)
    dx_p = torch.where(torch.isfinite(dx_p), dx_p, 0.0)
    dx_p = torch.where(prob.pt_valid[None, :], dx_p, 0.0)

    return se3.normalize(se3.exp(dx_c) @ Tcw), pts - dx_p.T


def solve_ba_points(
    cam: CameraParams,
    prob: PointBAProblem,
    *,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    phase_iters: Tuple[int, int] = (3, 5),
    lam: float = 1e-3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-phase robust LM (iterate → χ² re-gate → iterate, Optimizer.cc:
    321-349) with step acceptance on a truncated-Huber cost.  Returns
    (cam_Tcw, pt_pos, obs_inlier [P, O])."""
    fm = _to_fm(prob)
    chi2_th = torch.where(fm.right_u > 0, chi2_stereo, chi2_mono)   # [O, P]
    Tcw, pts = prob.cam_Tcw, prob.pt_pos
    gate = fm.valid
    trunc = 1e4 * chi2_th
    rho_cap = 2.0 * torch.sqrt(chi2_th * trunc) - chi2_th

    def robust_cost(Tcw_, pts_, gate_):
        chi2 = _fm_chi2(cam, fm, Tcw_, pts_)
        rho = torch.where(chi2 <= chi2_th, chi2,
                          2.0 * torch.sqrt(chi2_th * torch.clamp(chi2, min=1e-12)) - chi2_th)
        rho = torch.minimum(rho, rho_cap)
        return torch.sum(torch.where(gate_, rho, 0.0))

    for n_iters in phase_iters:
        lam_c = torch.full((), lam, dtype=torch.float32, device=Tcw.device)
        cost = robust_cost(Tcw, pts, gate)
        for _ in range(n_iters):
            chi2 = _fm_chi2(cam, fm, Tcw, pts)
            w = gate.float() * fm.inv_sigma2 * huber_weight(chi2, chi2_th)
            w = torch.where(chi2 < trunc, w, 0.0)
            Tcw_new, pts_new = _solve_iteration_points(cam, prob, fm, Tcw, pts, w, lam_c)
            cost_new = robust_cost(Tcw_new, pts_new, gate)
            accept = cost_new < cost
            Tcw = torch.where(accept, Tcw_new, Tcw)
            pts = torch.where(accept, pts_new, pts)
            cost = torch.where(accept, cost_new, cost)
            lam_c = torch.clamp(torch.where(accept, lam_c * 0.5, lam_c * 8.0), 1e-6, 1e3)
        gate = fm.valid & (_fm_chi2(cam, fm, Tcw, pts) < chi2_th)
    return Tcw, pts, gate.T
