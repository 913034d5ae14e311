"""Bundle-adjustment problem layouts and the global-BA engine: PCG on the
Schur-reduced camera system.

Port of ``orb_slam2_ros2_tpu/solvers/pcg_ba.py`` (reference
Optimizer::globalOptimization, src/Optimizer.cc:934-1043).  ``PointBAProblem``
is the per-point edge layout local BA solves directly; ``GlobalBAProblem``
holds the same edges twice — point-major planes ``[.., O, M]`` and
camera-major planes ``[.., N, K]`` — so that every Schur reduction is an
axis sum and no scatter is needed.  Each Gauss-Newton step solves the
reduced camera system by a fixed number of block-Jacobi PCG iterations,
back-substitutes the points and keeps the best of {full step, quarter step,
hold} by the gated Huber cost.  Nothing reads back to the host.

``point_to_global`` builds the camera-major view on the device by a stable
sort of the edges by camera; its slot tables equal the JAX package's host
numpy version.  It reads back one integer, the largest per-camera edge
count that sizes the view.  The point/camera-sharded solve waits for the
multi-GPU item of the port queue.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..geometry import se3
from ..geometry.camera import CameraParams
from ..geometry.robust import huber_weight
from ..utils import count_into, set_drop
from . import edge_fm
from .linalg_small import cholesky_solve_spd


class PointBAProblem(NamedTuple):
    """Per-point edge layout: P point slots × O observations each."""

    cam_Tcw: torch.Tensor      # f32[C, 4, 4]
    cam_free: torch.Tensor     # bool[C]
    pt_pos: torch.Tensor       # f32[P, 3]
    pt_valid: torch.Tensor     # bool[P]
    obs_cam: torch.Tensor      # i32[P, O] camera slot (−1 = none)
    obs_uv: torch.Tensor       # f32[P, O, 2]
    obs_right_u: torch.Tensor  # f32[P, O] (−1 = mono)
    obs_inv_sigma2: torch.Tensor  # f32[P, O]
    obs_valid: torch.Tensor    # bool[P, O]


class GlobalBAProblem(NamedTuple):
    """Dual-layout global BA problem: point-major planes [.., O, M] (minor
    dim = points) and camera-major planes [.., N, K] (minor dim = cameras)
    describing exactly the same edge set."""

    cam_Tcw: torch.Tensor      # f32[K, 4, 4]
    cam_free: torch.Tensor     # bool[K]
    pt_pos: torch.Tensor       # f32[M, 3]
    pt_valid: torch.Tensor     # bool[M]
    pm_cam: torch.Tensor       # i32[O, M] camera index (clipped; see pm_valid)
    pm_uv: torch.Tensor        # f32[2, O, M]
    pm_right_u: torch.Tensor   # f32[O, M]
    pm_inv_sigma2: torch.Tensor  # f32[O, M]
    pm_valid: torch.Tensor     # bool[O, M]
    cm_pt: torch.Tensor        # i32[N, K] point index (clipped; see cm_valid)
    cm_uv: torch.Tensor        # f32[2, N, K]
    cm_right_u: torch.Tensor   # f32[N, K]
    cm_inv_sigma2: torch.Tensor  # f32[N, K]
    cm_valid: torch.Tensor     # bool[N, K]


def _chi2_point(cam, prob: PointBAProblem, Tcw: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Per-observation χ² [P, O], computed feature-major."""
    C = Tcw.shape[0]
    ci = prob.obs_cam.clamp(0, C - 1).T.long()                   # [O, P]
    Rf = Tcw[:, :3, :3].reshape(C, 9).T
    tf = Tcw[:, :3, 3].T
    chi2 = edge_fm.edge_chi2(
        cam, Rf[:, ci], tf[:, ci], pts.T[:, None, :],
        prob.obs_uv.permute(2, 1, 0), prob.obs_right_u.T, prob.obs_inv_sigma2.T,
    )
    return chi2.T


# --------------------------------------------------------------------------
# the dual-layout GN step
# --------------------------------------------------------------------------

def _pm_terms(cam, prob: GlobalBAProblem, Tcw, ptsT) -> edge_fm.EdgeTerms:
    """Point-major edge terms ([*, O, M] planes); ``ptsT`` is [3, M]."""
    C = Tcw.shape[0]
    idx = prob.pm_cam.long()
    return edge_fm.edge_terms(
        cam, Tcw[:, :3, :3].reshape(C, 9).T[:, idx], Tcw[:, :3, 3].T[:, idx],
        ptsT[:, None, :], prob.pm_uv, prob.pm_right_u, prob.pm_inv_sigma2,
    )


def _cm_terms(cam, prob: GlobalBAProblem, Tcw, ptsT) -> edge_fm.EdgeTerms:
    """Camera-major edge terms ([*, N, K] planes): the camera pose broadcasts
    over the feature axis, the points are gathered."""
    C = Tcw.shape[0]
    return edge_fm.edge_terms(
        cam, Tcw[:, :3, :3].reshape(C, 9).T[:, None, :], Tcw[:, :3, 3].T[:, None, :],
        ptsT[:, prob.cm_pt.long()], prob.cm_uv, prob.cm_right_u, prob.cm_inv_sigma2,
    )


def _weights(chi2, gate, inv_sigma2, chi2_th):
    w = gate.to(torch.float32) * inv_sigma2 * huber_weight(chi2, chi2_th)
    return torch.where(chi2 < 1e4 * chi2_th, w, 0.0)


def _robust_cost(cam, prob: GlobalBAProblem, Tcw, ptsT, pm_gate, pm_th):
    """Gated Huber total cost over the point-major view (each edge once),
    capped at the 1e4·th weight cutoff."""
    chi2 = _pm_terms(cam, prob, Tcw, ptsT).chi2
    rho = torch.where(chi2 <= pm_th, chi2, 2.0 * torch.sqrt(pm_th * torch.clamp(chi2, min=0.0)) - pm_th)
    rho = torch.minimum(rho, 199.0 * pm_th)
    return torch.sum(torch.where(pm_gate & prob.pm_valid, rho, 0.0))


def _gn_step(cam, prob: GlobalBAProblem, Tcw, ptsT, pm_gate, cm_gate, lam: float,
             pcg_iters: int, pm_th, cm_th):
    """One robust GN step with the PCG-Schur solve; returns (Tcw, ptsT)."""
    dev = Tcw.device
    pm_cam = prob.pm_cam.long()
    cm_pt = prob.cm_pt.long()

    # ---- point-major pass: Hpp, Wp, b_p, per-edge G ----------------------
    tm = _pm_terms(cam, prob, Tcw, ptsT)
    w_pm = _weights(tm.chi2, pm_gate, prob.pm_inv_sigma2, pm_th)
    tm = tm._replace(Jc=torch.where(prob.cam_free[pm_cam][None], tm.Jc, 0.0))
    Hpp6 = edge_fm.hpp_comps(tm, w_pm, reduce_axis=-2)             # [6, M]
    b_p3 = edge_fm.bp_comps(tm, w_pm, reduce_axis=-2)              # [3, M]
    comp = torch.arange(6, device=dev)[:, None]
    lam_diag = ((comp == 0) | (comp == 3) | (comp == 5)).to(torch.float32) * (lam + 1e-9)
    Wp6 = edge_fm.sym3_inv(Hpp6 + lam_diag)
    Wp6 = torch.where(prob.pt_valid[None, :], Wp6, 0.0)
    G_pm = edge_fm.g_comps(tm, w_pm)                               # [18, O, M]

    # ---- camera-major pass: Hcc, b_c, b̃, per-edge G ---------------------
    tc = _cm_terms(cam, prob, Tcw, ptsT)
    w_cm = _weights(tc.chi2, cm_gate, prob.cm_inv_sigma2, cm_th)
    tc = tc._replace(Jc=torch.where(prob.cam_free[None, None, :], tc.Jc, 0.0))
    Hcc21 = edge_fm.hcc_comps(tc, w_cm, reduce_axis=-2)            # [21, K]
    b_c = edge_fm.bc_comps(tc, w_cm, reduce_axis=-2)               # [6, K]
    G_cm = edge_fm.g_comps(tc, w_cm)                               # [18, N, K]

    # b̃ = b_c − Σ_n G · (Wp b_p)[point of edge]
    Wb = edge_fm.sym3_apply(Wp6, b_p3)                             # [3, M]
    b_schur = b_c - torch.sum(edge_fm.g_apply(G_cm, Wb[:, cm_pt]), dim=-2)
    anchor = torch.where(prob.cam_free, 0.0, 1.0)[None, :]         # [1, K]

    def matvec(x):                                                 # [6, K] → [6, K]
        t_p = torch.sum(edge_fm.gT_apply(G_pm, x[:, pm_cam]), dim=-2)   # [3, M]
        z = edge_fm.sym3_apply(Wp6, t_p)
        u = torch.sum(edge_fm.g_apply(G_cm, z[:, cm_pt]), dim=-2)
        return -u + edge_fm.sym6_apply(Hcc21, x) + lam * x + anchor * x

    # block-Jacobi preconditioner from Hcc
    Hcc_p = edge_fm.sym6_to_dense(Hcc21) + (lam + 1.0) * torch.eye(6, device=dev)[None]

    def precond(v):                                                # [6, K]
        return cholesky_solve_spd(Hcc_p, v.T).T

    b = -b_schur
    x = torch.zeros_like(b)
    rres, p = b, precond(b)
    rz = torch.sum(b * p)
    for _ in range(pcg_iters):
        Ap = matvec(p)
        denom = torch.sum(p * Ap)
        alpha = torch.where(denom.abs() > 1e-12, rz / denom, 0.0)
        x = x + alpha * p
        rres = rres - alpha * Ap
        z = precond(rres)
        rz_new = torch.sum(rres * z)
        beta = torch.where(rz.abs() > 1e-12, rz_new / rz, 0.0)
        p = z + beta * p
        rz = rz_new
    dx_c = torch.where(torch.isfinite(x), x, 0.0)
    dx_c = torch.where(prob.cam_free[None, :], dx_c, 0.0)         # [6, K]

    # landmark back-substitution
    tp = torch.sum(edge_fm.gT_apply(G_pm, dx_c[:, pm_cam]), dim=-2)
    dx_p = edge_fm.sym3_apply(Wp6, b_p3 + tp)                      # [3, M]
    dx_p = torch.where(torch.isfinite(dx_p), dx_p, 0.0)

    def apply(s: float):
        return se3.normalize(se3.exp((s * dx_c).T) @ Tcw), ptsT - s * dx_p

    # monotone step acceptance: the best of {full, quarter, hold} by the
    # gated Huber cost
    c0 = _robust_cost(cam, prob, Tcw, ptsT, pm_gate, pm_th)
    T1, p1 = apply(1.0)
    T2, p2 = apply(0.25)
    c1 = _robust_cost(cam, prob, T1, p1, pm_gate, pm_th)
    c2 = _robust_cost(cam, prob, T2, p2, pm_gate, pm_th)
    use1 = (c1 <= c2) & (c1 < c0)
    use2 = ~use1 & (c2 < c0)
    Tcw_new = torch.where(use1, T1, torch.where(use2, T2, Tcw))
    ptsT_new = torch.where(use1, p1, torch.where(use2, p2, ptsT))
    return Tcw_new, ptsT_new


def _thresholds(prob: GlobalBAProblem, chi2_mono: float, chi2_stereo: float):
    return (torch.where(prob.pm_right_u > 0, chi2_stereo, chi2_mono),
            torch.where(prob.cm_right_u > 0, chi2_stereo, chi2_mono))


def _gates(cam, prob: GlobalBAProblem, Tcw, ptsT, pm_th, cm_th):
    """Observations whose χ² at (Tcw, ptsT) is inside their threshold."""
    return (prob.pm_valid & (_pm_terms(cam, prob, Tcw, ptsT).chi2 < pm_th),
            prob.cm_valid & (_cm_terms(cam, prob, Tcw, ptsT).chi2 < cm_th))


def _solve_global(cam, prob: GlobalBAProblem, *, chi2_mono, chi2_stereo, phase_iters,
                  pcg_iters, lam):
    pm_th, cm_th = _thresholds(prob, chi2_mono, chi2_stereo)
    Tcw, ptsT = prob.cam_Tcw, prob.pt_pos.T
    pm_gate, cm_gate = prob.pm_valid, prob.cm_valid
    for n_iters in phase_iters:
        for _ in range(n_iters):
            Tcw, ptsT = _gn_step(cam, prob, Tcw, ptsT, pm_gate, cm_gate, lam, pcg_iters, pm_th, cm_th)
        pm_gate, cm_gate = _gates(cam, prob, Tcw, ptsT, pm_th, cm_th)
    return Tcw, ptsT.T, pm_gate


def global_ba_phase(
    cam: CameraParams,
    prob: GlobalBAProblem,
    Tcw: torch.Tensor,
    ptsT: torch.Tensor,
    *,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    n_iters: int = 1,
    pcg_iters: int = 40,
    lam: float = 0.1,
    robust_gate: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One resumable phase: ``n_iters`` damped-GN steps from (Tcw, ptsT) —
    the chunk of the background global BA.  ``robust_gate=False`` is the
    ungated first phase of ``solve_global_ba``; otherwise observations are
    gated by the χ² of the entry iterate."""
    pm_th, cm_th = _thresholds(prob, chi2_mono, chi2_stereo)
    if robust_gate:
        pm_gate, cm_gate = _gates(cam, prob, Tcw, ptsT, pm_th, cm_th)
    else:
        pm_gate, cm_gate = prob.pm_valid, prob.cm_valid
    for _ in range(n_iters):
        Tcw, ptsT = _gn_step(cam, prob, Tcw, ptsT, pm_gate, cm_gate, lam, pcg_iters, pm_th, cm_th)
    return Tcw, ptsT


def solve_global_ba(
    cam: CameraParams,
    prob,
    *,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    phase_iters: Tuple[int, ...] = (5, 5),
    pcg_iters: int = 40,
    lam: float = 0.1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-phase robust global BA (gate between phases; the reference runs
    10 g2o iterations, Optimizer.cc:934-1043).  Accepts a GlobalBAProblem or
    a PointBAProblem (converted first).  Returns (cam_Tcw, pt_pos, obs_inlier
    [O, M] point-major)."""
    if isinstance(prob, PointBAProblem):
        prob = point_to_global(prob)
    return _solve_global(cam, prob, chi2_mono=chi2_mono, chi2_stereo=chi2_stereo,
                         phase_iters=phase_iters, pcg_iters=pcg_iters, lam=lam)


def solve_global_ba_sharded(*args, **kwargs):
    raise NotImplementedError("the sharded global BA is not ported yet (ROADMAP port queue: multi-GPU)")


# --------------------------------------------------------------------------
# conversion
# --------------------------------------------------------------------------

def point_to_global(prob: PointBAProblem, n_feat: Optional[int] = None,
                    round_to: int = 8) -> GlobalBAProblem:
    """Build the camera-major view from a point-major problem: the valid
    edges in row-major (point, observation) order, stably sorted by camera,
    take consecutive slots per camera.  The feature capacity N is the
    largest per-camera edge count rounded up to ``round_to`` (at least 8;
    one read-back) unless ``n_feat`` is given; an edge past it leaves both
    views."""
    P, O = prob.obs_cam.shape
    C = prob.cam_Tcw.shape[0]
    dev = prob.obs_cam.device
    obs_valid = prob.obs_valid & (prob.obs_cam >= 0) & prob.pt_valid[:, None]
    flat_ok = obs_valid.reshape(-1)
    cam_key = torch.where(flat_ok, prob.obs_cam.reshape(-1), C)    # invalid edges sort last
    order = torch.sort(cam_key, stable=True).indices
    ce = cam_key[order]
    ok = ce < C
    counts = count_into(ce, C)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(P * O, device=dev) - starts[ce.clamp(max=C - 1).long()]
    if n_feat is None:
        N = max(8, int(counts.max()) if C else 0)
    else:
        N = n_feat
    N = ((N + round_to - 1) // round_to) * round_to
    keep = ok & (slot < N)
    lin = torch.where(keep, slot * C + ce, N * C)
    pe, oe = order // O, order % O

    def plane(fill, dtype, vals):
        return set_drop(torch.full((N * C,), fill, dtype=dtype, device=dev), lin, vals).reshape(N, C)

    uv = prob.obs_uv[pe, oe]                                       # [P·O, 2]
    cm_uv = torch.stack([plane(0.0, torch.float32, uv[:, 0]), plane(0.0, torch.float32, uv[:, 1])])
    pm_ok = set_drop(flat_ok, torch.where(ok & ~keep, order, P * O), False).reshape(P, O)
    return GlobalBAProblem(
        cam_Tcw=prob.cam_Tcw, cam_free=prob.cam_free,
        pt_pos=prob.pt_pos, pt_valid=prob.pt_valid,
        pm_cam=prob.obs_cam.clamp(0, C - 1).T.contiguous(),
        pm_uv=prob.obs_uv.permute(2, 1, 0).contiguous(),
        pm_right_u=prob.obs_right_u.T.contiguous(),
        pm_inv_sigma2=prob.obs_inv_sigma2.T.contiguous(),
        pm_valid=pm_ok.T.contiguous(),
        cm_pt=plane(0, torch.int32, pe.to(torch.int32)),
        cm_uv=cm_uv,
        cm_right_u=plane(-1.0, torch.float32, prob.obs_right_u[pe, oe]),
        cm_inv_sigma2=plane(1.0, torch.float32, prob.obs_inv_sigma2[pe, oe]),
        cm_valid=plane(False, torch.bool, True),
    )
