"""Bundle adjustment with Schur-complement reduction (port of
``orb_slam2_ros2_tpu/solvers/schur_ba.py``; reference
Optimizer::OptimizeLocalMap, src/Optimizer.cc:225-442).

Two layouts.  The per-camera grid (``BAProblem``, ``solve_ba``): edges are
the dense ``[C cameras × N feature slots]`` grid, slot (c, n) observing point
``pt_slot[c, n]``; the per-point sums run as one-hot matmuls per camera
(``[C, N, P]ᵀ × [C, N, 30]``), and the camera blocks are added to the
diagonal of the reduced system through a strided view, each block once.
The per-point layout (``solve_ba_points``, local BA's engine) follows.

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
from .linalg_small import inv3
from .pcg_ba import PointBAProblem


class BAProblem(NamedTuple):
    """Grid-layout BA problem.  C = camera slots, N = features a camera,
    P = point slots."""

    cam_Tcw: torch.Tensor     # f32[C, 4, 4]
    cam_free: torch.Tensor    # bool[C] optimized (False = fixed anchor)
    pt_pos: torch.Tensor      # f32[P, 3]
    pt_valid: torch.Tensor    # bool[P]
    pt_slot: torch.Tensor     # i32[C, N] point slot of each edge (−1 = none)
    uv: torch.Tensor          # f32[C, N, 2]
    right_u: torch.Tensor     # f32[C, N] (−1 = mono)
    inv_sigma2: torch.Tensor  # f32[C, N]
    edge_valid: torch.Tensor  # bool[C, N]


def _edge_terms(cam: CameraParams, prob: BAProblem, Tcw: torch.Tensor, pts: torch.Tensor):
    """Residuals r [C,N,3], Jacobians Jc [C,N,3,6] and Jp [C,N,3,3], and the
    residual-dimension mask [C,N,3] (the right-image row only for stereo)."""
    P = pts.shape[0]
    pw = pts[prob.pt_slot.clamp(0, P - 1).long()]            # [C, N, 3]
    R = se3.R_of(Tcw)
    pc = torch.einsum("cij,cnj->cni", R, pw) + se3.t_of(Tcw)[:, None, :]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z = torch.where(z > 1e-6, z, 1e-6)
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    u = cam.fx * x * inv_z + cam.cx
    v = cam.fy * y * inv_z + cam.cy
    ur = u - cam.bf * inv_z
    is_stereo = prob.right_u > 0
    r = torch.stack([u - prob.uv[..., 0], v - prob.uv[..., 1],
                     torch.where(is_stereo, ur - prob.right_u, 0.0)], dim=-1)
    zero = torch.zeros_like(z)
    du = torch.stack([cam.fx * inv_z, zero, -cam.fx * x * inv_z2], dim=-1)
    dv = torch.stack([zero, cam.fy * inv_z, -cam.fy * y * inv_z2], dim=-1)
    dur = du + torch.stack([zero, zero, cam.bf * inv_z2], dim=-1)
    dpix = torch.stack([du, dv, dur], dim=-2)                 # [C, N, 3, 3] ∂pix/∂pc
    I = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(*pc.shape[:-1], 3, 3)
    Jc = dpix @ torch.cat([I, -se3.hat(pc)], dim=-1)          # [C, N, 3, 6]
    Jp = torch.einsum("cnab,cbj->cnaj", dpix, R)              # ∂pc/∂pw = R
    one = torch.ones_like(is_stereo)
    dim = torch.stack([one, one, is_stereo], dim=-1).to(pc.dtype)
    return r, Jc, Jp, dim


def _solve_iteration(cam: CameraParams, prob: BAProblem, Tcw, pts, weights, lam):
    """One damped Gauss-Newton Schur step; ``weights [C, N]`` is validity ⊗
    Huber ⊗ information, ``lam`` a 0-d tensor.  Returns (Tcw_new, pts_new)."""
    C, N = prob.pt_slot.shape
    P = pts.shape[0]
    F6 = C * 6
    dev = Tcw.device

    r, Jc, Jp, dim = _edge_terms(cam, prob, Tcw, pts)
    wm = weights[..., None] * dim                             # [C, N, 3]
    # fixed cameras contribute no camera gradient (their pose stays anchored)
    Jc = torch.where(prob.cam_free[:, None, None, None], Jc, 0.0)

    Hcc = torch.einsum("cnki,cnk,cnkj->cij", Jc, wm, Jc)      # [C, 6, 6]
    b_c = torch.einsum("cnki,cnk,cnk->ci", Jc, wm, r)         # [C, 6]

    # per-point sums as one-hot matmuls, one per camera (a float index_add_
    # is unordered on CUDA); invalid edges go to slot P, which no column has
    slot = torch.where(prob.edge_valid, prob.pt_slot, P).long()
    G = torch.einsum("cnki,cnk,cnkj->cnij", Jc, wm, Jp)       # [C, N, 6, 3]
    Hpp_e = torch.einsum("cnki,cnk,cnkj->cnij", Jp, wm, Jp)   # [C, N, 3, 3]
    b_p_e = torch.einsum("cnki,cnk,cnk->cni", Jp, wm, r)      # [C, N, 3]
    payload = torch.cat([G.reshape(C, N, 18), Hpp_e.reshape(C, N, 9), b_p_e], dim=-1)  # [C, N, 30]
    onehot = (slot[..., None] == torch.arange(P, device=dev)).to(payload.dtype)        # [C, N, P]
    seg = onehot.transpose(1, 2) @ payload                    # [C, P, 30]
    B = seg[..., :18].reshape(C, P, 6, 3)
    Hpp = seg[..., 18:27].sum(dim=0).reshape(P, 3, 3)
    b_p = seg[..., 27:30].sum(dim=0)                          # [P, 3]

    # landmark marginalization
    eye3 = torch.eye(3, dtype=pts.dtype, device=dev)
    Wp = inv3(Hpp + lam * eye3 + 1e-9 * eye3)                 # [P, 3, 3]
    Wp = torch.where(prob.pt_valid[:, None, None], Wp, 0.0)
    BW = torch.einsum("cpij,pjk->cpik", B, Wp)                # [C, P, 6, 3]
    BWf = BW.permute(0, 2, 1, 3).reshape(F6, P * 3)
    Bf = B.permute(0, 2, 1, 3).reshape(F6, P * 3)
    S = -(BWf @ Bf.T)                                         # [6C, 6C]
    eye6 = torch.eye(6, dtype=S.dtype, device=dev)
    anchor = torch.where(prob.cam_free, 0.0, 1.0)[:, None, None] * eye6
    blocks = Hcc + lam * eye6 + anchor                        # [C, 6, 6]
    # block-diagonal add through a view of S's (c, c) blocks
    S.reshape(C, 6, C, 6).diagonal(dim1=0, dim2=2).add_(blocks.permute(1, 2, 0))
    b_schur = b_c.reshape(-1) - BWf @ b_p.reshape(-1)

    L, info = torch.linalg.cholesky_ex(S + 1e-8 * torch.eye(F6, dtype=S.dtype, device=dev))
    y = torch.linalg.solve_triangular(L, b_schur[:, None], upper=False)
    dx_c = -torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
    ok = (info == 0) & torch.all(torch.isfinite(dx_c))
    dx_c = torch.where(ok, dx_c, 0.0).reshape(C, 6)
    dx_c = torch.where(prob.cam_free[:, None], dx_c, 0.0)

    # landmark back-substitution: dx_p = −Wp (b_p + Σ_c Gᵀ dx_c)
    Gt_dx = torch.einsum("cpij,ci->pj", B, dx_c)
    dx_p = -torch.einsum("pij,pj->pi", Wp, b_p + Gt_dx)
    dx_p = torch.where(torch.isfinite(dx_p), dx_p, 0.0)
    dx_p = torch.where(prob.pt_valid[:, None], dx_p, 0.0)
    # fixed cameras keep their bits (the JAX version re-orthonormalizes them
    # too, which moves them by rounding)
    Tcw_new = torch.where(prob.cam_free[:, None, None], se3.normalize(se3.exp(dx_c) @ Tcw), Tcw)
    return Tcw_new, pts + dx_p


def _chi2(cam: CameraParams, prob: BAProblem, Tcw: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Information-weighted squared reprojection error [C, N]."""
    r, _, _, dim = _edge_terms(cam, prob, Tcw, pts)
    return torch.sum(r * r * dim, dim=-1) * prob.inv_sigma2


def _truncated_huber(chi2_th: torch.Tensor):
    """The LM's robust cost of χ² values: Huber, constant beyond 1e4·χ²_th
    (a degenerate edge cannot out-pull the good ones through the linear
    tail)."""
    rho_cap = 2.0 * torch.sqrt(chi2_th * (1e4 * chi2_th)) - chi2_th

    def rho(chi2: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
        h = torch.where(chi2 <= chi2_th, chi2,
                        2.0 * torch.sqrt(chi2_th * torch.clamp(chi2, min=1e-12)) - chi2_th)
        return torch.sum(torch.where(gate, torch.minimum(h, rho_cap), 0.0))

    return rho


def _lm(chi2_fn, step_fn, Tcw, pts, gate, chi2_th, inv_sigma2, lam: float, n_iters: int):
    """``n_iters`` LM iterations with step acceptance, all on the device: a
    step that raises the robust cost is rejected and λ raised instead."""
    rho = _truncated_huber(chi2_th)
    trunc = 1e4 * chi2_th
    lam_c = torch.full((), lam, dtype=torch.float32, device=Tcw.device)
    cost = rho(chi2_fn(Tcw, pts), gate)
    for _ in range(n_iters):
        chi2 = chi2_fn(Tcw, pts)
        w = gate.float() * inv_sigma2 * huber_weight(chi2, chi2_th)
        w = torch.where(chi2 < trunc, w, 0.0)
        Tcw_new, pts_new = step_fn(Tcw, pts, w, lam_c)
        cost_new = rho(chi2_fn(Tcw_new, pts_new), gate)
        accept = cost_new < cost
        Tcw = torch.where(accept, Tcw_new, Tcw)
        pts = torch.where(accept, pts_new, pts)
        cost = torch.where(accept, cost_new, cost)
        lam_c = torch.clamp(torch.where(accept, lam_c * 0.5, lam_c * 8.0), 1e-6, 1e3)
    return Tcw, pts


def solve_ba(
    cam: CameraParams,
    prob: BAProblem,
    *,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    phase_iters: Tuple[int, int] = (5, 10),
    lam: float = 1e-3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Two-phase robust BA over the grid layout (5 iterations → χ² gate → 10
    iterations, Optimizer.cc:321-349) with LM step acceptance and no host
    read.  Returns (cam_Tcw, pt_pos, edge_inlier [C, N])."""
    chi2_th = torch.where(prob.right_u > 0, chi2_stereo, chi2_mono)
    Tcw, pts = prob.cam_Tcw, prob.pt_pos
    gate = prob.edge_valid

    def chi2_fn(Tcw_, pts_):
        return _chi2(cam, prob, Tcw_, pts_)

    def step_fn(Tcw_, pts_, w, lam_c):
        return _solve_iteration(cam, prob, Tcw_, pts_, w, lam_c)

    for n_iters in phase_iters:
        Tcw, pts = _lm(chi2_fn, step_fn, Tcw, pts, gate, chi2_th, prob.inv_sigma2, lam, n_iters)
        gate = prob.edge_valid & (chi2_fn(Tcw, pts) < chi2_th)
    return Tcw, pts, gate


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

    def chi2_fn(Tcw_, pts_):
        return _fm_chi2(cam, fm, Tcw_, pts_)

    def step_fn(Tcw_, pts_, w, lam_c):
        return _solve_iteration_points(cam, prob, fm, Tcw_, pts_, w, lam_c)

    for n_iters in phase_iters:
        Tcw, pts = _lm(chi2_fn, step_fn, Tcw, pts, gate, chi2_th, fm.inv_sigma2, lam, n_iters)
        gate = fm.valid & (chi2_fn(Tcw, pts) < chi2_th)
    return Tcw, pts, gate.T
