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
count that sizes the view.

``solve_global_ba_sharded`` and a ``global_ba_phase`` with a mesh ``axis``
shard the points on the point-major side and the cameras on the
camera-major side over a device mesh (``parallel/mesh.py``); per matvec the
shards exchange the marginalized point vector and the camera result by
``all_gather``, and the three line-search costs are joined by ``psum`` so
that every shard takes the same step (JAX ``shard_map`` in_specs).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

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


def _local_cam_block(x: torch.Tensor, K_local: int, block: Optional[int]) -> torch.Tensor:
    """Rows ``block``·K_local … of a replicated camera-axis array: the
    camera block of that shard (JAX ``axis_index``); the array itself when
    unsharded."""
    if block is None or x.shape[0] == K_local:
        return x
    return x[block * K_local:(block + 1) * K_local]


def _cm_terms(cam, prob: GlobalBAProblem, Tcw, ptsT, block: Optional[int] = None) -> edge_fm.EdgeTerms:
    """Camera-major edge terms ([*, N, K] planes): the camera pose broadcasts
    over the feature axis, the points are gathered from the whole map
    ``ptsT``.  ``Tcw`` may be the replicated array of every camera: it is
    cut to the camera block of slot ``block``."""
    Tcw = _local_cam_block(Tcw, prob.cm_pt.shape[1], block)
    C = Tcw.shape[0]
    return edge_fm.edge_terms(
        cam, Tcw[:, :3, :3].reshape(C, 9).T[:, None, :], Tcw[:, :3, 3].T[:, None, :],
        ptsT[:, prob.cm_pt.long()], prob.cm_uv, prob.cm_right_u, prob.cm_inv_sigma2,
    )


def _weights(chi2, gate, inv_sigma2, chi2_th):
    w = gate.to(torch.float32) * inv_sigma2 * huber_weight(chi2, chi2_th)
    return torch.where(chi2 < 1e4 * chi2_th, w, 0.0)


class _Unsharded:
    """The collectives of an unsharded solve: one shard, nothing to join."""

    local = [None]

    def broadcast(self, x):
        return [x]

    def psum(self, xs):
        return xs[0]

    def all_gather(self, xs, dim: int = -1):
        return xs[0]


_ONE = _Unsharded()


def _shards(axis, *args):
    """(collectives, per-shard lists of ``args``): ``axis`` None takes one
    unsharded problem and its arrays, a mesh takes the lists of its local
    shards (``_shard_global``)."""
    if axis is None:
        return _ONE, [[a] for a in args]
    return axis, list(args)


def _on(cam: CameraParams, dev) -> CameraParams:
    return CameraParams(*(t.to(dev) for t in cam))


def _robust_cost(cam, prob, Tcw, ptsT, pm_gate, pm_th, axis=None):
    """Gated Huber total cost over the point-major view (each edge once),
    capped at the 1e4·th weight cutoff; with a mesh (``prob``, ``ptsT``,
    ``pm_gate``, ``pm_th`` lists of the local shards, ``Tcw`` replicated)
    the shards' costs joined by ``psum``."""
    mesh, lists = _shards(axis, prob, ptsT, pm_gate, pm_th)
    return _cost(cam, mesh, Tcw, *lists)


def _cost(cam, mesh, Tcw, probs, pts, gates, ths):
    costs = []
    for p, T, q, g, th in zip(probs, mesh.broadcast(Tcw), pts, gates, ths):
        chi2 = _pm_terms(_on(cam, q.device), p, T, q).chi2
        rho = torch.where(chi2 <= th, chi2, 2.0 * torch.sqrt(th * torch.clamp(chi2, min=0.0)) - th)
        rho = torch.minimum(rho, 199.0 * th)
        costs.append(torch.sum(torch.where(g & p.pm_valid, rho, 0.0)))
    return mesh.psum(costs)


def _gn_step(cam, prob, Tcw, ptsT, pm_gate, cm_gate, lam: float, pcg_iters: int, pm_th, cm_th,
             axis=None):
    """One robust GN step with the PCG-Schur solve; returns (Tcw, ptsT).

    With a mesh ``axis``, ``prob``, ``ptsT``, the gates and thresholds are
    lists of the local shards (points sharded on the point-major side,
    cameras on the camera-major side) and ``Tcw`` is replicated on the
    mesh's first local device: the point and camera reductions run on each
    shard, the reduced camera system is assembled by ``all_gather`` and
    the PCG, its decisions and the step on the cameras run once (JAX's
    ``shard_map`` body, which repeats them on every shard)."""
    mesh, (probs, ptsTs, pm_gates, cm_gates, pm_ths, cm_ths) = _shards(
        axis, prob, ptsT, pm_gate, cm_gate, pm_th, cm_th)
    dev = Tcw.device
    cams = [_on(cam, q.device) for q in ptsTs]
    Tcws = mesh.broadcast(Tcw)

    # ---- point-major pass: Hpp, Wp, b_p, per-edge G ----------------------
    pm = []
    for c, p, T, q, g, th in zip(cams, probs, Tcws, ptsTs, pm_gates, pm_ths):
        pm_cam = p.pm_cam.long()
        tm = _pm_terms(c, p, T, q)
        w_pm = _weights(tm.chi2, g, p.pm_inv_sigma2, th)
        tm = tm._replace(Jc=torch.where(p.cam_free[pm_cam][None], tm.Jc, 0.0))
        Hpp6 = edge_fm.hpp_comps(tm, w_pm, reduce_axis=-2)          # [6, M]
        b_p3 = edge_fm.bp_comps(tm, w_pm, reduce_axis=-2)           # [3, M]
        comp = torch.arange(6, device=q.device)[:, None]
        lam_diag = ((comp == 0) | (comp == 3) | (comp == 5)).to(torch.float32) * (lam + 1e-9)
        Wp6 = torch.where(p.pt_valid[None, :], edge_fm.sym3_inv(Hpp6 + lam_diag), 0.0)
        pm.append((pm_cam, b_p3, Wp6, edge_fm.g_comps(tm, w_pm)))   # G_pm [18, O, M]

    # ---- camera-major pass: Hcc, b_c, b̃, per-edge G ---------------------
    ptsT_full = mesh.broadcast(mesh.all_gather(ptsTs))              # [3, M_all]
    cm, hcc = [], []
    for k, c, p, T, q, g, th in zip(mesh.local, cams, probs, Tcws, ptsT_full, cm_gates, cm_ths):
        tc = _cm_terms(c, p, T, q, k)
        w_cm = _weights(tc.chi2, g, p.cm_inv_sigma2, th)
        free = _local_cam_block(p.cam_free, p.cm_pt.shape[1], k)
        tc = tc._replace(Jc=torch.where(free[None, None, :], tc.Jc, 0.0))
        hcc.append(edge_fm.hcc_comps(tc, w_cm, reduce_axis=-2))    # [21, K_local]
        cm.append((p.cm_pt.long(), edge_fm.bc_comps(tc, w_cm, reduce_axis=-2), edge_fm.g_comps(tc, w_cm)))
    Hcc21 = mesh.all_gather(hcc)                                    # [21, K]

    # b̃ = b_c − Σ_n G · (Wp b_p)[point of edge]
    Wb_full = mesh.broadcast(mesh.all_gather([edge_fm.sym3_apply(Wp6, b_p3) for _, b_p3, Wp6, _ in pm]))
    b_schur = mesh.all_gather([b_c - torch.sum(edge_fm.g_apply(G_cm, Wb[:, cm_pt]), dim=-2)
                               for (cm_pt, b_c, G_cm), Wb in zip(cm, Wb_full)])    # [6, K]
    free = probs[0].cam_free.to(dev)                                # [K]
    anchor = torch.where(free, 0.0, 1.0)[None, :]                   # [1, K]

    def matvec(x):                                                 # [6, K] → [6, K]
        z = [edge_fm.sym3_apply(Wp6, torch.sum(edge_fm.gT_apply(G_pm, xk[:, pm_cam]), dim=-2))
             for (pm_cam, _, Wp6, G_pm), xk in zip(pm, mesh.broadcast(x))]        # [3, M]
        u = [torch.sum(edge_fm.g_apply(G_cm, zk[:, cm_pt]), dim=-2)
             for (cm_pt, _, G_cm), zk in zip(cm, mesh.broadcast(mesh.all_gather(z)))]
        return mesh.all_gather([-uk for uk in u]) + edge_fm.sym6_apply(Hcc21, x) + lam * x + anchor * x

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
    dx_c = torch.where(free[None, :], dx_c, 0.0)                    # [6, K]

    # landmark back-substitution (on each point shard)
    dx_p = []
    for (pm_cam, b_p3, Wp6, G_pm), dxk in zip(pm, mesh.broadcast(dx_c)):
        tp = torch.sum(edge_fm.gT_apply(G_pm, dxk[:, pm_cam]), dim=-2)
        d = edge_fm.sym3_apply(Wp6, b_p3 + tp)                      # [3, M]
        dx_p.append(torch.where(torch.isfinite(d), d, 0.0))

    def apply(s: float):
        return (se3.normalize(se3.exp((s * dx_c).T) @ Tcw),
                [q - s * d for q, d in zip(ptsTs, dx_p)])

    # monotone step acceptance: the best of {full, quarter, hold} by the
    # gated Huber cost, its decisions taken once from the psum-joined costs
    c0 = _cost(cam, mesh, Tcw, probs, ptsTs, pm_gates, pm_ths)
    T1, p1 = apply(1.0)
    T2, p2 = apply(0.25)
    c1 = _cost(cam, mesh, T1, probs, p1, pm_gates, pm_ths)
    c2 = _cost(cam, mesh, T2, probs, p2, pm_gates, pm_ths)
    use1 = (c1 <= c2) & (c1 < c0)
    use2 = ~use1 & (c2 < c0)
    Tcw_new = torch.where(use1, T1, torch.where(use2, T2, Tcw))
    pts_new = [torch.where(u1, a, torch.where(u2, b_, q))
               for a, b_, q, u1, u2 in zip(p1, p2, ptsTs, mesh.broadcast(use1), mesh.broadcast(use2))]
    return Tcw_new, (pts_new if axis is not None else pts_new[0])


def _thresholds(prob: GlobalBAProblem, chi2_mono: float, chi2_stereo: float):
    return (torch.where(prob.pm_right_u > 0, chi2_stereo, chi2_mono),
            torch.where(prob.cm_right_u > 0, chi2_stereo, chi2_mono))


def _gates(cam, prob, Tcw, ptsT, pm_th, cm_th, axis=None):
    """Observations whose χ² at (Tcw, ptsT) is inside their threshold; with
    a mesh, lists of the local shards' gates (the camera-major pass reads
    the all-gathered points)."""
    mesh, (probs, ptsTs, pm_ths, cm_ths) = _shards(axis, prob, ptsT, pm_th, cm_th)
    full = mesh.broadcast(mesh.all_gather(ptsTs))
    pm_g, cm_g = [], []
    for k, p, T, q, qf, pth, cth in zip(mesh.local, probs, mesh.broadcast(Tcw), ptsTs, full, pm_ths, cm_ths):
        c = _on(cam, q.device)
        pm_g.append(p.pm_valid & (_pm_terms(c, p, T, q).chi2 < pth))
        cm_g.append(p.cm_valid & (_cm_terms(c, p, T, qf, k).chi2 < cth))
    return (pm_g, cm_g) if axis is not None else (pm_g[0], cm_g[0])


def _shard_thresholds(prob, chi2_mono, chi2_stereo, axis):
    if axis is None:
        return _thresholds(prob, chi2_mono, chi2_stereo)
    ths = [_thresholds(p, chi2_mono, chi2_stereo) for p in prob]
    return [a for a, _ in ths], [b for _, b in ths]


def _solve_global(cam, prob, *, chi2_mono, chi2_stereo, phase_iters, pcg_iters, lam, axis=None):
    """The phases of GN steps with the gates renewed between them; returns
    (Tcw, ptsT, pm_gate), the last two per local shard with a mesh."""
    pm_th, cm_th = _shard_thresholds(prob, chi2_mono, chi2_stereo, axis)
    if axis is None:
        Tcw, ptsT = prob.cam_Tcw, prob.pt_pos.T
        pm_gate, cm_gate = prob.pm_valid, prob.cm_valid
    else:
        Tcw, ptsT = prob[0].cam_Tcw.to(axis.device), [p.pt_pos.T for p in prob]
        pm_gate, cm_gate = [p.pm_valid for p in prob], [p.cm_valid for p in prob]
    for n_iters in phase_iters:
        for _ in range(n_iters):
            Tcw, ptsT = _gn_step(cam, prob, Tcw, ptsT, pm_gate, cm_gate, lam, pcg_iters, pm_th, cm_th, axis)
        pm_gate, cm_gate = _gates(cam, prob, Tcw, ptsT, pm_th, cm_th, axis)
    return Tcw, ptsT, pm_gate


def global_ba_phase(
    cam: CameraParams,
    prob,
    Tcw: torch.Tensor,
    ptsT,
    *,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    n_iters: int = 1,
    pcg_iters: int = 40,
    lam: float = 0.1,
    robust_gate: Union[bool, torch.Tensor] = True,
    axis=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One resumable phase: ``n_iters`` damped-GN steps from (Tcw, ptsT) —
    the chunk of the background global BA.  ``robust_gate=False`` is the
    ungated first phase of ``solve_global_ba``; otherwise observations are
    gated by the χ² of the entry iterate.  A bool [1] tensor
    ``robust_gate`` selects between the two on the device, the gates
    always computed: one program, and one CUDA graph, for every chunk of a
    solve (JAX compiles one per value).  With a mesh
    ``axis``, ``prob`` and ``ptsT`` are the lists of its local shards
    (``_shard_global``) and so is the returned ``ptsT``; ``Tcw`` is
    replicated."""
    pm_th, cm_th = _shard_thresholds(prob, chi2_mono, chi2_stereo, axis)
    if torch.is_tensor(robust_gate):
        mesh, (probs, pm_gs, cm_gs) = _shards(axis, prob, *_gates(cam, prob, Tcw, ptsT, pm_th, cm_th, axis))
        picks = mesh.broadcast(robust_gate)
        pm_gate = [torch.where(g, a, p.pm_valid) for g, a, p in zip(picks, pm_gs, probs)]
        cm_gate = [torch.where(g, a, p.cm_valid) for g, a, p in zip(picks, cm_gs, probs)]
        if axis is None:
            pm_gate, cm_gate = pm_gate[0], cm_gate[0]
    elif robust_gate:
        pm_gate, cm_gate = _gates(cam, prob, Tcw, ptsT, pm_th, cm_th, axis)
    elif axis is None:
        pm_gate, cm_gate = prob.pm_valid, prob.cm_valid
    else:
        pm_gate, cm_gate = [p.pm_valid for p in prob], [p.cm_valid for p in prob]
    for _ in range(n_iters):
        Tcw, ptsT = _gn_step(cam, prob, Tcw, ptsT, pm_gate, cm_gate, lam, pcg_iters, pm_th, cm_th, axis)
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
    Tcw, ptsT, gate = _solve_global(cam, prob, chi2_mono=chi2_mono, chi2_stereo=chi2_stereo,
                                    phase_iters=phase_iters, pcg_iters=pcg_iters, lam=lam)
    return Tcw, ptsT.T, gate


def solve_global_ba_sharded(
    cam: CameraParams,
    prob,
    mesh,
    axis: str = "ba",
    *,
    chi2_mono: float = 5.991,
    chi2_stereo: float = 7.815,
    phase_iters: Tuple[int, ...] = (5, 5),
    pcg_iters: int = 40,
    lam: float = 0.1,
):
    """The global BA over a device mesh (``parallel.mesh.Mesh`` over
    ``axis``): the problem padded to multiples of the mesh size
    (``_pad_global``), its point-major arrays sharded over points and its
    camera-major arrays over cameras (``_shard_global``), the shards joined
    by the mesh's collectives.  Returns what ``solve_global_ba`` returns,
    gathered, on the mesh's first local device."""
    if isinstance(prob, PointBAProblem):
        prob = point_to_global(prob)
    if mesh.axis != axis:
        raise ValueError(f"the mesh's axis is {mesh.axis!r}, not {axis!r}")
    K0, M0 = prob.cam_Tcw.shape[0], prob.pt_pos.shape[0]
    shards = _shard_global(_pad_global(prob, mesh.size), mesh)
    Tcw, ptsT, gate = _solve_global(cam, shards, chi2_mono=chi2_mono, chi2_stereo=chi2_stereo,
                                    phase_iters=phase_iters, pcg_iters=pcg_iters, lam=lam, axis=mesh)
    return Tcw[:K0], mesh.all_gather(ptsT).T[:M0], mesh.all_gather(gate)[:, :M0]


def _pad_global(prob: GlobalBAProblem, n_dev: int) -> GlobalBAProblem:
    """Pad the camera axis (minor dim of cm_* / cam arrays) and the point
    axis (minor dim of pm_* / pt arrays) up to multiples of ``n_dev``;
    padded slots are fixed / invalid and contribute nothing."""
    K, M = prob.cam_Tcw.shape[0], prob.pt_pos.shape[0]
    return pad_global_to(prob, K + (-K) % n_dev, M + (-M) % n_dev)


def pad_global_to(prob: GlobalBAProblem, K: int, M: int, N: Optional[int] = None) -> GlobalBAProblem:
    """``prob`` padded to K cameras, M points and (when given) a camera-major
    feature capacity of N: padded cameras are fixed with an identity pose,
    padded points and edges invalid, so they contribute nothing.  Returns
    ``prob`` itself when nothing is padded."""
    Kp, Mp = K - prob.cam_Tcw.shape[0], M - prob.pt_pos.shape[0]
    Np = 0 if N is None else N - prob.cm_pt.shape[0]
    if min(Kp, Mp, Np) < 0:
        raise ValueError(f"cannot pad a problem of {tuple(prob.cm_pt.shape)} edges, "
                         f"{prob.pt_pos.shape[0]} points down to ({N}, {K}), {M} points")
    if Kp == 0 and Mp == 0 and Np == 0:
        return prob

    def pad(x, n, val=0, dim=-1):
        if n == 0:
            return x
        shape = list(x.shape)
        shape[dim] = n
        return torch.cat([x, torch.full(shape, val, dtype=x.dtype, device=x.device)], dim=dim)

    def cm(x, val=0):   # camera-major planes [.., N, K]: the feature axis, then the cameras
        return pad(pad(x, Np, val, dim=-2), Kp, val)

    eye = torch.eye(4, dtype=prob.cam_Tcw.dtype, device=prob.cam_Tcw.device).expand(Kp, 4, 4)
    return GlobalBAProblem(
        cam_Tcw=torch.cat([prob.cam_Tcw, eye]) if Kp else prob.cam_Tcw,
        cam_free=pad(prob.cam_free, Kp, False),
        pt_pos=pad(prob.pt_pos, Mp, 0.0, dim=0),
        pt_valid=pad(prob.pt_valid, Mp, False),
        pm_cam=pad(prob.pm_cam, Mp),
        pm_uv=pad(prob.pm_uv, Mp),
        pm_right_u=pad(prob.pm_right_u, Mp, -1.0),
        pm_inv_sigma2=pad(prob.pm_inv_sigma2, Mp, 1.0),
        pm_valid=pad(prob.pm_valid, Mp, False),
        cm_pt=cm(prob.cm_pt),
        cm_uv=cm(prob.cm_uv),
        cm_right_u=cm(prob.cm_right_u, -1.0),
        cm_inv_sigma2=cm(prob.cm_inv_sigma2, 1.0),
        cm_valid=cm(prob.cm_valid, False),
    )


def _shard_global(prob: GlobalBAProblem, mesh, views: bool = False) -> list:
    """This process's shards of a padded problem, each on its slot's device
    (JAX's in_specs): the camera arrays replicated, the point arrays and
    point-major planes cut along the points, the camera-major planes along
    the cameras.  Each cut is a contiguous copy, or with ``views`` (a mesh
    on ``prob``'s one device) a view of ``prob``: a captured chunk reads its
    static problem through them, so a snapshot copied into it reaches the
    graph."""
    own = (lambda a: a) if views else (lambda a: a.contiguous())
    out = []
    pts = mesh.split(prob.pt_pos, 0)
    pm = [mesh.split(a) for a in (prob.pt_valid, prob.pm_cam, prob.pm_uv, prob.pm_right_u,
                                  prob.pm_inv_sigma2, prob.pm_valid)]
    cm = [mesh.split(a) for a in (prob.cm_pt, prob.cm_uv, prob.cm_right_u, prob.cm_inv_sigma2,
                                  prob.cm_valid)]
    for i, dev in enumerate(mesh.local_devices):
        out.append(GlobalBAProblem(prob.cam_Tcw.to(dev), prob.cam_free.to(dev), own(pts[i]),
                                   *(own(a[i]) for a in pm), *(own(a[i]) for a in cm)))
    return out


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
